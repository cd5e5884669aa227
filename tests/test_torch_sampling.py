"""Endpoint-diverse K-subset selection of the port against the JAX package:
``diverse_select`` (per agent) and ``diverse_select_joint`` (per window)
must pick exactly the same candidates, ties included (the first maximal
index wins on both sides)."""

import numpy as np
import pytest
import torch

from mmtraj.models.sampling import diverse_select as j_diverse_select
from mmtraj.models.sampling import diverse_select_joint as j_diverse_select_joint
from mmtraj_torch.models.sampling import diverse_select, diverse_select_joint


def _candidates(seed, r=12, b=3, n=5, tp=4):
    rng = np.random.default_rng(seed)
    preds = np.cumsum(rng.normal(size=(r, b, n, tp, 2)), axis=3).astype(np.float32)
    mask = rng.random((b, n)) < 0.7
    mask[:, 0] = True
    return preds, mask


def _padded(seed):
    """Masked agents are zeros in every candidate, as padding is: their
    endpoints are identical, so every pick among them is a tie."""
    preds, mask = _candidates(seed)
    preds[:, ~mask] = 0.0
    return preds, mask


@pytest.mark.parametrize("seed, r, k", [(0, 12, 4), (1, 40, 20), (2, 6, 5), (3, 9, 2)])
def test_diverse_select_matches_jax(seed, r, k):
    preds, _ = _candidates(seed, r=r)
    got = diverse_select(torch.from_numpy(preds), k).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_diverse_select(preds, k)))
    assert got.shape == (k,) + preds.shape[1:]
    np.testing.assert_array_equal(got[0], preds[0])  # selection starts at candidate 0


@pytest.mark.parametrize("seed, r, k", [(0, 12, 4), (1, 40, 20), (2, 6, 5)])
def test_diverse_select_joint_matches_jax(seed, r, k):
    preds, mask = _candidates(seed, r=r)
    got = diverse_select_joint(torch.from_numpy(preds), torch.from_numpy(mask), k).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_diverse_select_joint(preds, mask, k)))
    # Joint: every agent of a window takes the same candidate.
    picks = [[int(np.flatnonzero((preds[:, b] == got[i, b]).all(axis=(1, 2, 3)))[0])
              for b in range(preds.shape[1])] for i in range(k)]
    assert all(len(set(p)) == len(p) for p in zip(*picks))


@pytest.mark.parametrize("joint", [False, True], ids=["per_agent", "joint"])
def test_ties_of_padded_agents_pick_as_jax(joint):
    preds, mask = _padded(4)
    t_preds, t_mask = torch.from_numpy(preds), torch.from_numpy(mask)
    if joint:
        got = diverse_select_joint(t_preds, t_mask, 5).numpy()
        want = np.asarray(j_diverse_select_joint(preds, mask, 5))
    else:
        got = diverse_select(t_preds, 5).numpy()
        want = np.asarray(j_diverse_select(preds, 5))
    np.testing.assert_array_equal(got, want)
    all_masked = preds.copy()
    all_masked[:] = 0.0  # every candidate ties everywhere: JAX picks candidate 0 each round
    got = diverse_select(torch.from_numpy(all_masked), 3).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_diverse_select(all_masked, 3)))


def test_k_equal_r_returns_the_input_and_k_over_r_raises():
    preds, mask = _candidates(5, r=4)
    t_preds, t_mask = torch.from_numpy(preds), torch.from_numpy(mask)
    assert diverse_select(t_preds, 4) is t_preds
    assert diverse_select_joint(t_preds, t_mask, 4) is t_preds
    with pytest.raises(ValueError, match="cannot select 5 from 4"):
        diverse_select(t_preds, 5)
    with pytest.raises(ValueError, match="cannot select 5 from 4"):
        diverse_select_joint(t_preds, t_mask, 5)
    with pytest.raises(ValueError, match="cannot select 5 from 4"):
        j_diverse_select(preds, 5)
