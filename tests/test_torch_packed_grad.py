"""The port's packed attend against the JAX package's, on the CPU: the
gradient and the vmapped result.

JAX's ``attend_pallas(..., packed=True)`` (run in interpret mode, as
``tests/test_pallas.py`` runs it) takes the same ``custom_vjp`` as the
unpacked call, the VJP of ``attend_math``; the port's ``attend(...,
packed=True)`` takes ``_AttendPacked``, whose backward is the VJP of its
``attend_math``.  Gradients of v, s_src and s_dst agree within 1e-5 (the
leaf tolerance).  Under vmap over 3 lanes the port's registered rule folds
the lanes into one call of ``mmtraj::attend_packed`` (one launch on the
card, as Pallas's batching rule folds them into its grid), and its result
agrees with ``jax.vmap``'s within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtraj.ops.fused_attend import attend_pallas
from mmtraj_torch.ops import fused_attend

torch.set_num_threads(2)
GRAD_TOL = 1e-5
VMAP_TOL = 1e-6


def _inputs(b, n, heads, seed, lanes=()):
    """v (b, n, 64), s_src and s_dst (b, n, heads), the 0/1 tile with its
    diagonal set (and an all-masked row in graph 0); a leading ``lanes``
    shape on the first three."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=lanes + (b, n, 64)).astype(np.float32)
    ss = rng.normal(size=lanes + (b, n, heads)).astype(np.float32)
    sd = rng.normal(size=lanes + (b, n, heads)).astype(np.float32)
    att = np.maximum((rng.random((b, n, n)) < 0.4), np.eye(n)[None]).astype(np.float32)
    att[0, n // 2] = 0.0
    return v, ss, sd, att


@pytest.mark.parametrize("heads", [4, 1])
@pytest.mark.parametrize("n", [8, 64])
@pytest.mark.parametrize("b", [4, 5])
def test_packed_attend_gradients_match_jax(b, n, heads):
    v, ss, sd, att = _inputs(b, n, heads, seed=b * n + heads)
    up = np.random.default_rng(7).normal(size=v.shape).astype(np.float32)

    def j_loss(vv, s1, s2):
        return (attend_pallas(vv, s1, s2, jnp.asarray(att), heads, 2, True) * up).sum()

    j_grads = jax.grad(j_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (v, ss, sd)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (v, ss, sd)]
    out = fused_attend.attend(*leaves, torch.from_numpy(att), heads, 2, True)
    t_grads = torch.autograd.grad(out, leaves, torch.from_numpy(up))
    for name, jg, tg in zip(("v", "s_src", "s_dst"), j_grads, t_grads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=GRAD_TOL,
                                   err_msg=name)


def test_packed_attend_vmap_matches_jax_through_the_registered_rule(monkeypatch):
    lanes, b, n, heads = 3, 5, 16, 4
    v, ss, sd, att = _inputs(b, n, heads, seed=11, lanes=(lanes,))
    ref = jax.vmap(lambda vv, s1, s2: attend_pallas(vv, s1, s2, jnp.asarray(att), heads, 2,
                                                    True))(*map(jnp.asarray, (v, ss, sd)))
    assert torch._C._dispatch_has_kernel_for_dispatch_key("mmtraj::attend_packed",
                                                          "FuncTorchBatched")
    calls = []
    math = fused_attend.attend_math

    def spy(v_, *rest):
        calls.append(tuple(v_.shape))
        return math(v_, *rest)

    monkeypatch.setattr(fused_attend, "attend_math", spy)
    got = torch.func.vmap(lambda vv, s1, s2: fused_attend.attend(
        vv, s1, s2, torch.from_numpy(att), heads, 2, True))(*map(torch.from_numpy, (v, ss, sd)))
    # One call with the lanes folded into the graphs: torch's batching
    # fallback would call the op once a lane, at (b, n, 64).
    assert calls == [(lanes * b, n, 64)]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=VMAP_TOL)


def test_packed_attend_gradient_under_vmap_folds_its_lanes(monkeypatch):
    """The Function's generated vmap rule reaches the op's: a population's
    per-lane gradient calls the op once for all lanes, and equals each
    lane's own gradient."""
    lanes, b, n, heads = 3, 4, 8, 4
    v, ss, sd, att = map(torch.from_numpy, _inputs(b, n, heads, seed=5, lanes=(lanes,)))
    calls = []
    math = fused_attend.attend_math

    def spy(v_, *rest):
        calls.append(tuple(v_.shape))
        return math(v_, *rest)

    def loss(vv, s1, s2):
        return (fused_attend.attend(vv, s1, s2, att, heads, 2, True) ** 2).sum()

    monkeypatch.setattr(fused_attend, "attend_math", spy)
    got = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2)))(v, ss, sd)
    assert calls[0] == (lanes * b, n, 64)  # the forward: one folded call
    monkeypatch.setattr(fused_attend, "attend_math", math)
    for i in range(lanes):
        want = torch.func.grad(loss, argnums=(0, 1, 2))(v[i], ss[i], sd[i])
        for g, w in zip(got, want):
            torch.testing.assert_close(g[i], w, rtol=0, atol=GRAD_TOL)


def test_packed_attend_refuses_an_odd_group_with_a_gradient_as_jax_does():
    v, ss, sd, att = _inputs(4, 8, 4, seed=1)
    with pytest.raises(ValueError, match="even group"):
        attend_pallas(*map(jnp.asarray, (v, ss, sd, att)), 4, 3, True)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (v, ss, sd)]
    with pytest.raises(ValueError, match="even group"):
        fused_attend.attend(*leaves, torch.from_numpy(att), 4, 3, True)
