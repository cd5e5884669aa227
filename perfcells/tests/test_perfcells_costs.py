"""``perfcells/costs.py``'s model FLOPs against ``FlopCounterMode`` over the
plain reference at a small size: the products a served rollout and a
training step run, forward and backward."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfcells import costs
from perfcells.reference import model as ref

CFG = {"embed_dim": 16, "hidden_dim": 16, "num_heads": 2, "num_mixtures": 3,
       "adjacency_radius": 4.0, "sigma_min": 1e-3, "rho_max": 0.99, "dropout": 0.1}
G, N, K, OBS, PRED = 3, 5, 2, 4, 6


def _inputs():
    g = torch.Generator().manual_seed(0)
    p = {k: v[0].requires_grad_() for k, v in ref.init_params(CFG, 1, g).items()}
    xy = torch.cumsum(torch.randn((G, N, OBS + PRED, 2), generator=g), 2)
    mask = torch.ones((G, N), dtype=torch.bool)
    gum, nrm = ref.stream(K * G, PRED, N, CFG["num_mixtures"], g, "cpu")
    return p, xy, mask, gum, nrm


def test_forward_products_match_the_reference():
    p, xy, mask, gum, nrm = _inputs()
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        h = ref.encode(p, CFG, xy[:, :, :OBS], mask, 0.0, 1.0)
        ref.rollout(p, CFG, h.repeat(K, 1, 1), xy[:, :, OBS - 1].repeat(K, 1, 1),
                    mask.repeat(K, 1), 0.0, 1.0, gum, nrm)
    assert fc.get_total_flops() == costs.forward_products(CFG, G * N, N, K, OBS, PRED)


def test_train_step_products_match_the_reference():
    p, xy, mask, gum, nrm = _inputs()
    drop = {"emb": torch.ones((G, N, 16)), "gat": torch.ones((G, N, 16))}
    with FlopCounterMode(display=False) as fc:
        loss = ref.variety_loss(p, CFG, xy, mask, 0.0, 1.0, drop, gum, nrm, K, OBS)
        loss.backward()
    assert fc.get_total_flops() == costs.train_step_products(CFG, G, N, K, OBS, PRED)


def test_least_time_takes_the_largest_term():
    assert costs.least_time_s(0, 3.35e12, 0) == pytest.approx(1.0)
    assert costs.least_time_s(495e12, 0, 495e12) == pytest.approx(1.0)
    assert costs.least_time_s(67e12 + 1, 0, 1) == pytest.approx(1.0)
