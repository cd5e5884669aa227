"""The attention encoder of the port (``encoder="attn"``) against the plain
reference of the benchmark (``perfcells/reference/attn.py``), on the CPU at a
small size: B 2, N 5, H 16, 2 heads, 2 layers, 8 observed and 4 predicted
steps, seeded random weights.  Also the encoder's spans and counter, the
operations ``perfcells/costs_attn.py`` prices, and the ``c4attn3-train``
cell run through the harness at a tiny size, with the faults its check has
to catch.

The port and the reference compute the same float32 mathematics in another
order (the port's GAT scores are a product with a block-diagonal matrix, its
attention two einsums, its layers checkpointed), so they agree to float32
rounding: each tolerance below says how far that reaches.
"""

import os
import sys
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from mmtraj_torch import train  # noqa: E402
from mmtraj_torch.config import Config, DataConfig, ModelConfig, TrainConfig  # noqa: E402
from mmtraj_torch.data.transforms import NormStats, normalize, to_relative  # noqa: E402
from mmtraj_torch.models import attn_encoder  # noqa: E402
from mmtraj_torch.models.forecaster import Forecaster  # noqa: E402
from mmtraj_torch.ops import launch_counters  # noqa: E402
from mmtraj_torch.utils import profiling  # noqa: E402
from perfcells import costs_attn, harness  # noqa: E402
from perfcells.reference import attn as ra  # noqa: E402
from perfcells.run import run_cell  # noqa: E402

torch.set_num_threads(2)

B, N, H, HEADS, L, OBS, PRED = 2, 5, 16, 2, 2, 8, 4
MCFG = {"cell": "gru", "encoder": "attn", "attn_layers": L, "social": True, "num_heads": HEADS,
        "gat_layers": 1, "embed_dim": H, "hidden_dim": H, "head": "gmm", "num_mixtures": 3,
        "adjacency_radius": 4.0, "sigma_min": 1e-3, "rho_max": 0.99, "dtype": "float32",
        "use_pallas": False, "attend_kernel": "auto", "use_fused_decoder": False,
        "dropout": 0.0, "remat": True, "remat_policy": "full", "scan_unroll": 1}
TRAIN = {"batch_size": B, "loss": "nll", "lr": 1e-3, "lr_schedule": "constant",
         "weight_decay": 0.0, "grad_clip": 1.0, "steps": 100, "warmup_steps": 0}
MEAN = np.array([0.01, 0.02], np.float32)
STD = np.array([0.35, 0.3], np.float32)
ROUTES = {"plain": {}, "use_pallas": {"use_pallas": True}}


def _windows(n_windows=B, seed=3):
    g = torch.Generator().manual_seed(seed)
    xy = torch.cumsum(torch.randn((n_windows, N, OBS + PRED, 2), generator=g) * 0.4, 2)
    xy = xy + torch.randn((n_windows, 1, 1, 2), generator=g) * 2.0
    mask = torch.ones((n_windows, N), dtype=torch.bool)
    mask[1::2, 3:] = False  # every other window has two padded agents
    return xy * mask[..., None, None], mask


def _model(init, **over):
    return Forecaster(ModelConfig(**{**MCFG, **over}), OBS, PRED, device="cpu", state=init)


def _init(seed=0, **over):
    return ra.init_params({**MCFG, **over}, torch.Generator().manual_seed(seed))


def test_readout_matches_the_reference():
    """The encoder's readout, LN_out of the last step zeroed on padding:
    values of order 1 after the layer norm, so within 1e-5 absolute."""
    init = _init()
    xy, mask = _windows()
    xy_obs = xy[:, :, :OBS]
    d = normalize(to_relative(xy_obs), NormStats(MEAN, STD))
    model = _model(init)
    with torch.no_grad():
        got = attn_encoder.attn_encode(model.params()["enc"], model.cfg, xy_obs, d, mask)
        want = ra.encode_features(init, MCFG, xy_obs, d, mask)
        blind = ra.encode_features(init, MCFG, xy_obs, d, mask, causal=False)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert (got - blind).abs().max() > 1e-2  # a reference that sees the future is refused


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_nll_and_every_gradient_match_the_reference(route):
    """The teacher-forced NLL within 2e-6 relative (a sum over 24 agent-steps
    of terms of order 1); every leaf's gradient within 1e-4 relative plus
    1e-5 of the largest gradient entry of any leaf (GAT score vectors whose
    rows fall on one side of the LeakyReLU's kink have gradients near 0, of
    which float32 keeps no relative digits)."""
    init = _init(1)
    xy, mask = _windows()
    model = _model(init, **ROUTES[route])
    loss = model.loss(xy, mask, NormStats(MEAN, STD))
    loss.backward()
    p = {k: v.clone().requires_grad_() for k, v in init.items()}
    want = ra.nll_loss(p, MCFG, xy, mask, torch.from_numpy(MEAN), torch.from_numpy(STD), OBS)
    want.backward()
    np.testing.assert_allclose(loss.item(), want.item(), rtol=2e-6)
    scale = max(float(v.grad.abs().max()) for v in p.values())
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(p)
    for k in p:
        torch.testing.assert_close(got[k].grad, p[k].grad, rtol=1e-4, atol=1e-5 * scale,
                                   msg=k)
    blind = ra.nll_loss(init, MCFG, xy, mask, torch.from_numpy(MEAN), torch.from_numpy(STD),
                        OBS, causal=False)
    assert abs(float(blind) - float(want)) > 1e-3 * abs(float(want))


def test_three_steps_of_the_multi_step_match_the_reference():
    """Three sequential steps of ``make_multi_train_step`` (one chunk; the
    CPU runs it eagerly) against the reference's three from the same weights
    and batches: the losses within 1e-5 relative, and each leaf's change of
    the parameters within 1e-4 of its norm element by element (``leaf_gap``)
    over the elements the first gradient moves (Adam moves every element by
    the learning rate in its gradient's sign, so an element whose gradient is
    rounding noise moves by rounding noise).  The reference without its
    causal mask fails both."""
    from perfcells.drivers.sequential_train import leaf_gap, moved_elements

    init = _init(2)
    xy_all, mask_all = _windows(8, seed=4)
    cfg = Config(model=ModelConfig(**MCFG), data=DataConfig(obs_len=OBS, pred_len=PRED, n_max=N),
                 train=TrainConfig(**TRAIN))
    model = _model(init)
    multi = train.make_multi_train_step(model, train.make_optimizer(cfg, model),
                                        NormStats(MEAN, STD), loss_mode="nll")
    idx = np.array([[0, 3], [5, 2], [6, 1]])
    losses = multi(xy_all, mask_all, idx, [0, 1, 2]).numpy()
    change = {k: v.detach() - init[k] for k, v in model.named_parameters()}

    def reference(causal):
        return ra.follow(init, MCFG, TRAIN, {"obs_len": OBS}, MEAN, STD, xy_all, mask_all, idx,
                         causal=causal)

    def gaps(r):
        keep = moved_elements(r["grad"][0])
        ref_change = {k: (v - init[k]) * keep[k] for k, v in r["state"][-1]["params"].items()}
        return (np.abs(losses - r["loss"]) / np.abs(r["loss"]),
                leaf_gap({k: v * keep[k] for k, v in change.items()}, ref_change)[0])

    loss_gap, change_gap = gaps(reference(True))
    assert loss_gap.max() <= 1e-5 and change_gap <= 1e-4, (loss_gap, change_gap)
    loss_gap, change_gap = gaps(reference(False))
    assert loss_gap.max() > 1e-3 and change_gap > 1e-2


def test_reference_draws_the_weights_cli_train_starts_from():
    """``init_params`` on a CPU generator gives, to the bit, the weights the
    program's trainer draws from the same seed (``params.init_params``), at
    the test's size and at ``config4-attn3``'s."""
    from mmtraj_torch.params import init_params

    for mcfg in (MCFG, harness.load_cell("c4attn3-train")["config"]["model"]):
        want = init_params(ModelConfig(**mcfg), torch.Generator().manual_seed(2**31 + 7))
        got = ra.init_params(mcfg, torch.Generator().manual_seed(2**31 + 7))
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k


# -- spans, counter, costs ------------------------------------------------------------

def _train_step(init, **over):
    model = _model(init, **over)
    xy, mask = _windows()
    loss = model.loss(xy, mask, NormStats(MEAN, STD))
    loss.backward()


def test_spans_of_a_training_step_with_the_profiler_on_and_none_off():
    """On: ``attn.encode`` once, ``attn.layer`` for layers 0..L-1 in the
    forward (children of ``attn.encode``) and again in remat's
    recomputation (children of ``attn.encode_grad``), ``attn.encode_grad``
    once.  Off: none."""
    init = _init()
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        _train_step(init)
    spans = profiling.spans()
    profiling.clear_spans()
    names = [s.name for s in spans if s.name.startswith("attn.")]
    assert names.count("attn.encode") == names.count("attn.encode_grad") == 1
    layers = [(s.ids["layer"], spans[s.parent].name) for s in spans if s.name == "attn.layer"]
    assert sorted(layers) == sorted([(i, "attn.encode") for i in range(L)]
                                    + [(i, "attn.encode_grad") for i in range(L)])
    enc = next(s for s in spans if s.name == "attn.encode")
    grad = next(s for s in spans if s.name == "attn.encode_grad")
    assert enc.end_ns <= grad.start_ns and all(s.end_ns is not None for s in spans)
    _train_step(init)
    assert not [s for s in profiling.spans() if s.name.startswith("attn.")]


@pytest.mark.parametrize("remat, per_step", [(True, 2 * L), (False, L)])
def test_attn_layer_counts_block_applications(remat, per_step):
    """``attn_encoder.attn_layer.launches``: L blocks a forward, and a
    remat-full step recomputes each once more.  No kernel: the kernels'
    registry (``ops.launch_counters()``) leaves it out."""
    counter = attn_encoder.attn_layer
    assert "attn_layer" not in launch_counters()
    init = _init()
    before = counter.launches
    with torch.no_grad():
        _model(init).encode(_windows()[0][:, :, :OBS], _windows()[1], NormStats(MEAN, STD))
    assert counter.launches - before == L
    before = counter.launches
    _train_step(init, remat=remat)
    assert counter.launches - before == per_step


def test_costs_count_the_reference_products():
    """``costs_attn``'s product FLOPs equal ``FlopCounterMode``'s count of the
    reference: the encoder's forward, and a whole NLL step's forward and
    backward."""
    init = {k: v.requires_grad_() for k, v in _init().items()}
    xy, mask = _windows()
    d = ra.ref.offsets(xy)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        ra.encode_features(init, MCFG, xy[:, :, :OBS], d[:, :, :OBS], mask)
    assert fc.get_total_flops() == costs_attn.encoder_forward_products(MCFG, B, N, OBS)
    with FlopCounterMode(display=False) as fc:
        ra.nll_loss(init, MCFG, xy, mask, 0.0, 1.0, OBS).backward()
    assert fc.get_total_flops() == costs_attn.train_step_products(MCFG, B, N, OBS, PRED)
    least = costs_attn.encoder_least_time_s(MCFG, B, N, OBS, 2 * L, backward=True)
    assert 0 < least < costs_attn.encoder_least_time_s(MCFG, B, N, OBS, 3 * L, backward=True)


# -- the cell at a tiny size ------------------------------------------------------------

TINY = {"config.model.hidden_dim": H, "config.model.embed_dim": H, "config.model.num_heads": HEADS,
        "config.model.attn_layers": L, "config.model.num_mixtures": 3, "config.data.n_max": 8,
        "config.data.pred_len": PRED, "config.train.batch_size": 4,
        "config.train.steps_per_dispatch": 2, "hooks.max_windows": 40}


def _cell(trace=False, **over):
    spec = harness.load_cell("c4attn3-train", {**TINY, **over})
    return run_cell(spec, 2**31 + 12345, 0.3, trace, "cpu", time.perf_counter())


def test_cell_passes_its_check_on_the_cpu():
    result, checks = _cell()
    assert result["correct"] is True, checks.line()
    assert set(result["metrics"]) == {"setup_s", "train_windows_per_s"}
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("key, value", [("hooks.fault", "half_batch"), ("hooks.fault", "frozen"),
                                        ("hooks.fault", "no_causal"),
                                        ("hooks.fault", "reversed_leaf"),
                                        ("hooks.control", "tf32")])
def test_cell_check_catches_faults_and_the_control(key, value):
    result, checks = _cell(**{key: value})
    assert result["correct"] is False, checks.line()


def test_traced_cell_reads_its_host_side_metrics():
    """A CPU trace has no device events: the device readers give nothing,
    ``mfu_pct.train_attn`` (the host's clock) a number."""
    result, _ = _cell(trace=True)
    assert "mfu_pct.train_attn" in result["metrics"]
    assert "attn.encoder_ms" not in result["metrics"]
    assert set(result["metrics"]) <= set(harness.load_cell("c4attn3-train")["cell"]["per_layer"])
