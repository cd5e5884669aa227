"""The port's torch- and Keras-convention converters and ``cli convert``,
against the JAX package's ``mmtraj/interop.py`` and ``mmtraj/cli.py``, on the
CPU.

Every import equals ``from_jax`` of the JAX function's result to the bit, and
every export equals the JAX function's; export then import is the identity.
A real ``torch.nn`` cell's weights drive the port's cell to its outputs
within 1e-6.  Keras itself is not imported: ``tests/test_import_shim.py``
holds the JAX package's conventions to real Keras cells, and these tests
hold the port to the JAX package.
"""

import dataclasses
import re

import h5py
import jax
import numpy as np
import pytest
import torch

from mmtraj import interop as j_interop
from mmtraj.config import ModelConfig as JModelConfig
from mmtraj.data.transforms import NormStats as JNormStats
from mmtraj.models.forecaster import Forecaster as JForecaster
from mmtraj_torch import checkpoint as ck
from mmtraj_torch import cli, interop
from mmtraj_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from mmtraj_torch.data.transforms import NormStats
from mmtraj_torch.models.cells import Carry, cell_apply
from mmtraj_torch.models.forecaster import Forecaster
from mmtraj_torch.params import from_jax
from torch_jax_streams import SMALL, write_scenes

torch.set_num_threads(2)

CONFIGS = {
    "gru_social": dict(cell="gru", social=True, head="gmm"),
    "lstm": dict(cell="lstm", social=False, head="deterministic"),
}
MEAN, STD = np.array([0.02, -0.01], np.float32), np.array([0.3, 0.35], np.float32)


def _setup(name, seed=0):
    jcfg = JModelConfig(**SMALL, **CONFIGS[name])
    params = jax.tree.map(np.asarray, JForecaster(jcfg, 4, 3).init(jax.random.PRNGKey(seed)))
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg)), params


def _jax_state(tree):
    return from_jax(jax.tree.map(np.asarray, tree))


def _assert_states_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k


def _assert_arrays_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


# -- torch convention -------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("as_tensors", [False, True], ids=["numpy", "tensors"])
def test_import_state_dict_equals_jax(name, as_tensors):
    jcfg, cfg, params = _setup(name)
    sd = j_interop.export_state_dict(params, jcfg)
    want = _jax_state(j_interop.import_state_dict(sd, jcfg))
    if as_tensors:
        sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    got = interop.import_state_dict(sd, cfg)
    _assert_states_equal(got, want)
    assert "enc.cell.bh" in got and "dec.cell.bh" in got


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_export_state_dict_equals_jax_and_round_trips(name):
    jcfg, cfg, params = _setup(name)
    state = from_jax(params)
    sd = interop.export_state_dict(state, cfg)
    _assert_arrays_equal(sd, j_interop.export_state_dict(params, jcfg))
    imported = interop.import_state_dict(sd, cfg)
    _assert_states_equal(interop.import_state_dict(interop.export_state_dict(imported, cfg), cfg),
                         imported)
    # the import only adds the recurrent biases, zero for native parameters
    assert set(imported) - set(state) == {"enc.cell.bh", "dec.cell.bh"}
    _assert_states_equal({k: imported[k] for k in state}, state)
    assert not imported["enc.cell.bh"].any()


@pytest.mark.parametrize("wrapped", [False, True], ids=["bare", "state_dict_entry"])
def test_import_reference_checkpoint_equals_jax(wrapped, tmp_path):
    jcfg, cfg, params = _setup("gru_social", 3)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in j_interop.export_state_dict(params, jcfg).items()}
    path = str(tmp_path / "reference_model.pt")
    torch.save({"state_dict": sd, "epoch": 99} if wrapped else sd, path)
    _assert_states_equal(interop.import_reference_checkpoint(path, cfg),
                         _jax_state(j_interop.import_reference_checkpoint(path, jcfg)))


@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_imported_cell_matches_a_torch_cell(kind):
    """A real ``torch.nn`` cell's weights through the import drive the port's
    cell to the torch cell's outputs: gate order, bias placement and the
    LSTM's forget shift."""
    torch.manual_seed(0)
    E, H, B = 6, 10, 4
    tcell = (torch.nn.GRUCell if kind == "gru" else torch.nn.LSTMCell)(E, H)
    sd = {f"encoder.rnn.{k}_l0": v.detach() for k, v in tcell.named_parameters()}
    p = {k: torch.from_numpy(v) for k, v in interop._cell_from_torch(sd, "encoder.rnn",
                                                                       kind).items()}
    rng = np.random.default_rng(1)
    x, h0, c0 = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                 for s in ((B, E), (B, H), (B, H)))
    got = cell_apply(p, kind, x, Carry(h0, c0))
    with torch.no_grad():
        if kind == "gru":
            torch.testing.assert_close(got.h, tcell(x, h0), atol=1e-6, rtol=0)
        else:
            h1, c1 = tcell(x, (h0, c0))
            torch.testing.assert_close(got.h, h1, atol=1e-6, rtol=0)
            torch.testing.assert_close(got.c, c1, atol=1e-6, rtol=0)


def test_missing_key_is_named():
    jcfg, cfg, params = _setup("gru_social")
    sd = j_interop.export_state_dict(params, jcfg)
    del sd["decoder.gat.attn_src"]
    with pytest.raises(KeyError, match="decoder.gat.attn_src"):
        interop.import_state_dict(sd, cfg)
    with pytest.raises(KeyError, match="encoder_embedding"):
        interop.import_keras_weights({}, cfg)


def test_the_attention_encoder_has_no_reference_layout(tmp_path):
    cfg = ModelConfig(**SMALL, encoder="attn")
    state = {}
    for fn, args in ((interop.import_state_dict, ({},)), (interop.export_state_dict, (state,)),
                     (interop.import_keras_weights, ({},)),
                     (interop.export_keras_weights, (state,)),
                     (interop.save_keras_h5, (str(tmp_path / "k.h5"), state))):
        with pytest.raises(ValueError, match="RNN encoder family"):
            fn(*args, cfg)


def test_imported_parameters_run_on_the_plain_decoder():
    """Imported ``bh`` parameters: the port's rollout follows JAX's on JAX's
    stream within 1e-4 m (float32); the fused decoder refuses them, as the
    JAX package's does."""
    jcfg, cfg, params = _setup("gru_social", 5)
    sd = j_interop.export_state_dict(params, jcfg)
    rng = np.random.default_rng(2)
    sd = {k: v + (rng.normal(size=v.shape).astype(np.float32) * 0.05 if "bias_hh" in k else 0)
          for k, v in sd.items()}
    jparams = j_interop.import_state_dict(sd, jcfg)
    state = interop.import_state_dict(sd, cfg)
    assert state["dec.cell.bh"].abs().max() > 0
    xy = np.cumsum(rng.normal(size=(2, 5, 4, 2)).astype(np.float32) * 0.3, axis=2)
    mask = np.ones((2, 5), bool)
    jm = JForecaster(jcfg, 4, 3)
    key = jax.random.PRNGKey(1)
    want = np.asarray(jm.rollout_k(jparams, xy, mask, JNormStats(MEAN, STD), key, 3))
    stream = tuple(np.array(a) for a in jm._rollout_stream(key, 3 * 2, 5))
    model = Forecaster(cfg, 4, 3, device="cpu", state=state)
    got = model.rollout_k(xy, mask, NormStats(MEAN, STD), 3, stream=stream)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    fused = Forecaster(dataclasses.replace(cfg, use_pallas=True, use_fused_decoder=True), 4, 3,
                       device="cpu", state=state)
    with pytest.raises(AssertionError, match="bh"):
        fused.rollout_k(xy, mask, NormStats(MEAN, STD), 3, stream=stream)


# -- Keras convention -------------------------------------------------------------------

def _keras_layers(name, variant):
    """Keras-convention layers from the JAX package's export, the GRU's cells
    replaced by reset_after=False layouts for ``variant="reset_before"``."""
    jcfg, cfg, params = _setup(name, 4)
    layers = j_interop.export_keras_weights(params, jcfg)
    if variant == "reset_before":
        rng = np.random.default_rng(6)
        E, H = jcfg.embed_dim, jcfg.hidden_dim
        for lname in ("encoder_rnn", "decoder_rnn"):
            layers[lname] = {
                "kernel": rng.normal(size=(E, 3 * H)).astype(np.float32) * 0.2,
                "recurrent_kernel": rng.normal(size=(H, 3 * H)).astype(np.float32) * 0.2,
                "bias": rng.normal(size=(3 * H,)).astype(np.float32) * 0.1}
    return jcfg, cfg, layers


KERAS_CASES = [("gru_social", "reset_after"), ("gru_social", "reset_before"),
               ("lstm", "reset_after")]
KERAS_IDS = ["gru_reset_after", "gru_reset_before", "lstm"]


@pytest.mark.parametrize("name, variant", KERAS_CASES, ids=KERAS_IDS)
def test_import_keras_weights_equals_jax(name, variant):
    jcfg, cfg, layers = _keras_layers(name, variant)
    got = interop.import_keras_weights(layers, cfg)
    _assert_states_equal(got, _jax_state(j_interop.import_keras_weights(layers, jcfg)))
    if variant == "reset_before":
        assert "enc.cell.wh_n" in got and got["enc.cell.wh"].shape == (16, 32)


@pytest.mark.parametrize("name, variant", KERAS_CASES, ids=KERAS_IDS)
def test_keras_export_equals_jax_and_round_trips(name, variant):
    jcfg, cfg, layers = _keras_layers(name, variant)
    state = interop.import_keras_weights(layers, cfg)
    jparams = jax.tree.map(np.asarray, j_interop.import_keras_weights(layers, jcfg))
    out = interop.export_keras_weights(state, cfg)
    want = j_interop.export_keras_weights(jparams, jcfg)
    assert sorted(out) == sorted(want)
    for lname in want:
        _assert_arrays_equal(out[lname], want[lname])
    _assert_states_equal(interop.import_keras_weights(out, cfg), state)


def test_keras_export_folds_a_torch_lstm_recurrent_bias():
    jcfg, cfg, params = _setup("lstm", 8)
    sd = j_interop.export_state_dict(params, jcfg)
    sd["encoder.rnn.bias_hh_l0"] = sd["encoder.rnn.bias_hh_l0"] + 0.25
    state = interop.import_state_dict(sd, cfg)
    out = interop.export_keras_weights(state, cfg)
    want = j_interop.export_keras_weights(
        jax.tree.map(np.asarray, j_interop.import_state_dict(sd, jcfg)), jcfg)
    np.testing.assert_array_equal(out["encoder_rnn"]["bias"], want["encoder_rnn"]["bias"])
    back = interop.import_keras_weights(out, cfg)
    torch.testing.assert_close(back["enc.cell.b"], state["enc.cell.b"] + state["enc.cell.bh"],
                               atol=0, rtol=0)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_keras_h5_reads_in_both_packages(name, tmp_path):
    jcfg, cfg, params = _setup(name, 9)
    state = from_jax(params)
    port_file, jax_file = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    interop.save_keras_h5(port_file, state, cfg)
    j_interop.save_keras_h5(jax_file, params, jcfg)
    want = _jax_state(j_interop.load_keras_h5(jax_file, jcfg))
    _assert_states_equal(interop.load_keras_h5(jax_file, cfg), want)
    _assert_states_equal(interop.load_keras_h5(port_file, cfg), want)
    _assert_states_equal(_jax_state(j_interop.load_keras_h5(port_file, jcfg)), want)
    # a whole-model save keeps the same layout under "model_weights"
    nested = str(tmp_path / "model.h5")
    with h5py.File(port_file, "r") as src, h5py.File(nested, "w") as dst:
        src.copy(src["/"], dst, "model_weights")
        for k, v in src.attrs.items():
            dst["model_weights"].attrs[k] = v
    _assert_states_equal(interop.load_keras_h5(nested, cfg), want)


# -- cli convert ------------------------------------------------------------------------

def _config(data_dir="d"):
    return Config(model=ModelConfig(**SMALL),
                  data=DataConfig(data_dir=data_dir, scene="zara1", obs_len=4, pred_len=3,
                                  n_max=8),
                  train=TrainConfig(k_samples=3))


def _checkpoint(tmp_path, data_dir="d"):
    cfg = _config(data_dir)
    _, _, params = _setup("gru_social", 11)
    path = str(tmp_path / "src.npz")
    ck.save(path, from_jax(params), NormStats(MEAN, STD), cfg, step=21)
    return path, cfg


def test_cli_convert_npz_pt_h5_npz(tmp_path, capsys):
    src, cfg = _checkpoint(tmp_path)
    chain = [src] + [str(tmp_path / n) for n in ("a.pt", "b.h5", "c.npz")]
    for a, b in zip(chain, chain[1:]):
        assert cli.main(["convert", "--src", a, "--dst", b]) == 0
        assert f"converted {a} -> {b} (step=21)" in capsys.readouterr().out
    first, last = ck.load(src), ck.load(chain[-1])
    _assert_states_equal(last.state, first.state)
    np.testing.assert_array_equal(last.stats.mean, first.stats.mean)
    np.testing.assert_array_equal(last.stats.std, first.stats.std)
    assert last.config == cfg and last.step == 21


def test_cli_convert_keras_out_and_back(tmp_path):
    src, cfg = _checkpoint(tmp_path)
    keras_file, back = str(tmp_path / "keras.h5"), str(tmp_path / "back.pt")
    assert cli.main(["convert", "--keras", "--src", src, "--dst", keras_file]) == 0
    with h5py.File(keras_file, "r") as f:
        assert "encoder_rnn/encoder_rnn/kernel:0" in f
    assert cli.main(["convert", "--keras", "--src", keras_file, "--like", src,
                     "--dst", back]) == 0
    orig, got = ck.load(src), ck.load(back)
    # a native GRU goes out with a zero recurrent bias and comes back with it
    _assert_states_equal({k: got.state[k] for k in orig.state}, orig.state)
    assert set(got.state) - set(orig.state) == {"enc.cell.bh", "dec.cell.bh"}
    assert got.config == cfg and got.step == 21
    with pytest.raises(SystemExit):
        cli.main(["convert", "--keras", "--src", keras_file, "--dst", back])


def test_cli_eval_reads_a_pt_as_its_npz(tmp_path, capsys):
    data_dir = write_scenes(tmp_path)
    src, _ = _checkpoint(tmp_path, data_dir)
    pt = str(tmp_path / "model.pt")
    assert cli.main(["convert", "--src", src, "--dst", pt]) == 0
    capsys.readouterr()
    lines = []
    for path in (src, pt):
        assert cli.main(["eval", "--ckpt", path, "--batch-size", "4", "--device", "cpu"]) == 0
        lines.append(capsys.readouterr().out.strip().splitlines()[-1])
    assert lines[0] == lines[1]
    assert re.search(r"step=21 .*ADE=[\d.]+m", lines[0]), lines[0]
