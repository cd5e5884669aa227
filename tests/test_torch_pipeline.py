"""The port's streaming ingest on the CPU: ``prefetch_to_device``, the
streamed ``fit`` and ``stream_bench`` (counterparts of the JAX package's
``tests/test_pipeline.py``).  No test here reads through the JAX package's
registry."""

import dataclasses
import json
import threading
import time

import numpy as np
import pytest
import torch

from mmtraj_torch import config, train
from mmtraj_torch.benchmarks import stream_bench
from mmtraj_torch.data.collate import WindowDataset
from mmtraj_torch.data.pipeline import DeviceDataset, prefetch_to_device
import torch_exit_check
from torch_jax_streams import SMALL, TO, TP, random_windows, write_scenes

torch.set_num_threads(2)


def _batches(n=7):
    rng = np.random.default_rng(0)
    return [(rng.normal(size=(3, 4)).astype(np.float32), rng.random(3) < 0.5) for _ in range(n)]


def test_prefetch_keeps_order_and_values():
    host = _batches()
    got = list(prefetch_to_device(iter(host), size=2, device="cpu"))
    assert len(got) == len(host)
    for (xy, mask), (hxy, hmask) in zip(got, host):
        assert isinstance(xy, torch.Tensor) and xy.device.type == "cpu"
        assert np.array_equal(xy.numpy(), hxy) and np.array_equal(mask.numpy(), hmask)
        hxy[0, 0] += 1.0  # a copy, not a view of the host array
        assert not np.array_equal(xy.numpy(), hxy)


def test_prefetch_of_an_empty_iterator_yields_nothing():
    assert list(prefetch_to_device(iter([]), device="cpu")) == []


def test_abandoned_consumer_stops_the_producer_within_a_second():
    def endless():
        while True:
            yield np.zeros(4, np.float32)

    before = set(threading.enumerate())
    it = prefetch_to_device(endless(), size=2, device="cpu")
    next(it)
    producers = [t for t in threading.enumerate() if t not in before]
    assert len(producers) == 1 and producers[0].is_alive()
    it.close()
    producers[0].join(timeout=1.0)
    assert not producers[0].is_alive()


def test_close_returns_after_the_producer_has_ended():
    def endless():
        while True:
            yield np.zeros(4, np.float32)

    before = set(threading.enumerate())
    it = prefetch_to_device(endless(), size=2, device="cpu")
    next(it)
    producers = [t for t in threading.enumerate() if t not in before]
    it.close()
    assert len(producers) == 1 and not producers[0].is_alive()


def test_process_exits_cleanly_right_after_a_close():
    # A producer still copying when the interpreter exits is ended inside
    # C++ code and aborts the process (exit 134).
    for r in torch_exit_check.exit_after_close("cpu", runs=3):
        assert torch_exit_check.clean(r), (r.returncode, r.stderr[-2000:])


def test_producer_exception_is_raised_in_the_consumer():
    def failing():
        yield np.ones(2, np.float32)
        raise OSError("disk gone")

    it = prefetch_to_device(failing(), device="cpu")
    assert torch.equal(next(it), torch.ones(2))
    with pytest.raises(OSError, match="disk gone"):
        next(it)


def test_prefetch_bounds_the_batches_in_flight():
    pulled = []

    def counting():
        for i in range(10):
            pulled.append(i)
            yield np.full(1, i, np.float32)

    it = prefetch_to_device(counting(), size=2, device="cpu")
    next(it)
    time.sleep(0.3)
    # one consumed, two queued, one pulled and waiting for a slot
    assert len(pulled) <= 4
    assert [int(x) for x in it] == list(range(1, 10))


def test_streamed_batches_are_the_resident_ones():
    windows = random_windows(np.random.default_rng(1), [3, 5, 2, 4, 1, 6, 2])
    ds = WindowDataset(windows, 8)
    cfg = config.config4()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=3, seed=4))
    resident = train.batch_source(cfg, ds, DeviceDataset(ds, "cpu"),
                                  train.index_stream(DeviceDataset(ds, "cpu"), 3, 4, 1, 1),
                                  1, 1, "cpu")
    stream_cfg = cfg.replace(train=dataclasses.replace(cfg.train, stream=True))
    streamed = train.batch_source(stream_cfg, ds, None, None, 1, 1, "cpu")
    for _ in range(6):  # across an epoch boundary
        (a, am, _), (b, bm, _) = next(resident), next(streamed)
        assert torch.equal(a, b) and torch.equal(am, bm)
    streamed.close()


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return write_scenes(tmp_path_factory.mktemp("scenes"))


def test_streamed_fit_equals_resident_fit_step_by_step(data_dir):
    """Hybrid loss with dropout, augment and EMA, across an epoch boundary."""
    cfg = config.config4()
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, **SMALL, dropout=0.1),
        data=dataclasses.replace(cfg.data, data_dir=data_dir, n_max=8, obs_len=TO, pred_len=TP),
        train=dataclasses.replace(cfg.train, batch_size=4, steps=12, eval_every=0, log_every=1,
                                  k_samples=2, out_dir="", loss="hybrid", variety_n=2,
                                  augment_rotate=True, augment_flip=True, ema_decay=0.9))
    resident = train.fit(cfg, device="cpu")
    streamed = train.fit(cfg.replace(train=dataclasses.replace(cfg.train, stream=True)),
                         device="cpu")
    assert streamed.history == resident.history
    for k in resident.state:
        assert torch.equal(streamed.state[k], resident.state[k]), k


def test_stream_bench_prints_one_json_line(capsys):
    stream_bench.main(["--device", "cpu", "--windows", "24", "--batch", "4", "--n-max", "8",
                       "--steps", "2", "--warmup", "1", "--dtype", "float32"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    r = json.loads(lines[0])
    assert r["resident_steps_per_sec"] > 0 and r["stream_steps_per_sec"] > 0
    assert r["stream_over_resident"] == r["stream_steps_per_sec"] / r["resident_steps_per_sec"]
    assert (r["windows"], r["batch"], r["device"]) == (24, 4, "cpu")
