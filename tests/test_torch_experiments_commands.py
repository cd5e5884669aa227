"""The port's training scripts issue the JAX scripts' commands.

Each JAX ``.sh`` of ``experiments/`` is copied unchanged into a scratch
directory as ``tmp/experiments/x.sh`` (its ``cd`` lands in ``tmp``, where no
``data/synthetic*`` exists) and run with a stub ``python`` first on ``PATH``
that records its argv.  The port script's ``--dry-run`` lines equal those
argv, modulo ``mmtraj.cli`` -> ``mmtraj_torch.cli``, the tree and data roots
(given as other paths here) and the documented ``--fast`` flags
(``--use-pallas``, and ``--vmap-seeds`` where a command trains at least two
seeds).  One of its commands runs for real on the CPU; without a card and
without ``--device cpu`` the training scripts and the reports stop with an error.
"""

import json
import os
import shlex
import shutil
import stat
import subprocess
import sys

import pytest
import torch

from torch_experiments import EXPERIMENTS, generate

import torch_dense_sweep  # noqa: E402  (experiments/, on the path)
import torch_dense_sweep_report  # noqa: E402
import torch_mixed_zara1_probe  # noqa: E402
import torch_scale_quality  # noqa: E402
import torch_social_ablation  # noqa: E402

torch.set_num_threads(2)

TRAINERS = {"social_ablation.sh": torch_social_ablation, "dense_sweep.sh": torch_dense_sweep,
           "scale_quality.sh": torch_scale_quality}


def _jax_argv(tmp_path, script):
    """The argv of every ``python`` the JAX script runs, in order."""
    (tmp_path / "experiments").mkdir()
    shutil.copy(EXPERIMENTS / script, tmp_path / "experiments" / script)
    bin_dir, log = tmp_path / "bin", tmp_path / "argv.jsonl"
    bin_dir.mkdir()
    stub = bin_dir / "python"
    stub.write_text(f"#!{sys.executable}\nimport json, sys\n"
                    f"open({str(log)!r}, 'a').write(json.dumps(sys.argv[1:]) + '\\n')\n")
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    env = {**os.environ, "PATH": f"{bin_dir}{os.pathsep}{os.environ['PATH']}"}
    subprocess.run(["bash", str(tmp_path / "experiments" / script)], env=env, check=True,
                   capture_output=True, text=True)
    return [json.loads(ln) for ln in log.read_text().splitlines()]


def _port_argv(script_mod, argv, capsys):
    capsys.readouterr()
    assert script_mod.main(argv) == 0
    return [shlex.split(ln) for ln in capsys.readouterr().out.splitlines()]


def _roots(script, tmp_path):
    """The script's root flags pointing elsewhere, and the map back to the
    JAX script's relative roots."""
    runs, data = str(tmp_path / "elsewhere" / "runs"), str(tmp_path / "elsewhere" / "data")
    if script == "scale_quality.sh":
        return ["--runs", runs, "--data-root", data], [(runs, "runs"), (data, "data")]
    return (["--runs", runs, "--data-dir", data + "/synthetic"],
            [(runs, "runs"), (data + "/synthetic", "data/synthetic")])


def _as_jax(line, back):
    assert line[:3] == ["python", "-m", "mmtraj_torch.cli"], line
    out = ["-m", "mmtraj.cli"]
    for a in line[3:]:
        for root, rel in back:
            if a.startswith(root):
                a = rel + a[len(root):]
        out.append(a)
    return out


@pytest.mark.parametrize("script", sorted(TRAINERS))
def test_dry_run_issues_the_jax_scripts_commands(script, tmp_path, monkeypatch, capsys):
    want = _jax_argv(tmp_path, script)
    flags, back = _roots(script, tmp_path)
    monkeypatch.chdir(tmp_path)
    got = _port_argv(TRAINERS[script], ["--dry-run", *flags], capsys)
    assert [_as_jax(ln, back) for ln in got] == want
    assert len(want) == {"social_ablation.sh": 6, "dense_sweep.sh": 6,
                         "scale_quality.sh": 6}[script]


@pytest.mark.parametrize("script", sorted(TRAINERS))
def test_fast_adds_the_kernel_flags_and_nothing_else(script, tmp_path, monkeypatch, capsys):
    want = _jax_argv(tmp_path, script)
    flags, back = _roots(script, tmp_path)
    monkeypatch.chdir(tmp_path)
    got = [_as_jax(ln, back) for ln in _port_argv(TRAINERS[script], ["--dry-run", "--fast",
                                                                     *flags], capsys)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w[2] != "train":
            assert g == w
            continue
        i = w.index("--seeds")
        n_seeds = next(j for j, a in enumerate(w[i + 1:]) if a.startswith("--"))
        assert g == w + ["--use-pallas"] + (["--vmap-seeds"] if n_seeds >= 2 else [])


def test_smoke_options_replace_steps_and_seeds(capsys):
    got = _port_argv(torch_dense_sweep, ["--dry-run", "--cell", "A", "E", "--fast", "--steps",
                                         "4", "--seeds", "0", "1", "--device", "cpu"], capsys)
    assert len(got) == 2
    a, e = got
    assert a[a.index("--steps") + 1] == "4" and a.count("--steps") == 1
    assert a[a.index("--seeds") + 1:a.index("--seeds") + 4] == ["0", "1", "--hidden-dim"]
    assert a[-6:] == ["--warmup-steps", "2", "--use-pallas", "--vmap-seeds", "--device", "cpu"]
    assert "--n-max" in e and e[-4:] == ["--use-pallas", "--vmap-seeds", "--device", "cpu"]


def test_a_training_command_runs_on_the_cpu(tmp_path, capsys):
    """Social arm B2 (config 3, zara1, radius 2) at full width for one step,
    two seeds as one population under --fast (the kernels' plain versions
    on the CPU): each seed's EMA checkpoint is written."""
    data = generate(str(tmp_path), 30)
    assert torch_social_ablation.main(["--arm", "B2", "--fast", "--steps", "1", "--seeds", "0",
                                       "1", "--runs", str(tmp_path / "runs"), "--data-dir", data,
                                       "--device", "cpu"]) == 0
    assert "=== B. adjacency radius sweep" in capsys.readouterr().out
    for s in (0, 1):
        assert (tmp_path / "runs" / "r4" / "rad2_zara1" / f"s{s}" / "checkpoint_ema.npz").exists()


@pytest.mark.parametrize("main, argv", [
    (torch_dense_sweep.main, ["--cell", "A"]),
    (torch_dense_sweep_report.main, []),
    (torch_mixed_zara1_probe.main, ["--route", "plain"]),
], ids=["trainer", "report", "mixed"])
def test_no_card_and_no_device_cpu_is_an_error(main, argv, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the entry points run on it")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="--device cpu"):
        main(argv)
