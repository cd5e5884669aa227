#!/usr/bin/env python
"""The drop-in rehearsal of the PyTorch port: every hop a real ETH/UCY drop-in
would take, in one process, with an assertion at each hop, on config 3.

The counterpart of ``tools/parity_rehearsal.py``, through ``mmtraj_torch``
alone (it imports neither JAX nor the JAX package):

1. canonical synthetic scenes (``cli generate-data``) and raw forms derived
   from them: BIWI obsmat rows for eth, UCY ``.vsp`` splines in pixels with
   a pixel-to-meter homography for zara1;
2. ``cli import-obsmat`` / ``cli import-vsp`` back to canonical files, held
   equal to the originals (ids up to a relabelling);
3. ``cli train --config 3`` on the imported tree (zara1 held out);
4. ``cli eval``: finite best-of-K on the held-out scene;
5. ``.pt`` and Keras ``.h5`` round trips through ``cli convert``;
6. ``cli export`` to the ``.pt2`` artifact (the port's counterpart of the
   StableHLO export);
7. one JSON-lines request through ``serve.serve_lines``.

    python tools/torch_parity_rehearsal.py [--steps 400] [--workdir DIR] [--device cpu]

The entry points run on the card unless ``--device cpu``.  The Keras hop
needs ``h5py``; ``tests/test_torch_parity_rehearsal.py`` runs ``rehearse()``
on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

H_UCY = np.array([[0.047, 0.0, -3.2], [0.0, -0.051, 14.9], [0.0, 0.0, 1.0]])


def _load_canonical(path):
    return np.loadtxt(path, dtype=np.float64).reshape(-1, 4)


def _write_obsmat_raw(canonical_txt, dst):
    """Canonical (frame id x y) -> 8-column BIWI obsmat rows [frame id pos_x
    pos_z pos_y v_x v_z v_y] (z the height axis)."""
    rows = _load_canonical(canonical_txt)
    n = len(rows)
    raw = np.column_stack([rows[:, 0], rows[:, 1], rows[:, 2], np.zeros(n), rows[:, 3],
                           np.zeros((n, 3))])
    np.savetxt(dst, raw)


def _write_vsp_raw(canonical_txt, vsp_dst, h_dst):
    """Canonical rows -> UCY ``.vsp`` splines in pixel coordinates and the
    3x3 pixel-to-meter homography that gives the meters back.  Every
    annotation point is a control point on the frame grid, so linear
    interpolation reproduces the rows."""
    rows = _load_canonical(canonical_txt)
    hinv = np.linalg.inv(H_UCY)
    px = (hinv @ np.column_stack([rows[:, 2:4], np.ones((len(rows), 1))]).T).T
    px = px[:, :2] / px[:, 2:3]
    ped_ids = np.unique(rows[:, 1])
    lines = [f"{len(ped_ids)} - the number of splines"]
    for pid in ped_ids:
        sel = rows[:, 1] == pid
        pts = np.column_stack([px[sel], rows[sel, 0]])
        pts = pts[np.argsort(pts[:, 2])]
        lines.append(f"{len(pts)} - Num of control points")
        lines += [f"{x:.9f} {y:.9f} {int(f)} 0.0" for x, y, f in pts]
    with open(vsp_dst, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    np.savetxt(h_dst, H_UCY)


def _assert_same_annotations(imported_txt, canonical_txt, what, atol=1e-4):
    """The same (frame, x, y) rows, ped ids equal up to a bijection (the vsp
    importer numbers ids in its spline order)."""
    a, b = _load_canonical(imported_txt), _load_canonical(canonical_txt)
    a = a[np.lexsort((a[:, 3], a[:, 2], a[:, 0]))]
    b = b[np.lexsort((b[:, 3], b[:, 2], b[:, 0]))]
    assert a.shape == b.shape, f"{what}: imported {a.shape} rows, canonical {b.shape}"
    np.testing.assert_allclose(a[:, [0, 2, 3]], b[:, [0, 2, 3]], atol=atol, rtol=0,
                               err_msg=f"{what}: frame/x/y differ")
    fwd, bwd = {}, {}
    for ia, ib in zip(a[:, 1], b[:, 1]):
        assert fwd.setdefault(ia, ib) == ib and bwd.setdefault(ib, ia) == ia, (
            f"{what}: ped ids are not a bijection ({ia} vs {ib})")


def _cli(*argv) -> str:
    """A ``mmtraj_torch.cli`` subcommand in this process; asserts exit 0 and
    returns its standard output."""
    from mmtraj_torch.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(list(argv))
    out = buf.getvalue()
    assert rc == 0, f"cli {argv[0]} failed (rc={rc}):\n{out}"
    return out


def _states_equal(a, b, what, extra_zero=False):
    """Every leaf of ``a`` equal in ``b`` within 1e-6; with ``extra_zero`` a
    leaf that only ``b`` has must be all zeros (the Keras layout's recurrent
    bias ``bh``, which the fused cell folds into ``b``)."""
    missing = sorted(set(a) - set(b))
    assert not missing, f"{what}: lost {missing}"
    for k in a:
        np.testing.assert_allclose(np.asarray(b[k]), np.asarray(a[k]), rtol=1e-6, atol=1e-6,
                                   err_msg=f"{what}: {k}")
    extra = sorted(set(b) - set(a))
    assert extra_zero or not extra, f"{what}: gained {extra}"
    for k in extra:
        assert not np.asarray(b[k]).any(), f"{what}: gained a nonzero leaf {k}"


def rehearse(workdir: str, steps: int = 400, k: int = 20, n_frames: int = 200,
             device: str = "cuda", verbose: bool = True) -> dict:
    """The whole drop-in chain; raises AssertionError at the hop that fails.
    -> {hop: evidence}."""
    from mmtraj_torch import checkpoint
    from mmtraj_torch.serve import serve_lines

    log = print if verbose else (lambda *a, **kw: None)
    evidence = {}
    canon, rawd, data = (os.path.join(workdir, d) for d in ("canonical", "raw", "data"))
    for d in (canon, rawd, data):
        os.makedirs(d, exist_ok=True)

    # 1. canonical scenes and the raw forms derived from them
    _cli("generate-data", "--data-dir", canon, "--n-frames", str(n_frames))
    _write_obsmat_raw(os.path.join(canon, "eth.txt"), os.path.join(rawd, "obsmat.txt"))
    _write_vsp_raw(os.path.join(canon, "zara1.txt"), os.path.join(rawd, "crowds_zara01.vsp"),
                   os.path.join(rawd, "H.txt"))
    log("[1/7] raw fixtures written (obsmat 8 columns; .vsp splines and H)")

    # 2. the importers give the canonical rows back
    _cli("import-obsmat", "--src", os.path.join(rawd, "obsmat.txt"),
         "--dst", os.path.join(data, "eth.txt"))
    _cli("import-vsp", "--src", os.path.join(rawd, "crowds_zara01.vsp"),
         "--dst", os.path.join(data, "zara1.txt"), "--homography", os.path.join(rawd, "H.txt"))
    _assert_same_annotations(os.path.join(data, "eth.txt"), os.path.join(canon, "eth.txt"),
                             "import-obsmat")
    _assert_same_annotations(os.path.join(data, "zara1.txt"), os.path.join(canon, "zara1.txt"),
                             "import-vsp")
    for s in ("hotel", "univ", "zara2"):
        shutil.copy(os.path.join(canon, f"{s}.txt"), os.path.join(data, f"{s}.txt"))
    evidence["import"] = "obsmat+vsp round-trip exact"
    log("[2/7] import-obsmat and import-vsp give the canonical rows back")

    # 3. train config 3 on the imported tree
    out = os.path.join(workdir, "run")
    _cli("train", "--config", "3", "--scene", "zara1", "--data-dir", data, "--steps", str(steps),
         "--k", str(k), "--out-dir", out, "--eval-every", "0", "--device", device)
    ckpt = os.path.join(out, "checkpoint.npz")
    assert os.path.exists(ckpt), "train wrote no checkpoint"
    log(f"[3/7] trained config 3 for {steps} steps on the imported tree")

    # 4. eval: finite best-of-K on the held-out (imported) scene
    txt = _cli("eval", "--ckpt", ckpt, "--data-dir", data, "--k", str(k), "--device", device)
    line = [ln for ln in txt.splitlines() if "ADE=" in ln][-1]
    ade = float(line.split("ADE=")[1].split("m")[0])
    fde = float(line.split("FDE=")[1].split("m")[0])
    assert np.isfinite(ade) and np.isfinite(fde), line
    evidence["eval"] = f"ADE={ade:.4f} FDE={fde:.4f}"
    log(f"[4/7] eval finite: ADE={ade:.4f} FDE={fde:.4f}")

    # 5. round trips through the torch .pt and the Keras .h5 conventions
    orig = checkpoint.load(ckpt)
    pt, back_pt = os.path.join(workdir, "ck.pt"), os.path.join(workdir, "ck_from_pt.npz")
    _cli("convert", "--src", ckpt, "--dst", pt)
    _cli("convert", "--src", pt, "--dst", back_pt)
    _states_equal(orig.state, checkpoint.load(back_pt).state, "torch .pt round trip")
    h5, back_h5 = os.path.join(workdir, "ck_keras.h5"), os.path.join(workdir, "ck_from_keras.npz")
    _cli("convert", "--src", ckpt, "--dst", h5, "--keras")
    _cli("convert", "--src", h5, "--dst", back_h5, "--keras", "--like", ckpt)
    _states_equal(orig.state, checkpoint.load(back_h5).state, "keras round trip",
                  extra_zero=True)
    evidence["convert"] = "pt + keras-h5 round trips allclose"
    log("[5/7] checkpoint round trips: torch .pt and Keras .h5")

    # 6. the frozen predictor
    art = os.path.join(workdir, "predictor.pt2")
    _cli("export", "--ckpt", ckpt, "--out", art, "--batch", "4", "--k", str(k),
         "--device", device)
    assert os.path.getsize(art) > 0
    log("[6/7] exported the frozen predictor")

    # 7. one request through the JSON-lines protocol: {"xy": [N][T_obs][2],
    # "seed": ...} -> {"pred": [K][N][T_pred][2], "k": K} for one window
    rng = np.random.default_rng(0)
    obs = np.cumsum(rng.normal(size=(3, 8, 2)) * 0.3, axis=1)
    stdout = io.StringIO()
    served = serve_lines(art, io.StringIO(json.dumps({"xy": obs.tolist(), "seed": 7}) + "\n"),
                         stdout, log_stream=io.StringIO())
    assert served == 1, f"serve answered {served} request(s) ok, expected 1"
    resp = json.loads(stdout.getvalue().splitlines()[-1])
    assert "pred" in resp and resp.get("k") == k, resp.keys()
    pred = np.asarray(resp["pred"])
    assert pred.shape == (k, 3, 12, 2) and np.isfinite(pred).all(), pred.shape
    evidence["serve"] = f"1 request -> pred{pred.shape}"
    log(f"[7/7] served one request: pred {pred.shape}")
    log("parity rehearsal: every hop passed")
    return evidence


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--workdir", default=None, help="default: a fresh temporary directory")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    workdir = args.workdir or tempfile.mkdtemp(prefix="torch_parity_rehearsal_")
    print(f"workdir: {workdir}")
    rehearse(workdir, steps=args.steps, k=args.k, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
