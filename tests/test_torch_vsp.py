"""UCY .vsp ingestion of the port (``mmtraj_torch/data/vsp.py``) against the
JAX package's (``mmtraj/data/vsp.py``): the same control points, grids and
meters, the same errors, and converted files byte-equal."""

import numpy as np
import pytest

from mmtraj.data import vsp as jvsp
from mmtraj_torch.cli import main as cli_main
from mmtraj_torch.data import vsp
from mmtraj_torch.data.parser import read_annotation_file


def _write_vsp(path, peds):
    """peds: list of (n, 3) [x, y, frame] control-point arrays."""
    lines = [f"{len(peds)} - the number of splines"]
    for pts in peds:
        lines.append(f"{len(pts)} - Num of control points")
        for x, y, f in pts:
            lines.append(f"{x:.3f} {y:.3f} {int(f)} 0.0")
    path.write_text("\n".join(lines) + "\n")


def _random_peds(rng, n_peds=5):
    """Peds of 2-5 control points in drawing order (frames unsorted)."""
    peds = []
    for _ in range(n_peds):
        n = int(rng.integers(2, 6))
        frames = rng.choice(np.arange(0, 400), size=n, replace=False)
        peds.append(np.column_stack([rng.uniform(-360, 360, n), rng.uniform(-288, 288, n),
                                     frames]).astype(np.float64))
    return peds


def test_parse_vsp_equals_jax(tmp_path):
    peds = _random_peds(np.random.default_rng(0))
    p = tmp_path / "scene.vsp"
    _write_vsp(p, peds)
    out, ref = vsp.parse_vsp(str(p)), jvsp.parse_vsp(str(p))
    assert len(out) == len(ref) == len(peds)
    for a, b, want in zip(out, ref, peds):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, want, atol=5e-4)


@pytest.mark.parametrize("text, match", [
    ("1 - splines\n3 - points\n0 0 0 0\n1 1 10 0\n", "truncated"),
    ("1 - splines\n2 - points\n0.0 0.0 0 0.0\n1.0 1.0\n", "malformed control-point row"),
    ("\n\n", "empty .vsp file"),
    ("splines\n", "expected a count line"),
])
def test_parse_vsp_errors_as_jax(tmp_path, text, match):
    p = tmp_path / "bad.vsp"
    p.write_text(text)
    for parse in (vsp.parse_vsp, jvsp.parse_vsp):
        with pytest.raises(ValueError, match=match):
            parse(str(p))


@pytest.mark.parametrize("order", ["sorted", "unsorted"])
def test_interpolate_track_equals_jax(order):
    pts = np.array([[0.0, 0.0, 5], [40.0, 80.0, 45], [10.0, -3.0, 83]])
    if order == "unsorted":
        pts = pts[[2, 0, 1]]  # drawing order, not time
    out = vsp.interpolate_track(pts, frame_step=10)
    np.testing.assert_array_equal(out, jvsp.interpolate_track(pts, frame_step=10))
    np.testing.assert_array_equal(out[:, 2], np.arange(10, 81, 10))
    np.testing.assert_allclose(out[:4, 0], out[:4, 2] - 5)  # linear in frame time


def test_apply_homography_equals_jax():
    rng = np.random.default_rng(1)
    xy = rng.uniform(-300, 300, size=(50, 2))
    for H in (np.array([[0.05, 0, 1.0], [0, -0.05, 2.0], [0, 0, 1.0]]),
              np.eye(3) + rng.normal(scale=1e-3, size=(3, 3))):  # projective
        np.testing.assert_allclose(vsp.apply_homography(H, xy),
                                   jvsp.apply_homography(H, xy), rtol=0, atol=1e-12)
    np.testing.assert_allclose(vsp.apply_homography(
        np.array([[1.0, 0, 0], [0, 1.0, 0], [0.01, 0, 1.0]]), np.array([[100.0, 200.0]])),
        [[50.0, 100.0]])
    with pytest.raises(ValueError, match="3x3"):
        vsp.apply_homography(np.eye(2), xy)


@pytest.mark.parametrize("mapping", ["homography", "scale", "below_grid"])
def test_convert_vsp_byte_equal_to_jax(tmp_path, mapping):
    rng = np.random.default_rng(2)
    if mapping == "below_grid":  # every track spans fewer frames than the step
        peds = [np.array([[0.0, 0.0, 3], [5.0, 5.0, 7]]), np.array([[1.0, 2.0, 11],
                                                                    [3.0, 4.0, 19]])]
    else:
        peds = _random_peds(rng)
    src = tmp_path / "zara9.vsp"
    _write_vsp(src, peds)
    kw = ({"homography": np.array([[0.02, 0.001, -0.5], [0.0005, -0.021, 0.3],
                                   [1e-5, 2e-5, 1.0]])} if mapping == "homography"
          else {"scale": 0.02})
    mine, theirs = tmp_path / "a.txt", tmp_path / "b.txt"
    n = vsp.convert_vsp(str(src), str(mine), **kw)
    assert n == jvsp.convert_vsp(str(src), str(theirs), **kw)
    assert mine.read_bytes() == theirs.read_bytes()
    rows = read_annotation_file(str(mine))
    assert rows.shape == (n, 4)
    if mapping == "below_grid":
        assert n == 0 and mine.read_text().strip() == ""
    else:
        assert n > 0
        order = np.lexsort((rows[:, 1], rows[:, 0]))  # frame-major
        np.testing.assert_array_equal(order, np.arange(n))
    with pytest.raises(ValueError, match="exactly one"):
        vsp.convert_vsp(str(src), str(mine))


def test_cli_import_vsp_as_jax(tmp_path, capsys):
    from mmtraj.cli import main as j_cli_main

    src = tmp_path / "crowds.vsp"
    _write_vsp(src, _random_peds(np.random.default_rng(3)))
    h = tmp_path / "H.txt"
    np.savetxt(h, np.array([[0.02, 0, 0], [0, 0.02, 0], [0, 0, 1.0]]))
    mine, theirs = tmp_path / "a.txt", tmp_path / "b.txt"
    assert cli_main(["import-vsp", "--src", str(src), "--dst", str(mine),
                     "--homography", str(h)]) == 0
    out = capsys.readouterr().out
    assert j_cli_main(["import-vsp", "--src", str(src), "--dst", str(theirs),
                       "--homography", str(h)]) == 0
    assert out.replace(str(mine), str(theirs)) == capsys.readouterr().out
    assert out.startswith("wrote ") and mine.read_bytes() == theirs.read_bytes()
    for flags in ([], ["--homography", str(h), "--scale", "0.02"]):
        with pytest.raises(SystemExit) as e:
            cli_main(["import-vsp", "--src", str(src), "--dst", str(mine), *flags])
        assert e.value.code == 2
        assert "pass exactly one of --homography or --scale" in capsys.readouterr().err
