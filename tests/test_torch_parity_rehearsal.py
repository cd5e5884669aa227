"""The port's drop-in rehearsal (``tools/torch_parity_rehearsal.py``) on the
CPU: raw obsmat and vsp fixtures, the import commands and their round-trip
equality, ``train --config 3``, ``eval``, the ``.pt`` and Keras ``.h5``
round trips, the ``.pt2`` export and one served request, each hop with its
assertion; the same evidence as the JAX package's rehearsal
(``tests/test_parity_rehearsal.py``)."""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import torch_parity_rehearsal  # noqa: E402

torch.set_num_threads(2)


def test_rehearsal_all_hops(tmp_path):
    evidence = torch_parity_rehearsal.rehearse(str(tmp_path), steps=40, k=4, n_frames=120,
                                               device="cpu", verbose=False)
    assert set(evidence) == {"import", "eval", "convert", "serve"}
    assert evidence["import"] == "obsmat+vsp round-trip exact"
    assert evidence["serve"] == "1 request -> pred(4, 3, 12, 2)"
