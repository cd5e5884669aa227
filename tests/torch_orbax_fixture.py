"""Write the Orbax fixture that the port reads without JAX, with the JAX
package: ``tests/fixtures/torch_orbax_c4/`` (``mmtraj.checkpoint.save_orbax``
of config 4, ``Forecaster.init(PRNGKey(0))``, step 1234) and its twin
``tests/fixtures/torch_orbax_c4_twin.npz`` (``save_npz`` of the same tree).
The twin must not be named ``torch_orbax_c4.npz``: both packages' ``load``
of a path whose ``.npz`` sibling exists reads that file, so the directory
would never be read.

``chip_smoke.py`` loads the directory on the GPU machine, which has no JAX,
and holds it against the twin; ``tests/test_torch_orbax.py`` pins that the
JAX package's ``load`` of the directory equals the twin, so a regenerated
fixture cannot drift from what the chip run reads.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_orbax_fixture.py
"""

import shutil
from pathlib import Path

import numpy as np

FIXTURES = Path(__file__).resolve().parent / "fixtures"
ORBAX_DIR = FIXTURES / "torch_orbax_c4"
TWIN = FIXTURES / "torch_orbax_c4_twin.npz"
STEP = 1234
MEAN = np.array([0.25, -0.5], np.float32)
STD = np.array([1.5, 2.0], np.float32)


def write(orbax_dir: Path = ORBAX_DIR, twin: Path = TWIN) -> None:
    import jax

    from mmtraj import checkpoint, config
    from mmtraj.data.transforms import NormStats
    from mmtraj.models import Forecaster

    cfg = config.config4()
    model = Forecaster(cfg.model, cfg.data.obs_len, cfg.data.pred_len)
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
    stats = NormStats(MEAN, STD)
    shutil.rmtree(orbax_dir, ignore_errors=True)
    checkpoint.save_orbax(str(orbax_dir), params, stats, cfg, step=STEP)
    checkpoint.save_npz(str(twin), params, stats, cfg, step=STEP)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    write()
    print(f"wrote {ORBAX_DIR} and {TWIN}")
