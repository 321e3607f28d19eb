"""Import hygiene of the PyTorch port: it imports neither ``jax`` nor the
JAX package, needs no ``nvcc`` or ``triton`` to import, and exports the
JAX package's public names for what it ports."""

import os
import subprocess
import sys

import montecarlo_tpu as mc
import montecarlo_tpu_torch as tmc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "import montecarlo_tpu_torch\n"
        "import montecarlo_tpu_torch.interop\n"
        "import montecarlo_tpu_torch.ops.fused_sweep\n"
        "import montecarlo_tpu_torch.ops.lj_sweep\n"
        "import montecarlo_tpu_torch.models.lennard_jones\n"
        "import montecarlo_tpu_torch.ops.poly_sweep\n"
        "import montecarlo_tpu_torch.models.polydisperse\n"
        "import montecarlo_tpu_torch.ops.cell_mc\n"
        "import montecarlo_tpu_torch.models.hard_disks\n"
        "import montecarlo_tpu_torch.policy_guided\n"
        "import montecarlo_tpu_torch.checkpoint\n"
        "import montecarlo_tpu_torch.parallel\n"
        "import montecarlo_tpu_torch.parallel.distributed\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'montecarlo_tpu', 'triton')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PATH="/nonexistent", CUDA_HOME="/nonexistent")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_public_names_follow_reference():
    ported = set(tmc.__all__) - {"interop"}
    assert ported <= set(mc.__all__), ported - set(mc.__all__)
    for name in ("Simulation", "Metropolis", "StoreCallbacks",
                 "StoreTrajectories", "BIN", "callback_acceptance",
                 "build_schedule", "load_chain_major_trajectories",
                 "StoreLastFrames"):
        assert name in ported
        assert getattr(tmc, name).__name__ == getattr(mc, name).__name__


def test_policy_guided_exports_follow_reference():
    from montecarlo_tpu import policy_guided as ref_pg
    from montecarlo_tpu_torch import policy_guided as pg
    assert pg.__all__ == ref_pg.__all__
    for name in pg.__all__:
        assert getattr(pg, name).__name__ == getattr(ref_pg, name).__name__
    assert tmc.checkpoint.__all__ == mc.checkpoint.__all__
    assert {"StoreBackups", "checkpoint", "policy_guided"} <= set(tmc.__all__)


def test_cell_mc_and_hard_disk_exports_follow_reference():
    """The ported modules keep the reference's names: every public name of
    the port's ``ops/cell_mc.py``, ``models/hard_disks.py`` and the models'
    ``cell_closures`` is the reference's, bar the port's draws class."""
    from montecarlo_tpu.models import hard_disks as ref_hd
    from montecarlo_tpu.ops import cell_mc as ref_cell
    from montecarlo_tpu_torch import models
    from montecarlo_tpu_torch.models import hard_disks
    from montecarlo_tpu_torch.ops import cell_mc
    assert set(cell_mc.__all__) - {"GeneratorDraws"} == set(ref_cell.__all__)
    assert set(hard_disks.__all__) <= set(ref_hd.__all__)
    assert {"hard_disks", "lennard_jones", "particle1d",
            "polydisperse"} <= set(models.__all__)
    assert set(models.__all__) <= set(mc.models.__all__)
    for name in ("lennard_jones", "polydisperse"):
        assert "cell_closures" in getattr(models, name).__all__
