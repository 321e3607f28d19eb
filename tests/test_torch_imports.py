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
        "import montecarlo_tpu_torch.core.ecmc\n"
        "import montecarlo_tpu_torch.core.tempering\n"
        "import montecarlo_tpu_torch.utils.analysis\n"
        "import montecarlo_tpu_torch.ops.cluster\n"
        "import montecarlo_tpu_torch.models.ising\n"
        "import montecarlo_tpu_torch.models.ising2d\n"
        "import montecarlo_tpu_torch.models.potts\n"
        "import montecarlo_tpu_torch.models.xy\n"
        "import montecarlo_tpu_torch.models.heisenberg\n"
        "import montecarlo_tpu_torch.models.tfim\n"
        "import montecarlo_tpu_torch.core.wanglandau\n"
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
    assert set(cell_mc.__all__) - {"KeyDraws"} == set(ref_cell.__all__)
    assert set(hard_disks.__all__) <= set(ref_hd.__all__)
    assert {"hard_disks", "lennard_jones", "particle1d",
            "polydisperse"} <= set(models.__all__)
    assert set(models.__all__) <= set(mc.models.__all__)
    for name in ("lennard_jones", "polydisperse"):
        assert "cell_closures" in getattr(models, name).__all__


def test_slice_exports_follow_reference():
    """Event-chain MC, replica exchange, the cluster ops and the lattice
    models keep the reference's names: the ported modules' public names are
    the reference's, bar the port's draws class and loop
    (``core/ecmc.py``)."""
    from montecarlo_tpu.core import ecmc as ref_ecmc
    from montecarlo_tpu.core import tempering as ref_tempering
    from montecarlo_tpu.models import ising as ref_ising
    from montecarlo_tpu.models import ising2d as ref_ising2d
    from montecarlo_tpu.models import potts as ref_potts
    from montecarlo_tpu.ops import cluster as ref_cluster
    from montecarlo_tpu_torch.core import ecmc, tempering
    from montecarlo_tpu_torch.models import ising, ising2d, potts
    from montecarlo_tpu_torch.ops import cluster
    assert set(ecmc.__all__) - {"KeyEventDraws", "event_loop"} \
        == set(ref_ecmc.__all__)
    assert set(ising2d.__all__) == set(ref_ising2d.__all__)
    for mine, ref in ((tempering, ref_tempering), (cluster, ref_cluster),
                      (ising, ref_ising), (potts, ref_potts)):
        assert set(mine.__all__) == set(ref.__all__), mine.__name__
    for name in ("EventChain", "EventChainModel", "ecmc_callbacks",
                 "ReplicaExchange", "tile_ladder", "callback_swap_rate",
                 "analysis"):
        assert name in tmc.__all__ and name in mc.__all__
    for mod in ("particle1d", "hard_disks", "lennard_jones", "polydisperse"):
        mine = getattr(tmc.models, mod)
        ref = getattr(mc.models, mod)
        hooks = {n for n in ref.__all__ if n.startswith(("ecmc", "zigzag"))}
        assert hooks and hooks <= set(mine.__all__), mod


def test_public_api_is_complete():
    """Every public name of the JAX package has its counterpart in the
    port: ``montecarlo_tpu.__all__``, the ``__all__`` of each model module
    and of ``core/wanglandau.py``, with the same names of functions and
    classes; the port's own extras are ``interop`` and the device
    helpers."""
    from montecarlo_tpu.core import wanglandau as ref_wl
    from montecarlo_tpu_torch.core import wanglandau
    assert set(tmc.__all__) - {"interop"} == set(mc.__all__)
    assert set(tmc.models.__all__) == set(mc.models.__all__)
    pairs = [(tmc, mc), (wanglandau, ref_wl)] + [
        (getattr(tmc.models, name), getattr(mc.models, name))
        for name in mc.models.__all__]
    for mine, ref in pairs:
        missing = [n for n in ref.__all__ if not hasattr(mine, n)]
        assert not missing, (ref.__name__, missing)
        for name in ref.__all__:
            theirs = getattr(ref, name)
            if isinstance(theirs, type) or callable(theirs) and hasattr(
                    theirs, "__name__"):
                assert getattr(mine, name).__name__ == theirs.__name__, (
                    ref.__name__, name)
