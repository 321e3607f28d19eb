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
        "import montecarlo_tpu_torch.policy_guided\n"
        "import montecarlo_tpu_torch.checkpoint\n"
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
