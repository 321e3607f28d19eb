"""montecarlo_tpu_torch — the PyTorch/CUDA port of ``montecarlo_tpu``.

The same move/policy protocol, Metropolis–Hastings engine over many
independent chains and schedulable recorders as the JAX package, written in
PyTorch, with the JAX package's hot-path Pallas kernels rewritten by hand in
CUDA C++ for NVIDIA Hopper (``csrc/``).  Importing it needs neither ``jax``
nor ``nvcc``: each kernel is compiled at its first launch.

The public names are ``montecarlo_tpu``'s, with ``interop`` besides.  The
model families are ``montecarlo_tpu_torch.models``: particle-1d,
Lennard-Jones, polydisperse soft spheres and hard disks (2-D and 3-D), the
lattice models ``ising`` (1-D ring), ``ising2d`` and ``potts`` with their
checkerboard, Wolff and Swendsen-Wang samplers over
``montecarlo_tpu_torch.ops.cluster`` (connected-component labelling), the
continuous-spin ``xy`` and ``heisenberg`` models with checkerboard and
over-relaxation sweeps, and ``tfim``, the transverse-field Ising chain by
path-integral MC.  The checkerboard cell-MC path for large N is
``montecarlo_tpu_torch.ops.cell_mc``, which ``Metropolis(fused='cell')``
(or ``'auto'`` at large N) drives.
``EventChain`` (``core/ecmc.py``) runs event-chain MC on the particle
models' ``ecmc_model`` hooks, ``ReplicaExchange`` (``core/tempering.py``)
swaps configurations along temperature ladders, ``WangLandau``
(``core/wanglandau.py``) estimates densities of states, and ``analysis``
(``utils/analysis.py``) holds the time-series estimators.  These run in
plain PyTorch.  ``montecarlo_tpu_torch.parallel`` splits the chains over
``torch.distributed`` ranks (``Simulation(mesh=...)``).
"""

from .core.moves import Move, MoveDef, Policy, generic_apply, tree_select
from .core.system import SystemDef, stack_chains
from .core.metropolis import (Metropolis, StoreParameters, callback_acceptance,
                              mc_step, mc_sweep)
from .core.algorithms import (Algorithm, DeviceAlgorithm, HostAlgorithm,
                              ObservableRecorder, SimView, Format, TXT, DAT,
                              BIN, StoreCallbacks, StoreTrajectories,
                              load_chain_major_trajectories, StoreLastFrames,
                              StoreBackups, PrintTimeSteps)
from .core.simulation import Simulation, build_schedule, run
from .core.tempering import ReplicaExchange, callback_swap_rate, tile_ladder
from .core.wanglandau import (WangLandau, WangLandauModel, WangLandauRefine,
                              callback_wl_flatness, callback_wl_log_f,
                              wl_callbacks)
from .core.ecmc import EventChain, EventChainModel, ecmc_callbacks
from .utils.observability import ProfilerTrace, Throughput
from .utils import analysis
from . import checkpoint
from . import interop
from . import models
from . import parallel
from . import policy_guided

__version__ = "0.1.0"

__all__ = [
    "Move", "MoveDef", "Policy", "generic_apply", "tree_select",
    "SystemDef", "stack_chains",
    "Metropolis", "StoreParameters", "callback_acceptance",
    "mc_step", "mc_sweep",
    "Algorithm", "DeviceAlgorithm", "HostAlgorithm", "ObservableRecorder",
    "SimView", "Format", "TXT", "DAT", "BIN",
    "StoreCallbacks", "StoreTrajectories", "load_chain_major_trajectories",
    "StoreLastFrames", "StoreBackups", "PrintTimeSteps",
    "Simulation", "build_schedule", "run",
    "ReplicaExchange", "tile_ladder", "callback_swap_rate",
    "WangLandau", "WangLandauModel", "WangLandauRefine",
    "callback_wl_log_f", "callback_wl_flatness", "wl_callbacks",
    "EventChain", "EventChainModel", "ecmc_callbacks",
    "Throughput", "ProfilerTrace", "analysis", "checkpoint", "interop",
    "parallel", "policy_guided",
]
