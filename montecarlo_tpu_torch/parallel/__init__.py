"""Chain sharding over ``torch.distributed`` ranks (port of
``montecarlo_tpu.parallel``).  ``__all__`` is the reference's; ``fetch``,
``Mesh``, ``run_emulated`` and the runtime helpers of
:mod:`.distributed` are importable from here as well."""

from .mesh import (CHAIN_AXIS, Mesh, fetch, make_mesh, replicate,
                   run_emulated, shard_device_state)
from .distributed import global_mesh, initialize, is_io_host, process_count

__all__ = ["CHAIN_AXIS", "make_mesh", "replicate", "shard_device_state"]
