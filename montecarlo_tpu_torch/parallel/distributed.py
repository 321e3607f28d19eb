"""Multi-process runtime helpers.

Port of ``montecarlo_tpu/parallel/distributed.py``.  Multi-process means:
``initialize`` once per process (a ``torch.distributed`` process group,
one process per device), a mesh over the group (:func:`global_mesh`),
chain-major leaves sliced per rank, and file output gated to rank 0
(:func:`is_io_host`), so the recorder tree is written once.
"""

from __future__ import annotations

import os
from typing import Optional

import torch.distributed as dist

from ..utils.device import resolve_device
from .mesh import CHAIN_AXIS, make_mesh

__all__ = ["initialize", "is_io_host", "process_count", "global_mesh"]


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device=None) -> None:
    """Initialise the default process group: a no-op when one is already
    initialised, or with no coordinator given or set in the environment
    (``MASTER_ADDR``, as ``torchrun`` sets it).

    ``coordinator_address`` is ``host:port`` (``tcp://`` rendezvous, with
    ``num_processes`` and ``process_id``); without it, ``env://``.  The
    backend is ``backend`` if named, else ``nccl`` for chains on ``cuda``
    (``device``, the card by default) and ``gloo`` for chains on the CPU."""
    if dist.is_initialized():
        return
    if coordinator_address is None and "MASTER_ADDR" not in os.environ:
        return
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    kw = {}
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
    if process_id is not None:
        kw["rank"] = int(process_id)
    init = (f"tcp://{coordinator_address}" if coordinator_address is not None
            else "env://")
    dist.init_process_group(backend, init_method=init, **kw)


def is_io_host() -> bool:
    """True on the process that owns file output: rank 0, or a process
    without a group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def global_mesh(axis: str = CHAIN_AXIS, device=None):
    """1-D mesh over every rank of the default group."""
    return make_mesh(device=device, axis=axis)
