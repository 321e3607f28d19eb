"""Chain-axis sharding over ``torch.distributed`` ranks.

Port of ``montecarlo_tpu/parallel/mesh.py``.  In the JAX package a
``jax.sharding.Mesh`` lets XLA partition one program and its chain
reductions lower to ``psum``.  Here a mesh is one process per device: a
process group, this process's rank in it and the device its chains live on.

Every rank builds the same whole ensemble; :func:`shard_device_state` keeps
rank r's contiguous slice ``[r M/S, (r+1) M/S)`` of each leaf whose leading
dimension is the chain count M, the reference's rule, and leaves the rest
whole (move parameters, the step counter, the estimator's sums, replica
exchange's one key).  The per-chain threefry keys of every sampler are
such leaves: a rank holds the keys of its global chains (the cell path
folds its chains' global ids into a segment's key), so every path but
the fused row kernels' gives each chain the numbers of a one-process run,
on any rank count.  Each chain reduction is one explicit collective, at the place
of the reference's ``psum``: the estimator's sums (:meth:`Mesh.all_reduce`),
the observables, computed on the gathered view (:func:`fetch`), and the
checkpoint.

Collectives run on the group's backend: ``nccl`` takes the chains' CUDA
tensors, ``gloo`` host tensors.  A ``gloo`` group whose chains are on the
card (ranks sharing one GPU, which NCCL refuses) copies each CUDA tensor to
host memory and back around every collective, always, and
:func:`make_mesh` prints that it does.

:func:`run_emulated` runs S ranks as S threads of one process, their
collectives meeting in shared memory: the same slices, streams and sums as
an S-process run, against which the tests and ``chip_smoke.py`` hold it.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from ..utils.tree import tree_map, tree_map_with_path

__all__ = ["CHAIN_AXIS", "Mesh", "make_mesh", "shard_device_state", "fetch",
           "replicate", "run_emulated"]

CHAIN_AXIS = "chains"

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _zero_counts():
    return {"all_gather": 0, "all_gather_bytes": 0, "all_reduce": 0,
            "all_reduce_bytes": 0}


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place in a 1-D chain mesh.

    ``group`` is the ``torch.distributed`` process group (None for a
    one-rank mesh without one, whose collectives are the identity);
    ``device`` is where this rank's chains live.  ``sliced`` holds the tree
    paths of the leaves :func:`shard_device_state` sliced last, which
    :func:`fetch` gathers; ``counts`` the collectives issued and the bytes
    they returned."""

    rank: int
    size: int
    device: torch.device
    group: Any = None
    backend: Optional[str] = None
    axis: str = CHAIN_AXIS
    sliced: frozenset = frozenset()
    counts: dict = dataclasses.field(default_factory=_zero_counts)

    def _count(self, kind, t):
        self.counts[kind] += 1
        self.counts[kind + "_bytes"] += t.numel() * t.element_size()

    def _to_backend(self, t):
        """A copy of ``t`` the backend takes: on this rank's device under
        ``nccl``, in host memory otherwise; bool as uint8, the keys' uint32
        as int64."""
        dev = self.device if self.backend == "nccl" else torch.device("cpu")
        dtype = {torch.bool: torch.uint8, torch.uint32: torch.int64}.get(
            t.dtype, t.dtype)
        x = t.to(device=dev, dtype=dtype, copy=True)
        return x.contiguous()

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t``, concatenated along the chain axis in rank
        order."""
        if self.group is None:
            return t
        x = self._to_backend(t)
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        out = torch.cat(parts).to(device=t.device, dtype=t.dtype)
        self._count("all_gather", out)
        return out

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The ``op`` (``'sum'`` or ``'max'``) of every rank's ``t``, as a
        new tensor on ``t``'s device."""
        if self.group is None:
            return t
        x = self._to_backend(t)
        dist.all_reduce(x, _OPS[op], group=self.group)
        self._count("all_reduce", x)
        return x.to(device=t.device, dtype=t.dtype)

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``t`` on every rank."""
        if self.group is None:
            return t
        x = self._to_backend(t)
        dist.broadcast(x, dist.get_global_rank(self.group, 0),
                       group=self.group)
        return x.to(device=t.device, dtype=t.dtype)


def make_mesh(device=None, group=None, axis: str = CHAIN_AXIS) -> Mesh:
    """The mesh of this process: every rank of ``group`` (default: the
    initialised default group; none, and the mesh has one rank).

    ``device`` defaults to ``cuda:(local_rank % device_count)``, the local
    rank read from ``LOCAL_RANK`` (``torchrun`` sets it) or else the rank;
    name ``'cpu'`` for host chains.  An ``nccl`` group makes that device
    current.  Where the reference takes a device list, a torch mesh is
    always the whole group: one device per process."""
    if group is None and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        rank, size, backend = 0, 1, None
    else:
        rank = dist.get_rank(group)
        size = dist.get_world_size(group)
        backend = str(dist.get_backend(group))
    if device is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda",
                              local % max(torch.cuda.device_count(), 1))
    device = torch.device(device)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"an nccl group needs CUDA chains, not {device}")
        torch.cuda.set_device(device)
    elif backend is not None and device.type == "cuda":
        print(f"mesh: rank {rank} of {size}, chains on {device}, backend "
              f"{backend}: every collective copies its CUDA tensors to host "
              f"memory and back", flush=True)
    return Mesh(rank=rank, size=size, device=device, group=group,
                backend=backend, axis=axis)


def shard_device_state(dstate, mesh: Mesh, n_chains: int):
    """This rank's part of a device-state tree: each tensor leaf whose
    leading dimension is ``n_chains`` is cut to the rank's contiguous slice
    of ``n_chains / mesh.size`` chains; every other leaf is kept whole.  The
    paths of the sliced leaves are recorded in ``mesh.sliced``.

    ``n_chains`` must be a multiple of the mesh size (pad the chain count
    if needed: extra independent chains are free)."""
    if n_chains % mesh.size != 0:
        raise ValueError(
            f"n_chains={n_chains} not divisible by mesh size {mesh.size}; "
            "pad the chain count (extra independent chains are free)")
    m = n_chains // mesh.size
    lo = mesh.rank * m
    sliced = []

    def place(path, leaf):
        if torch.is_tensor(leaf) and leaf.dim() >= 1 \
                and leaf.shape[0] == n_chains:
            sliced.append(path)
            return leaf[lo:lo + m].clone()
        return leaf

    out = tree_map_with_path(place, dstate)
    mesh.sliced = frozenset(sliced)
    return out


def fetch(tree, mesh: Optional[Mesh]):
    """``tree`` with each leaf that :func:`shard_device_state` sliced
    gathered from every rank (tiled along the chain axis, on this rank's
    device); every other leaf passed through.  A collective: every rank
    calls it with a tree of the same structure.  Paths are those of the
    sharded state, so a subtree is fetched under its key
    (``fetch({'sys': ds['sys']}, mesh)``)."""
    if mesh is None:
        return tree
    return tree_map_with_path(
        lambda path, leaf: mesh.all_gather(leaf)
        if path in mesh.sliced and torch.is_tensor(leaf) else leaf, tree)


def replicate(tree, mesh: Mesh):
    """Every tensor leaf on this rank's device, holding rank 0's values."""
    return tree_map(lambda leaf: mesh.broadcast(leaf.to(mesh.device))
                    if torch.is_tensor(leaf) else leaf, tree)


# -- S ranks in one process ------------------------------------------------------

class _Rendezvous:
    """Where the threads of an emulated group meet: each puts its value in
    its slot, waits for the others, and reads every slot."""

    def __init__(self, size: int, timeout: float):
        self.barrier = threading.Barrier(size, timeout=timeout)
        self.slots = [None] * size

    def exchange(self, rank: int, value):
        self.slots[rank] = value
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()       # every slot read before the next exchange
        return out


@dataclasses.dataclass(eq=False)
class _ThreadMesh(Mesh):
    """A rank of an emulated group: collectives through a rendezvous, sums
    in rank order."""

    rendezvous: Optional[_Rendezvous] = None

    def all_gather(self, t):
        out = torch.cat(self.rendezvous.exchange(self.rank, t))
        self._count("all_gather", out)
        return out

    def all_reduce(self, t, op="sum"):
        parts = self.rendezvous.exchange(self.rank, t)
        out = parts[0].clone()
        for p in parts[1:]:
            out = out + p if op == "sum" else torch.maximum(out, p)
        self._count("all_reduce", out)
        return out

    def broadcast(self, t):
        return self.rendezvous.exchange(self.rank, t)[0].clone()


def run_emulated(fn: Callable[[Mesh], Any], size: int, device,
                 timeout: float = 600.0) -> List[Any]:
    """Run ``fn(mesh)`` for each rank of a ``size``-rank mesh on ``device``,
    one thread per rank of this process, and return the ``size`` results in
    rank order.  Collectives meet in shared memory (sums in rank order); a
    rank that raises breaks the others' waits, and its error is raised
    here.  Files are written by rank 0 only, as in a multi-process run."""
    rv = _Rendezvous(size, timeout)
    meshes = [_ThreadMesh(rank=r, size=size, device=torch.device(device),
                          backend="threads", rendezvous=rv)
              for r in range(size)]

    def call(mesh):
        try:
            return fn(mesh)
        except BaseException:
            rv.barrier.abort()
            raise

    with ThreadPoolExecutor(max_workers=size) as pool:
        futures = [pool.submit(call, m) for m in meshes]
        errors = [f.exception() for f in futures]
    first = next((e for e in errors
                  if e is not None
                  and not isinstance(e, threading.BrokenBarrierError)),
                 next((e for e in errors if e is not None), None))
    if first is not None:
        raise first
    return [f.result() for f in futures]
