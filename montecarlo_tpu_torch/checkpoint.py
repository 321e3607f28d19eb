"""Checkpoint save/restore for the full device state.

Port of ``montecarlo_tpu/checkpoint.py``.  The reference's ``StoreBackups``
writes restart text files with no loader (``src/algorithms.jl:264-303``);
here the complete device state — chains, the per-chain threefry keys,
acceptance counters, move parameters, the PGMC accumulators and the step
counter — round-trips through one ``.npz`` file with a JSON ``__meta__``
entry, so a run can resume exactly.

Keys are uint32 tensors and are stored as uint32 data, as the reference
stores ``jax.random.key_data`` (``montecarlo_tpu/checkpoint.py:55-56``);
the Python-int step counter is stored as an int64 and restored as an int.
Every random stream of the package is such a key, so a device state is
whole in its file.

On a chain mesh saving is collective (the reference's all-gather): the
sliced leaves are gathered whole, the rank count is noted as
``__mesh_size__`` and rank 0 writes the file.  A checkpoint
resumes on any rank count, with a mesh or without, each rank taking its
slice of the chains and their keys, as the reference's resumes on any mesh
(``montecarlo_tpu/checkpoint.py:91-94``).  A file written by an earlier
version of the package that held a generator's state (its marked
entries) cannot continue that stream on keys, and restoring it raises.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from .parallel.mesh import fetch, shard_device_state
from .utils.tree import tree_leaves_with_path, tree_map

__all__ = ["save", "restore", "resume_state"]

_INT_MARK = "__int__"
_MESH_SIZE = "__mesh_size__"
#: how earlier versions marked a stored generator's state
_GENERATOR_ENTRY = "__generator__"


def save(path: str, dstate: Any, mesh=None) -> None:
    """Serialise a device-state tree to ``path`` (.npz), written whole to
    a temporary file beside it and moved into place, so a process killed
    meanwhile leaves no cut checkpoint under that name.

    With ``mesh`` a collective: every rank calls it, rank 0 writes."""
    arrays, meta = {}, {}
    if mesh is not None:
        dstate = fetch(dstate, mesh)
        arrays[_MESH_SIZE] = np.asarray(mesh.size, np.int64)
    for i, (keys, leaf) in enumerate(tree_leaves_with_path(dstate)):
        name = f"leaf_{i}"
        entry = {"path": "/".join(str(k) for k in keys)}
        if torch.is_tensor(leaf):
            arrays[name] = leaf.detach().cpu().numpy()
        elif isinstance(leaf, int) and not isinstance(leaf, bool):
            arrays[name] = np.asarray(leaf, np.int64)
            entry[_INT_MARK] = True
        else:
            arrays[name] = np.asarray(leaf)
        meta[name] = entry
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                       dtype=np.uint8)
    if mesh is not None and mesh.rank != 0:
        return
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def restore(path: str, like: Any, mesh=None) -> Any:
    """Rebuild a device-state tree from ``path``, using ``like`` (a tree of
    the same structure, e.g. ``Simulation.init_device_state()``) as the
    template: tensors go to the device of ``like``'s leaf.

    The tree comes back whole (``mesh`` is accepted for symmetry with
    :func:`save`; any rank count restores any file).  A file that holds a
    generator's state, from an earlier version, raises ``ValueError``."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        arrays = {k: data[k] for k in data.files}
    held = [e["path"] for e in meta.values() if _GENERATOR_ENTRY in e]
    if held:
        raise ValueError(
            f"checkpoint {path} holds generator states ({held}), "
            f"written by an earlier version of the package: its samplers "
            f"now draw from threefry keys, and a generator's stream cannot "
            f"be continued on them; restart the run from its chains")
    n = len(tree_leaves_with_path(like))
    if n != len(meta):
        raise ValueError(f"checkpoint {path} holds {len(meta)} leaves, the "
                         f"template {n}")
    counter = iter(range(n))

    def load(leaf):
        name = f"leaf_{next(counter)}"
        arr, entry = arrays[name], meta[name]
        if entry.get(_INT_MARK):
            return int(arr)
        if torch.is_tensor(leaf):
            return torch.as_tensor(arr).to(leaf.device)
        return arr

    return tree_map(load, like)


def resume_state(simulation, path: str) -> None:
    """Load a checkpoint into ``simulation`` so that its next ``run``
    continues from the checkpointed step; on a mesh each rank takes its
    slice of the chains (with their keys)."""
    mesh = simulation.mesh
    dstate = restore(path, simulation.init_device_state(), mesh=mesh)
    if mesh is not None:
        dstate = shard_device_state(dstate, mesh, simulation.n_chains)
    simulation.device_state = dstate
    simulation.t = int(dstate["t"])
