"""Checkpoint save/restore for the full device state.

Port of ``montecarlo_tpu/checkpoint.py``.  The reference's ``StoreBackups``
writes restart text files with no loader (``src/algorithms.jl:264-303``);
here the complete device state — chains, the per-chain threefry keys,
generators, acceptance counters, move parameters, the PGMC accumulators
and the step counter — round-trips through one ``.npz`` file with a JSON
``__meta__`` entry, so a run can resume exactly.

Keys are uint32 tensors and are stored as uint32 data, as the reference
stores ``jax.random.key_data`` (``montecarlo_tpu/checkpoint.py:55-56``).
A ``torch.Generator`` is stored as its ``get_state()`` bytes and its
device, and restored with ``set_state`` on a new generator of that device;
the Python-int step counter is stored as an int64 and restored as an int.

On a chain mesh saving is collective (the reference's all-gather): the
sliced leaves are gathered whole, each generator is stored as one state per
rank (an (S, bytes) array) and the rank count as ``__mesh_size__``, and
rank 0 writes the file.  A state without generators (the generic and
fused paths, PGMC) is whole in the file, so its checkpoint resumes on any
rank count, with a mesh or without, each rank taking its slice of the
chains and their keys, as the reference's resumes on any mesh
(``montecarlo_tpu/checkpoint.py:91-94``).  A state that holds generators
(the cell path, ECMC, the lattice samplers, Wang–Landau, replica exchange)
resumes on a mesh of the same rank count only, each rank taking its own
generators back; one written without a mesh resumes without one.
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

_GEN_MARK = "__generator__"
_INT_MARK = "__int__"
_MESH_SIZE = "__mesh_size__"


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
        if isinstance(leaf, torch.Generator):
            state = leaf.get_state()
            if mesh is not None:       # one state per rank, in rank order
                state = mesh.all_gather(state[None])
            arrays[name] = state.numpy()
            entry[_GEN_MARK] = str(leaf.device)
        elif torch.is_tensor(leaf):
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

    The tree comes back whole.  With ``mesh`` each generator is this rank's
    own, on the device of ``like``'s generator; a checkpoint that holds
    generators and was written by a mesh of another rank count, or with a
    mesh where none is given (or the other way round), raises.  One without
    generators restores on any mesh or none."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        arrays = {k: data[k] for k in data.files}
    saved = int(arrays[_MESH_SIZE]) if _MESH_SIZE in arrays else None
    want = None if mesh is None else mesh.size
    has_generators = any(_GEN_MARK in e for e in meta.values())
    if has_generators and saved != want:
        def ranks(n):
            return "no mesh" if n is None else f"a mesh of {n} rank(s)"
        raise ValueError(f"checkpoint {path} was written with {ranks(saved)} "
                         f"and resumes only so, not with {ranks(want)}")
    n = len(tree_leaves_with_path(like))
    if n != len(meta):
        raise ValueError(f"checkpoint {path} holds {len(meta)} leaves, the "
                         f"template {n}")
    counter = iter(range(n))

    def load(leaf):
        name = f"leaf_{next(counter)}"
        arr, entry = arrays[name], meta[name]
        if _GEN_MARK in entry:
            if mesh is not None:
                arr = arr[mesh.rank]
            gen = torch.Generator(device=leaf.device if mesh is not None
                                  else entry[_GEN_MARK])
            gen.set_state(torch.from_numpy(arr.copy()))
            return gen
        if entry.get(_INT_MARK):
            return int(arr)
        if torch.is_tensor(leaf):
            return torch.as_tensor(arr).to(leaf.device)
        return arr

    return tree_map(load, like)


def resume_state(simulation, path: str) -> None:
    """Load a checkpoint into ``simulation`` so that its next ``run``
    continues from the checkpointed step; on a mesh each rank takes back
    its slice of the chains (with their keys) and its own generators."""
    mesh = simulation.mesh
    dstate = restore(path, simulation.init_device_state(), mesh=mesh)
    if mesh is not None:
        dstate = shard_device_state(dstate, mesh, simulation.n_chains)
    simulation.device_state = dstate
    simulation.t = int(dstate["t"])
