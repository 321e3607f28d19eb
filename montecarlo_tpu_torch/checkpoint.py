"""Checkpoint save/restore for the full device state.

Port of ``montecarlo_tpu/checkpoint.py``.  The reference's ``StoreBackups``
writes restart text files with no loader (``src/algorithms.jl:264-303``);
here the complete device state — chains, generators, acceptance counters,
move parameters, the PGMC accumulators and the step counter — round-trips
through one ``.npz`` file with a JSON ``__meta__`` entry, so a run can
resume exactly.

A ``torch.Generator`` is stored as its ``get_state()`` bytes and its
device, and restored with ``set_state`` on a new generator of that device;
the Python-int step counter is stored as an int64 and restored as an int.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from .utils.tree import tree_leaves_with_path, tree_map

__all__ = ["save", "restore", "resume_state"]

_GEN_MARK = "__generator__"
_INT_MARK = "__int__"


def save(path: str, dstate: Any) -> None:
    """Serialise a device-state tree to ``path`` (.npz), written whole to
    a temporary file beside it and moved into place, so a process killed
    meanwhile leaves no cut checkpoint under that name."""
    arrays, meta = {}, {}
    for i, (keys, leaf) in enumerate(tree_leaves_with_path(dstate)):
        name = f"leaf_{i}"
        entry = {"path": "/".join(str(k) for k in keys)}
        if isinstance(leaf, torch.Generator):
            arrays[name] = leaf.get_state().numpy()
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
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def restore(path: str, like: Any) -> Any:
    """Rebuild a device-state tree from ``path``, using ``like`` (a tree of
    the same structure, e.g. ``Simulation.init_device_state()``) as the
    template: tensors go to the device of ``like``'s leaf."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        arrays = {k: data[k] for k in data.files}
    n = len(tree_leaves_with_path(like))
    if n != len(meta):
        raise ValueError(f"checkpoint {path} holds {len(meta)} leaves, the "
                         f"template {n}")
    counter = iter(range(n))

    def load(leaf):
        name = f"leaf_{next(counter)}"
        arr, entry = arrays[name], meta[name]
        if _GEN_MARK in entry:
            gen = torch.Generator(device=entry[_GEN_MARK])
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
    continues from the checkpointed step."""
    dstate = restore(path, simulation.init_device_state())
    simulation.device_state = dstate
    simulation.t = int(dstate["t"])
