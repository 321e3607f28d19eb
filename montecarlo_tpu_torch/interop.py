"""Chain state carried between the JAX package and this one.

The particle models' ``init_chains`` (particle-1d, Lennard-Jones,
polydisperse, hard disks) draw from the reference's threefry stream, so
both packages make the same chains from the same seed.  To run both from
any other state (the lattice models' initial chains, a state one package
has advanced), one's chains are carried over to the other as numpy arrays;
the reference's per-chain keys are carried by :func:`keys_from_reference`.
Nothing here imports ``jax``: the JAX side converts its arrays with
``np.asarray`` (keys with ``jax.random.key_data``).

Every family is carried: particle-1d (``x``, ``beta``, ``e``),
Lennard-Jones (``pos``, ``species``, ``beta``, ``energy``, ``box``),
polydisperse soft spheres (``pos``, ``diam``, ``beta``, ``energy``,
``box``), hard disks or spheres (``pos``, ``box``), the lattice states of
the 1-D and 2-D Ising and Potts models and of the Heisenberg model
(``spins``, ``beta``, ``j``, ``energy``), the XY model (``theta``,
``beta``, ``j``, ``energy``) and the transverse-field Ising model
(``spins``, ``kx``, ``ktau``, ``energy``); the particle families in 2-D or
3-D, the dimension being the last axis of ``pos``.  The states with a
``spins`` field are told apart by the class named (``cls=``) rather than by
the fields.

Device-state slices are carried too (:func:`slice_from_reference`,
:func:`slice_to_reference`): the ``ecmc`` slice of ``EventChain`` (``lift``,
``stats``, ``n_events``), the ``replica_exchange`` slice (``calls``,
``counters``) and the ``wang_landau`` slice (``log_g``, ``hist``,
``visited``, ``log_f``).  A slice's threefry keys stay the port's own
(from the same seed they are the reference's).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .core.algorithms import to_numpy
from .models.hard_disks import HardDiskState
from .models.heisenberg import HeisenbergState
from .models.ising import IsingState
from .models.ising2d import Ising2DState
from .models.lennard_jones import LJState
from .models.particle1d import Particle1DState
from .models.polydisperse import PolyState
from .models.potts import PottsState
from .models.tfim import TFIMState
from .models.xy import XYState
from .utils.device import resolve_device
from .utils.tree import tree_map

__all__ = ["chains_from_reference", "chains_to_reference",
           "keys_from_reference", "keys_to_reference",
           "slice_from_reference", "slice_to_reference"]

_LATTICE = ("spins", "beta", "j", "energy")
_FIELDS = {Particle1DState: ("x", "beta", "e"),
           LJState: ("pos", "species", "beta", "energy", "box"),
           PolyState: ("pos", "diam", "beta", "energy", "box"),
           HardDiskState: ("pos", "box"),
           IsingState: _LATTICE, Ising2DState: _LATTICE,
           PottsState: _LATTICE, HeisenbergState: _LATTICE,
           XYState: ("theta", "beta", "j", "energy"),
           TFIMState: ("spins", "kx", "ktau", "energy")}
_DTYPES = {"species": np.int32, "spins": np.int8}

#: the tensors of a device-state slice that are carried, by state key
_SLICES = {"ecmc": ("lift", "stats", "n_events"),
           "replica_exchange": ("calls", "counters"),
           "wang_landau": ("log_g", "hist", "visited", "log_f")}


def chains_from_reference(np_state, device=None, cls=None):
    """The JAX package's chains, given as a mapping (or an object with
    attributes) of chain-stacked arrays, as this package's state on
    ``device`` (the card, ``cuda``, when None).

    ``cls`` names the state class; it must be named for the states with a
    ``spins`` field (:class:`IsingState`, :class:`Ising2DState`,
    :class:`PottsState`, :class:`HeisenbergState`, :class:`TFIMState`).
    Without it the class is told apart by the fields: a :class:`PolyState`
    when there is a ``diam`` field, an :class:`LJState` when there is a
    ``species`` field, a :class:`HardDiskState` when there is a ``pos``
    field and neither of those, an :class:`XYState` when there is a
    ``theta`` field, a :class:`Particle1DState` when there is an ``x``
    field.  Species stay int32 and spins int8 (the Heisenberg spins
    float32); everything else becomes float32."""
    if isinstance(np_state, Mapping):
        get, has = np_state.__getitem__, np_state.__contains__
    else:
        get = lambda k: getattr(np_state, k)
        has = lambda k: hasattr(np_state, k)
    device = resolve_device(device)
    if cls is None:
        if has("spins"):
            raise ValueError(
                "the lattice states with a spins field are not told apart "
                "by their fields: name the class (cls=IsingState, "
                "Ising2DState, PottsState, HeisenbergState or TFIMState)")
        cls = (PolyState if has("diam") else LJState if has("species")
               else HardDiskState if has("pos") else XYState if has("theta")
               else Particle1DState)
    elif cls not in _FIELDS:
        raise ValueError(f"no carried state class {cls!r}")
    dtypes = {} if cls is HeisenbergState else _DTYPES
    return cls(**{
        k: torch.as_tensor(np.array(get(k), dtype=dtypes.get(k, np.float32)),
                           device=device)
        for k in _FIELDS[cls]})


def chains_to_reference(state) -> dict:
    """The inverse: the state's fields as numpy arrays, for the JAX
    package's state class of the same name (``Particle1DState(**...)``,
    ``Ising2DState(**...)`` and so on)."""
    return {k: getattr(state, k).detach().cpu().numpy()
            for k in _FIELDS[type(state)]}


def keys_from_reference(key_data, device=None) -> torch.Tensor:
    """The reference's keys, given as their ``jax.random.key_data`` (a
    ``(..., 2)`` uint32 array), as this package's keys
    (:mod:`~montecarlo_tpu_torch.utils.prng`) on ``device`` (the card,
    ``cuda``, when None): the same words, so the same draws."""
    data = np.asarray(key_data)
    if data.dtype != np.uint32 or data.ndim < 1 or data.shape[-1] != 2:
        raise ValueError(f"expected (..., 2) uint32 key data, got "
                         f"{data.shape} {data.dtype}")
    return torch.as_tensor(data.copy(), device=resolve_device(device))


def keys_to_reference(keys) -> np.ndarray:
    """The inverse: the keys' words as a uint32 numpy array, for
    ``jax.random.wrap_key_data``."""
    return keys.detach().cpu().numpy()


def slice_from_reference(key: str, np_slice, like):
    """The JAX package's device-state slice ``key`` (``"ecmc"``,
    ``"replica_exchange"`` or ``"wang_landau"``, a mapping of arrays and
    dicts of arrays) as this package's, on the devices and with the dtypes
    of ``like`` (the port's own slice, e.g.
    ``sim.init_device_state()[key]``), whose keys it keeps."""
    if key not in _SLICES:
        raise ValueError(f"no carried slice {key!r}; carried: "
                         f"{sorted(_SLICES)}")
    out = dict(like)
    for name in _SLICES[key]:
        out[name] = tree_map(
            lambda mine, ref: torch.as_tensor(np.array(ref)).to(
                device=mine.device, dtype=mine.dtype),
            like[name], np_slice[name])
    return out


def slice_to_reference(key: str, slc) -> dict:
    """The inverse: the carried tensors of the port's slice ``key`` as numpy
    arrays, the keys left out (the reference's are its own)."""
    if key not in _SLICES:
        raise ValueError(f"no carried slice {key!r}; carried: "
                         f"{sorted(_SLICES)}")
    return {name: to_numpy(slc[name]) for name in _SLICES[key]}
