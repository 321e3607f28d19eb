"""Chain state carried between the JAX package and this one.

The two packages draw initial chains from different generators, so to run
both from the same state, one's chains are carried over to the other as
numpy arrays.  Nothing here imports ``jax``: the JAX side converts its
arrays with ``np.asarray``.

Three families are carried: particle-1d (``x``, ``beta``, ``e``), 2-D
Lennard-Jones (``pos``, ``species``, ``beta``, ``energy``, ``box``) and 2-D
polydisperse soft spheres (``pos``, ``diam``, ``beta``, ``energy``,
``box``).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .models.lennard_jones import LJState
from .models.particle1d import Particle1DState
from .models.polydisperse import PolyState
from .utils.device import resolve_device

__all__ = ["chains_from_reference", "chains_to_reference"]

_FIELDS = {Particle1DState: ("x", "beta", "e"),
           LJState: ("pos", "species", "beta", "energy", "box"),
           PolyState: ("pos", "diam", "beta", "energy", "box")}
_INT_FIELDS = ("species",)


def chains_from_reference(np_state, device=None):
    """The JAX package's chains, given as a mapping (or an object with
    attributes) of chain-stacked arrays, as this package's state on
    ``device`` (the card, ``cuda``, when None), told apart by their fields: a
    :class:`PolyState` when there is a ``diam`` field, an :class:`LJState`
    when there is a ``species`` field, else a :class:`Particle1DState`.
    Labels stay int32, everything else becomes float32."""
    if isinstance(np_state, Mapping):
        get, has = np_state.__getitem__, np_state.__contains__
    else:
        get = lambda k: getattr(np_state, k)
        has = lambda k: hasattr(np_state, k)
    device = resolve_device(device)
    cls = (PolyState if has("diam") else LJState if has("species")
           else Particle1DState)
    return cls(**{
        k: torch.as_tensor(np.array(get(k), dtype=np.int32
                                    if k in _INT_FIELDS else np.float32),
                           device=device)
        for k in _FIELDS[cls]})


def chains_to_reference(state) -> dict:
    """The inverse: the state's fields as numpy arrays, for the JAX
    package's ``Particle1DState(**...)``, ``LJState(**...)`` or
    ``PolyState(**...)``."""
    return {k: getattr(state, k).detach().cpu().numpy()
            for k in _FIELDS[type(state)]}
