"""Chain state carried between the JAX package and this one.

The two packages draw initial chains from different generators, so to run
both from the same state, one's chains are carried over to the other as
numpy arrays.  Nothing here imports ``jax``: the JAX side converts its
arrays with ``np.asarray``.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .models.particle1d import Particle1DState

__all__ = ["chains_from_reference", "chains_to_reference"]

_FIELDS = ("x", "beta", "e")


def chains_from_reference(np_state, device=None) -> Particle1DState:
    """The JAX package's particle-1d chains, given as a mapping (or an
    object with attributes) ``x``, ``beta``, ``e`` of (M,) arrays, as this
    package's :class:`Particle1DState` on ``device`` (default CPU)."""
    get = np_state.__getitem__ if isinstance(np_state, Mapping) \
        else lambda k: getattr(np_state, k)
    return Particle1DState(**{
        k: torch.as_tensor(np.array(get(k), dtype=np.float32), device=device)
        for k in _FIELDS})


def chains_to_reference(state: Particle1DState) -> dict:
    """The inverse: ``{"x", "beta", "e"}`` as float32 numpy arrays, for
    ``montecarlo_tpu.models.particle1d.Particle1DState(**...)``."""
    return {k: getattr(state, k).detach().cpu().numpy() for k in _FIELDS}
