"""Move / Policy protocol — the user-extension surface of the framework.

Port of ``montecarlo_tpu/core/moves.py``.  A move is a bundle of plain
functions on chain-batched state: every state leaf carries a leading chain
axis, and ``apply``/``log_density``/``sample`` work on all chains at once.
Rejection is a ``torch.where`` select over the state rather than a
mutate-then-revert, and the cached energy rides inside the state so
delta-energies never recompute the full target density.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..utils.tree import tree_map

__all__ = [
    "Policy",
    "MoveDef",
    "MoveFamily",
    "Move",
    "tree_select",
    "generic_apply",
]


def tree_select(pred, on_true, on_false):
    """Elementwise select over two states of the same structure; ``pred`` is
    a (M,) bool tensor over chains, broadcast over each leaf's trailing
    axes."""

    def select(a, b):
        p = pred.reshape(pred.shape + (1,) * (a.dim() - pred.dim()))
        return torch.where(p, a, b)

    return tree_map(select, on_true, on_false)


class Policy:
    """Proposal distribution over actions (ref ``Policy``).

    Concrete policies implement two functions over all chains at once:

    - ``sample(params, key, state) -> action``: draw one action per chain,
      chain c's from its own key ``key[c]``: ``key`` is the ``(M, 2)``
      uint32 tensor of per-chain threefry keys, and the draws come from
      :mod:`montecarlo_tpu_torch.utils.prng`, whose functions take a batch
      of keys (``prng.normal(key, (d,))`` is ``(M, d)``), so a policy that
      draws as the reference's does per chain gives its numbers.
    - ``log_density(params, action, state) -> (M,) tensor``: log proposal
      density per chain.

    ``params`` is a dict (or other tree) of tensors shared by every chain,
    or, when a grouped pool gathers per-chain parameters, carrying a leading
    chain axis.
    """

    def sample(self, params, key, state):
        raise NotImplementedError(
            f"No sample is defined for {type(self).__name__}")

    def log_density(self, params, action, state):
        raise NotImplementedError(
            f"No log_density is defined for {type(self).__name__}")


@dataclasses.dataclass(frozen=True)
class MoveDef:
    """Static definition of a Monte Carlo move type.

    - ``apply(state, action) -> (new_state, delta_log_target)``.
    - ``invert(action, new_state) -> action``.
    - ``reward(action, new_state) -> tensor``: PGMC reward hook (optional).
    - ``kind``: structural tag (e.g. ``"gaussian_displacement_1d"``) by
      which the move's family recognises the pools its fast paths take.
    - ``aux``: static payload for fused kernels (e.g. the potential).
    - ``family``: the :class:`MoveFamily` of the module that made it.
    """

    name: str
    policy: Policy
    apply: Callable[[Any, Any], tuple]
    invert: Callable[[Any, Any], Any]
    reward: Optional[Callable[[Any, Any], Any]] = None
    kind: str = ""
    aux: Any = None
    family: Optional["MoveFamily"] = None


@dataclasses.dataclass(frozen=True, eq=False)
class MoveFamily:
    """A particle family's fast paths, declared once by the model module
    whose moves carry it: ``roles`` maps its kind tags to ``"disp"``,
    ``"swap"`` or ``"vol"`` (one displacement, at most one swap and one
    volume move take the cell path); ``row(pool, state0, mesh, interpret)``
    binds the row sweep of ``pool`` (``mesh``: ``(mesh, axis)`` or ``()``;
    the entry point is looked up on its ``ops`` module at each call) as
    ``run(sys, params, seed, micro_t0, n_steps) -> (sys', inc)``, ``inc``
    the (M, K, 2) counter increment, or gives None where no kernel (under
    ``interpret``, no plain version) takes it; ``cell(aux)`` gives the
    ``ops.cell_mc.CellModel`` of the displacement move's ``aux``."""

    roles: dict
    row: Optional[Callable] = None
    cell: Optional[Callable] = None


@dataclasses.dataclass
class Move:
    """A move in a pool: definition + parameters + selection weight.  The
    acceptance counters live in device state (``core/metropolis.py``)."""

    move: MoveDef
    params: Any
    weight: float


def generic_apply(perform: Callable, log_target: Callable) -> Callable:
    """Build a ``MoveDef.apply`` from a plain state transform and a target
    density: ``delta = log_target(new) - log_target(old)``."""

    def apply(state, action):
        new_state = perform(state, action)
        return new_state, log_target(new_state) - log_target(state)

    return apply
