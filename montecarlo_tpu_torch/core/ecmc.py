"""Event-chain Monte Carlo — rejection-free, non-reversible sampling.

Port of ``montecarlo_tpu/core/ecmc.py``.  Instead of propose/accept/reject,
a *lifted* variable (an active particle plus a direction) moves
deterministically until an **event** — computed in closed form from an
exponential hazard draw or a hard-core collision — transfers the lifting.
Every move is accepted.

A model plugs in through :class:`EventChainModel` with two hooks over all
chains at once (every state leaf has a leading chain axis):

- ``init_lift(state, draws) -> lift`` — the initial lifting variables;
- ``event_step(state, lift, draws) -> (state', lift', stats)`` — advance
  every chain by one event and return a dict of *additive* per-chain
  statistics (ECMC expectations are time averages along the trajectory).

A hook takes its random numbers from ``draws`` (:class:`KeyEventDraws` in
a run), never from a global generator, so the tests can feed it any draws
and hold it value for value.

Where the reference runs one chain's event as a vmapped ``lax.while_loop``,
the port runs a batched loop over all chains (:func:`event_loop`): a chain
that is done is masked, and the loop's condition is read on the host only
every ``check_every`` iterations (each read waits for the card).  A masked
iteration is an exact no-op and the draws of iteration ``i`` do not depend
on how many iterations ran, so the result does not depend on
``check_every``.

Randomness, the reference's threefry keys (``utils/prng.py``): chain c
owns ``fold_in(fold_in(key(seed), 0x0EC3C), c)`` over the global chain
ids, its initial lift draws from ``fold_in(·, 0xF117)``, and step t splits
``fold_in(·, t)`` into one key an event.  A hook splits its event's key
as the reference's does; the soft-potential hooks' loop key splits anew
each iteration into the next loop key and the iteration's thresholds (one
launch on the card: ``utils/prng.py``'s ``split_uniform``).  A chain that
is done still advances its loop key, which it never reads again, so no
draw depends on the count of masked iterations, and one seed gives the
JAX package's events on any device and rank count.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from ..utils import prng
from ..utils.observability import count, span
from ..utils.tree import tree_map
from .algorithms import DeviceAlgorithm, SimView, _n_calls

__all__ = ["EventChainModel", "EventChain", "ecmc_callbacks",
           "KeyEventDraws", "event_loop"]

#: the smallest uniform a hook takes, the reference's ``minval``
TINY = float(np.finfo(np.float32).tiny)

#: iterations of an event loop between two reads of its condition: a read
#: waits for the card, an iteration past a loop's end is a few dozen
#: launches of wasted work
CHECK_EVERY = 4

#: the reference's tags of the chains' base key and of the initial lift
_ECMC_TAG = 0x0EC3C
_LIFT_TAG = 0xF117


@dataclasses.dataclass(frozen=True)
class EventChainModel:
    """The hooks a system supplies to run under event-chain MC."""

    init_lift: Callable[[Any, Any], Any]
    event_step: Callable[[Any, Any, Any], Any]
    name: str = "EventChainModel"


class KeyEventDraws:
    """One event's random numbers for every chain, from the chains' event
    keys ``keys`` (M, 2), as the reference's hooks derive them from their
    one chain's key:

    - ``start(n, dim)``: each chain's active particle in [0, n) and
      direction in [0, dim), two (M,) int64 tensors, ``randint`` of the
      first two keys of ``split(key, 3)`` (the hard disks' ``split(key)``
      gives the same two: a split's keys are the block at counts 0, 1, ..,
      whatever their number);
    - ``uniform(dtype)``: (M,) uniforms in [TINY, 1) from the key itself
      (the zig-zag's hazard draw);
    - ``bernoulli()``: (M,) bool, each True with probability 1/2, from the
      key itself (the zig-zag's initial direction);
    - ``thresholds(i, n)``: the (M, n) float32 uniforms in [TINY, 1) of
      iteration ``i`` of the event's loop, called for i = 0, 1, ... in
      turn: the loop key ``ku``, the third key of ``split(key, 3)``, splits
      each iteration, ``k, kthr = split(k)``, and the thresholds are
      ``uniform(kthr, (n,), minval=TINY)``."""

    def __init__(self, keys):
        self.keys = keys
        self._three = None
        self._loop = None
        self._next = 0

    def _split(self):
        if self._three is None:
            self._three = prng.split(self.keys, 3)
        return self._three

    def start(self, n: int, dim: int):
        k = self._split()
        return (prng.randint(k[:, 0], (), 0, n, dtype=torch.int64),
                prng.randint(k[:, 1], (), 0, dim, dtype=torch.int64))

    def uniform(self, dtype=torch.float32):
        return prng.uniform(self.keys, (), dtype, minval=TINY)

    def bernoulli(self):
        return prng.bernoulli(self.keys)

    def thresholds(self, i: int, n: int):
        if i != self._next:
            raise ValueError(f"thresholds of iteration {i} asked for after "
                             f"{self._next} iterations")
        if self._loop is None:
            self._loop = self._split()[:, 2]
        self._next += 1
        self._loop, u = prng.split_uniform(self._loop, (n,), minval=TINY)
        return u


def event_loop(body, carry, active, check_every: int = CHECK_EVERY):
    """Run ``carry = body(carry, i)`` for i = 0, 1, ... on the chains where
    ``active(carry)`` (an (M,) bool tensor) holds, until it holds for none.

    ``carry`` is a tuple of tensors with a leading chain axis.  Each
    iteration runs on every chain and keeps the new values where the chain
    was active: on a chain that is done an iteration changes nothing, so
    the condition is read on the host only every ``check_every``
    iterations and the result does not depend on ``check_every``."""
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    i = 0
    while True:
        for _ in range(check_every):
            with span("mc.ecmc.iteration"):
                act = active(carry)
                new = body(carry, i)
                carry = tuple(
                    torch.where(
                        act.reshape(act.shape + (1,) * (c.dim() - 1)), n, c)
                    for n, c in zip(new, carry))
            i += 1
        count("host_syncs")
        if not bool(torch.any(active(carry))):
            return carry


# -- what the straight-chain hooks share (hard disks, LJ, polydisperse) -------

class StraightChain:
    """One event's straight-chain geometry on every chain: each chain's
    axis ``d`` (M,) (its one-hot ``shift``), the particle indices and the
    box, computed once an event; what the loop needs of them, per
    iteration, one gather or a few elementwise operations each."""

    def __init__(self, pos, d, box):
        m, n, dim = pos.shape
        self.idx = torch.arange(n, device=pos.device)
        self.shift = (torch.arange(dim, device=pos.device)[None, :]
                      == d[:, None]).to(pos.dtype)
        self.box, self.boxe = box[:, None], box[:, None, None]
        self._along = d[:, None, None].expand(m, n, 1)
        self._pick = (m, 1, dim)

    def active(self, pos, a):
        """The (M, N) mask of each chain's active slot ``a``, its (M, dim)
        position and the (M, N, dim) displacements to every particle."""
        mask_a = self.idx[None, :] == a[:, None]
        p = torch.gather(pos, 1, a[:, None, None].expand(self._pick))[:, 0]
        return mask_a, p, pos - p[:, None, :]

    def along(self, v):
        """Each (M, N, dim) vector's component along its chain's axis."""
        return torch.gather(v, 2, self._along)[..., 0]

    def min_image(self, rel):
        return rel - self.boxe * torch.round(rel / self.boxe)

    def first_hit(self, s_j):
        """(min, lowest index attaining it) over each chain's (N,) event
        distances, robust against float ties (the reference's
        ``where(s == s_min, idx, n).min()``)."""
        s_min = torch.amin(s_j, dim=-1)
        n = s_j.shape[-1]
        j_star = torch.amin(torch.where(s_j == s_min[:, None], self.idx, n),
                            dim=-1)
        return s_min, j_star

    @staticmethod
    def at(x, j):
        """``x[c, j[c]]`` for every chain c."""
        return torch.gather(x, 1, j[:, None])[:, 0]

    def advance(self, pos, mask_a, p, s):
        """Move each chain's active particle by ``s`` along its axis,
        wrapped into the box."""
        new_p = torch.remainder(p + s[:, None] * self.shift, self.box)
        return torch.where(mask_a[..., None], new_p[:, None, :], pos)


def squared_norm(v):
    """Sum of squares over the last axis, left to right."""
    out = v[..., 0] * v[..., 0]
    for k in range(1, v.shape[-1]):
        out = out + v[..., k] * v[..., k]
    return out


def run_chain(body, pos0, a0, chain_length, max_events, check_every):
    """One straight event chain on every chain: ``body(carry, i)`` over the
    carry (positions, active particle, budget left, collisions,
    iterations, excess) from ``a0`` (M,) with a budget of
    ``chain_length``, while a chain has budget and fewer than
    ``max_events`` iterations (:func:`event_loop`).  Returns the
    positions and the chain's statistics: ``t`` (distance), ``chains``,
    ``collisions``, ``cap_hits`` (chains the cap cut short) and
    ``excess``."""
    m = pos0.shape[0]
    zeros = torch.zeros((m,), dtype=torch.int32, device=pos0.device)
    budget0 = torch.full((m,), chain_length, dtype=torch.float32,
                         device=pos0.device)

    def active(carry):
        _, _, budget, _, niter, _ = carry
        return (budget > 0.0) & (niter < max_events)

    pos, _, budget, ncoll, _, excess = event_loop(
        body, (pos0, a0, budget0, zeros, zeros, torch.zeros_like(budget0)),
        active, check_every)
    return pos, {"t": chain_length - budget,
                 "chains": torch.ones_like(ncoll),
                 "collisions": ncoll,
                 "cap_hits": (budget > 0.0).to(torch.int32),
                 "excess": excess}


def _first_chain(tree):
    return tree_map(lambda x: x[:1] if torch.is_tensor(x) and x.dim() else x,
                    tree)


class EventChain(DeviceAlgorithm):
    """Event-chain sampler over all chains, one device algorithm.

    Device-state slice (chain-major):

    - ``keys``: per-chain threefry keys, ``fold_in(fold_in(key(seed),
      0x0EC3C), chain)`` over the global chain ids (a mesh slices them
      with the chains);
    - ``lift``: per-chain lifting variables (model-defined dict);
    - ``stats``: per-chain additive statistics accumulated over every event
      (model-defined dict, zero-initialised with the shapes and dtypes one
      probe event on one chain gives);
    - ``n_events``: per-chain event counter (int32).
    """

    state_key = "ecmc"

    def __init__(self, sim, model: EventChainModel,
                 events_per_step: int = 1, seed: int = 13,
                 dependencies=(), **_):
        self.model = model
        self.events_per_step = int(events_per_step)
        self.seed = int(seed)
        self.n_chains = sim.n_chains
        self.device = sim.device

    def init_state(self, sim):
        base = prng.fold_in(prng.key(self.seed, self.device), _ECMC_TAG)
        keys = prng.fold_in(base[None],
                            torch.arange(self.n_chains, device=self.device))
        sys0 = sim.chains0
        lift = self.model.init_lift(
            sys0, KeyEventDraws(prng.fold_in(keys, _LIFT_TAG)))
        # zero stats with the model's own shapes: one probe event on one
        # chain, with the key of 0 (the reference's shape probe's)
        _, _, inc = self.model.event_step(
            _first_chain(sys0), _first_chain(lift),
            KeyEventDraws(prng.key(0, self.device)[None]))
        stats = {k: torch.zeros((self.n_chains,) + tuple(v.shape[1:]),
                                dtype=v.dtype, device=self.device)
                 for k, v in inc.items()}
        return {"keys": keys, "lift": lift, "stats": stats,
                "n_events": torch.zeros((self.n_chains,), dtype=torch.int32,
                                        device=self.device)}

    def step(self, dstate, t):
        slc = dstate[self.state_key]
        sys, lift, stats = dstate["sys"], slc["lift"], slc["stats"]
        # (M, events, 2): each event's key, split from the step's
        keys = prng.split(prng.fold_in(slc["keys"], int(t)),
                          self.events_per_step)
        for e in range(self.events_per_step):
            sys, lift, inc = self.model.event_step(
                sys, lift, KeyEventDraws(keys[:, e]))
            stats = {k: stats[k] + inc[k] for k in stats}
        return {**dstate, "sys": sys,
                self.state_key: {**slc, "lift": lift, "stats": stats,
                                 "n_events": slc["n_events"]
                                 + self.events_per_step}}

    def write_summary(self, io, scheduler):
        io.write("\tEventChain\n")
        io.write(f"\t\tCalls: {_n_calls(scheduler)}\n")
        io.write(f"\t\tModel: {self.model.name}\n")
        io.write(f"\t\tEvents per simulation step: {self.events_per_step}\n")
        io.write(f"\t\tSeed: {self.seed}\n")


def ecmc_callbacks(state_key: str = "ecmc"):
    """(callback_ecmc_events,) — the event count per chain.

    Every chain's counter rises by the same ``events_per_step``, so the
    counts are equal and their int32 minimum is exact up to 2^31 events (a
    float32 mean would lose integers past ~1.7e7)."""

    def events(view: SimView):
        return torch.min(view.state[state_key]["n_events"])

    events.__name__ = f"callback_{state_key}_events"
    return (events,)
