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

A hook takes its random numbers from ``draws`` (:class:`GeneratorEventDraws`
in a run), never from a global generator, so the tests can feed it the
reference's own threefry draws and hold it value for value.

Where the reference runs one chain's event as a vmapped ``lax.while_loop``,
the port runs a batched loop over all chains (:func:`event_loop`): a chain
that is done is masked, and the loop's condition is read on the host only
every ``check_every`` iterations (each read waits for the card).  A masked
iteration is an exact no-op and the draws of iteration ``i`` do not depend
on how many iterations ran, so the result does not depend on
``check_every``.

Randomness: each :class:`EventChain` owns one ``torch.Generator`` on the
chains' device, seeded with ``seed`` (the rank folded in on a chain mesh,
as ``Metropolis.stream_seed`` folds it), which gives each event its start
(particle, direction) and the zig-zag's hazard draws; the per-iteration
thresholds of the soft-potential hooks come from a generator of their own
per event, seeded from (seed, step, event) on the host by a counter-based
generator, so the count of masked iterations never shifts a later draw.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from ..utils.tree import tree_map
from .algorithms import DeviceAlgorithm, SimView, _n_calls

__all__ = ["EventChainModel", "EventChain", "ecmc_callbacks",
           "GeneratorEventDraws", "event_loop"]

#: the smallest uniform a hook takes, the reference's ``minval``
TINY = float(np.finfo(np.float32).tiny)

#: iterations of an event loop between two reads of its condition: a read
#: waits for the card, an iteration past a loop's end is a few dozen
#: launches of wasted work
CHECK_EVERY = 4

_ECMC_TAG = 0x0EC3C


@dataclasses.dataclass(frozen=True)
class EventChainModel:
    """The hooks a system supplies to run under event-chain MC."""

    init_lift: Callable[[Any, Any], Any]
    event_step: Callable[[Any, Any, Any], Any]
    name: str = "EventChainModel"


class GeneratorEventDraws:
    """One event's random numbers for ``m`` chains.

    - ``start(n, dim)``: each chain's active particle in [0, n) and
      direction in [0, dim), two (M,) int64 tensors;
    - ``uniform()``: (M,) float32 uniforms in [TINY, 1);
    - ``bernoulli()``: (M,) bool, each True with probability 1/2;
    - ``thresholds(i, n)``: the (M, n) float32 uniforms in [TINY, 1) of
      iteration ``i`` of the event's loop, called for i = 0, 1, ... in turn.

    ``start``, ``uniform`` and ``bernoulli`` draw from ``generator``; the
    thresholds from a generator of their own, seeded with ``sub_seed`` at
    their first call."""

    def __init__(self, generator, sub_seed: int, m: int, device):
        self.generator = generator
        self.sub_seed = int(sub_seed)
        self.m = int(m)
        self.device = torch.device(device)
        self._sub = None
        self._next = 0

    def start(self, n: int, dim: int):
        a0 = torch.randint(0, n, (self.m,), generator=self.generator,
                           device=self.device)
        d = torch.randint(0, dim, (self.m,), generator=self.generator,
                          device=self.device)
        return a0, d

    def uniform(self):
        return torch.rand((self.m,), generator=self.generator,
                          device=self.device).clamp_(min=TINY)

    def bernoulli(self):
        return torch.rand((self.m,), generator=self.generator,
                          device=self.device) < 0.5

    def thresholds(self, i: int, n: int):
        if i != self._next:
            raise ValueError(f"thresholds of iteration {i} asked for after "
                             f"{self._next} iterations")
        if self._sub is None:
            self._sub = torch.Generator(device=self.device).manual_seed(
                self.sub_seed)
        self._next += 1
        return torch.rand((self.m, n), generator=self._sub,
                          device=self.device).clamp_(min=TINY)


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
            act = active(carry)
            new = body(carry, i)
            carry = tuple(
                torch.where(act.reshape(act.shape + (1,) * (c.dim() - 1)),
                            n, c)
                for n, c in zip(new, carry))
            i += 1
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


def sub_seed(seed: int, t: int, event: int) -> int:
    """The seed of the thresholds' generator of event ``event`` of step
    ``t``: counter-based (numpy's Philox keyed by (seed, t)), so a resumed
    run draws the same."""
    key = np.array([seed & (2 ** 64 - 1), t], np.uint64)
    rng = np.random.Generator(np.random.Philox(key=key))
    return int(rng.integers(0, 2 ** 63 - 1, size=event + 1)[event])


def _first_chain(tree):
    return tree_map(lambda x: x[:1] if torch.is_tensor(x) and x.dim() else x,
                    tree)


class EventChain(DeviceAlgorithm):
    """Event-chain sampler over all chains, one device algorithm.

    Device-state slice (chain-major):

    - ``generator``: the chains' ``torch.Generator`` (one per rank on a
      chain mesh, the rank folded into its seed);
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
        self.mesh = getattr(sim, "mesh", None)
        #: the seed of this rank's streams: ``seed`` itself without a mesh,
        #: else the rank folded in as ``Metropolis.stream_seed`` folds it
        self.stream_seed = self.seed
        if self.mesh is not None:
            from ..ops.fused_sweep import _shard_seed
            self.stream_seed = _shard_seed(self.mesh.rank, self.seed)

    def draws(self, generator, t: int, event: int, m: int):
        """The draws of event ``event`` of step ``t`` for ``m`` chains."""
        return GeneratorEventDraws(
            generator, sub_seed(self.stream_seed ^ _ECMC_TAG, t, event), m,
            self.device)

    def init_state(self, sim):
        gen = torch.Generator(device=self.device).manual_seed(
            self.stream_seed)
        sys0 = sim.chains0
        lift = self.model.init_lift(sys0, self.draws(gen, 0, 0,
                                                     self.n_chains))
        # zero stats with the model's own shapes: one probe event on one
        # chain, with draws of its own
        probe = torch.Generator(device=self.device).manual_seed(0)
        _, _, inc = self.model.event_step(
            _first_chain(sys0), _first_chain(lift),
            GeneratorEventDraws(probe, 0, 1, self.device))
        stats = {k: torch.zeros((self.n_chains,) + tuple(v.shape[1:]),
                                dtype=v.dtype, device=self.device)
                 for k, v in inc.items()}
        return {"generator": gen, "lift": lift, "stats": stats,
                "n_events": torch.zeros((self.n_chains,), dtype=torch.int32,
                                        device=self.device)}

    def step(self, dstate, t):
        slc = dstate[self.state_key]
        sys, lift, stats = dstate["sys"], slc["lift"], slc["stats"]
        m = slc["n_events"].shape[0]
        for e in range(self.events_per_step):
            sys, lift, inc = self.model.event_step(
                sys, lift, self.draws(slc["generator"], t, e, m))
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
