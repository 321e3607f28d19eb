"""Replica exchange (parallel tempering) over the chain axis.

Port of ``montecarlo_tpu/core/tempering.py``.  Chains are **ladder-major**:
chain ``c`` is replica ``c % n_temps`` of ladder ``c // n_temps``, and each
replica owns a fixed ensemble (its ``beta`` and any other named field).  A
swap exchanges *configurations* between neighbouring replicas of one
ladder, never the ensemble fields, so every recorder keeps observing a
fixed-temperature chain.

Acceptance: for neighbours (i, j), with ``lt`` the system's log target,

    log alpha = lt(beta_i, x_j) + lt(beta_j, x_i)
                - lt(beta_i, x_i) - lt(beta_j, x_j)

evaluated through ``SystemDef.log_target`` on hybrid states (own ensemble,
partner configuration); with cached energies in the state this is O(1) a
chain.  Even and odd neighbour pairings alternate with the algorithm's own
call count.

Randomness, the reference's: the slice holds the threefry key
``key(seed)`` (``utils/prng.py``), and the call at step t draws the whole
ensemble's M uniforms from ``fold_in(key, t)``, alike on every rank; both
members of a pair read the one drawn at the pair's low index, so the two
members of a pair that straddles a rank boundary decide alike on both
ranks, and one seed gives the JAX package's swaps.  On a chain mesh each
rank gathers the ensemble's configurations (one all-gather per leaf),
swaps the whole ensemble and keeps its slice.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..parallel.mesh import fetch
from ..utils import prng
from ..utils.device import resolve_device
from ..utils.tree import tree_map
from .algorithms import DeviceAlgorithm, SimView, _n_calls
from .moves import tree_select

__all__ = ["ReplicaExchange", "tile_ladder", "callback_swap_rate"]


def tile_ladder(values: Sequence[float], n_ladders: int,
                dtype=torch.float32, device=None) -> torch.Tensor:
    """Per-chain ensemble values for ``n_ladders`` copies of a temperature
    ladder, in the ladder-major layout :class:`ReplicaExchange` expects:
    ``out[c] = values[c % len(values)]``; on ``device``, the card
    (``cuda``) when it is None."""
    return torch.as_tensor(values, dtype=dtype,
                           device=resolve_device(device)).repeat(n_ladders)


def _replace_fields(dst, src, names):
    """``dst`` with the named top-level fields taken from ``src``
    (dataclass states via ``dataclasses.replace``, dict states via merge)."""
    if dataclasses.is_dataclass(dst):
        return dataclasses.replace(
            dst, **{n: getattr(src, n) for n in names})
    if isinstance(dst, dict):
        return {**dst, **{n: src[n] for n in names}}
    raise TypeError(
        "ReplicaExchange needs a dataclass or dict chain state to isolate "
        f"ensemble fields; got {type(dst).__name__}")


def partner_permutations(n_chains: int, n_temps: int) -> np.ndarray:
    """(2, M) partner of each chain under the even (row 0) and odd (row 1)
    pairings; a chain without a partner is its own."""
    idx = np.arange(n_chains)
    k = idx % n_temps
    perms = []
    for parity in (0, 1):
        partner = idx.copy()
        lo = (k % 2 == parity) & (k + 1 < n_temps)
        partner[lo] = idx[lo] + 1
        hi = (k >= 1) & ((k - 1) % 2 == parity)
        partner[hi] = idx[hi] - 1
        perms.append(partner)
    return np.stack(perms)


def swap(state, partner, u, log_target, ensemble_fields, n_temps):
    """One exchange over the whole ensemble: chain c and ``partner[c]`` swap
    configurations where ``log(u[min(c, partner[c])]) < log alpha``.

    Returns the new state and the (n_temps - 1, 2) int32 increments of
    (accepted, attempted) swaps per neighbouring pair, summed over
    ladders."""
    m = partner.shape[0]
    idx = torch.arange(m, device=partner.device)
    active = partner != idx
    # hybrid = the partner's configuration under my ensemble
    swapped = tree_map(lambda x: x[partner], state)
    hybrid = _replace_fields(swapped, state, ensemble_fields)
    lt_self = log_target(state)
    lt_hyb = log_target(hybrid)
    dlog = lt_hyb + lt_hyb[partner] - lt_self - lt_self[partner]
    # one decision per pair: both members read the uniform at the low index
    pair_lo = torch.minimum(idx, partner)
    accept = active & (torch.log(u[pair_lo]) < dlog)
    new_state = tree_select(accept, hybrid, state)

    is_lo = partner > idx                      # count each pair once
    pair_id = pair_lo % n_temps                # in [0, n_temps - 2] if is_lo
    inc = torch.stack([(accept & is_lo).to(torch.int32),
                       is_lo.to(torch.int32)], dim=-1)
    counts = torch.zeros((n_temps, 2), dtype=torch.int32,
                         device=partner.device)
    counts.index_add_(0, pair_id, inc)
    return new_state, counts[:n_temps - 1]


class ReplicaExchange(DeviceAlgorithm):
    """Even/odd neighbour swaps between the replicas of each ladder.

    Parameters
    ----------
    n_temps:
        Ladder length T; ``sim.n_chains`` must be a multiple of it
        (M = ladders × T, ladder-major).
    ensemble_fields:
        Top-level state fields that define a replica's ensemble and do not
        travel with the configuration (default ``("beta",)``).
    seed:
        Seed of the swap decisions' key.

    Device state: ``key`` (the (1, 2) threefry key of ``seed``),
    ``calls`` (the pairing parity counts these) and ``counters`` of shape
    ``(n_temps - 1, 2)``: (accepted, attempted) swaps per neighbouring
    pair, summed over ladders.
    """

    state_key = "replica_exchange"

    def __init__(self, sim, n_temps: int,
                 ensemble_fields: Sequence[str] = ("beta",),
                 seed: int = 7, dependencies=(), **_):
        if sim.system.log_target is None:
            raise ValueError(
                "ReplicaExchange requires SystemDef.log_target")
        if n_temps < 2:
            raise ValueError("n_temps must be >= 2")
        if sim.n_chains % n_temps:
            raise ValueError(
                f"n_chains={sim.n_chains} not a multiple of n_temps={n_temps}")
        self.n_temps = int(n_temps)
        self.ensemble_fields = tuple(ensemble_fields)
        self.seed = int(seed)
        self.n_chains = sim.n_chains
        self.device = sim.device
        self.mesh = getattr(sim, "mesh", None)
        self.log_target = sim.system.log_target
        self._perms = torch.as_tensor(
            partner_permutations(self.n_chains, self.n_temps),
            device=self.device)

    def init_state(self, sim):
        return {
            # (1, 2): a key with no chain axis, which a mesh keeps whole
            "key": prng.key(self.seed, self.device)[None],
            "calls": torch.zeros((), dtype=torch.int32),
            "counters": torch.zeros((self.n_temps - 1, 2), dtype=torch.int32,
                                    device=self.device),
        }

    def step(self, dstate, t):
        slc = dstate[self.state_key]
        # the parity counts calls, not steps: a strided schedule (a swap
        # every 2 steps) must still alternate the pairings
        calls = int(slc["calls"])
        partner = self._perms[calls % 2]
        state = dstate["sys"]
        if self.mesh is not None:
            state = fetch({"sys": state}, self.mesh)["sys"]
        # the whole ensemble's M uniforms, drawn alike on every rank
        u = prng.uniform(prng.fold_in(slc["key"], int(t)),
                         (self.n_chains,))[0]
        new_state, inc = swap(state, partner, u, self.log_target,
                              self.ensemble_fields, self.n_temps)
        if self.mesh is not None:
            m = self.n_chains // self.mesh.size
            lo = self.mesh.rank * m
            new_state = tree_map(lambda x: x[lo:lo + m], new_state)
        return {**dstate, "sys": new_state,
                self.state_key: {**slc, "calls": slc["calls"] + 1,
                                 "counters": slc["counters"] + inc}}

    def write_summary(self, io, scheduler):
        io.write("\tReplicaExchange\n")
        io.write(f"\t\tCalls: {_n_calls(scheduler)}\n")
        io.write(f"\t\tLadder length: {self.n_temps}\n")
        io.write(f"\t\tLadders: {self.n_chains // self.n_temps}\n")
        io.write(f"\t\tEnsemble fields: {list(self.ensemble_fields)}\n")
        io.write(f"\t\tSeed: {self.seed}\n")


def callback_swap_rate(view: SimView):
    """Mean swap acceptance over all neighbouring temperature pairs."""
    counters = view.state["replica_exchange"]["counters"]
    acc = counters[..., 0].to(torch.float32)
    tot = counters[..., 1].to(torch.float32)
    return torch.sum(acc) / torch.clamp(torch.sum(tot), min=1.0)
