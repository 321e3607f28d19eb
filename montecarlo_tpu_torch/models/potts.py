"""q-state Potts model on a periodic 2-D square lattice.

Port of ``montecarlo_tpu/models/potts.py``.  Hamiltonian
``E = -J * sum_<ij> delta(s_i, s_j)`` over nearest-neighbour bonds, int8
colours in ``{0, .., q-1}``; ``q = 2`` is Ising up to
``E_potts = (E_ising - 2 L^2 J) / 2``.  ``q`` is static: the move, the
system and the samplers close over it.

Sampling paths, mirroring ``models/ising2d.py``, each over all chains at
once (the colours are one (M, L1, L2) tensor):

- :func:`color_flip_move` — single-site recolouring through the generic
  move protocol (a uniform site, one of the other ``q - 1`` colours);
- :func:`CheckerboardPotts` — whole-lattice bipartite Metropolis sweeps;
- :func:`WolffPotts` and :func:`SwendsenWangPotts` — Fortuin-Kasteleyn
  cluster moves with bonds active at ``p = 1 - exp(-beta J)``.

The step functions take their random numbers as tensors (the tests feed
them the reference's draws); the samplers derive them from per-chain
threefry keys as the reference's do, on ``ising2d``'s
:class:`~montecarlo_tpu_torch.models.ising2d.LatticeSampler`.

Exact check: :func:`exact_moments` enumerates all ``q^(L^2)`` states of
tiny lattices.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.algorithms import _n_calls
from ..core.moves import Move, MoveDef, Policy
from ..core.system import SystemDef
from ..utils import prng
from ..utils.device import resolve_device
from .ising2d import (CheckerboardMetropolis, SwendsenWang, WolffCluster,
                      _require_even, bond_activation, fresh_by_label,
                      own_labels, parity_mask)

__all__ = ["PottsState", "make_system", "init_chains", "color_flip_move",
           "checkerboard_sweep", "CheckerboardPotts",
           "wolff_step", "swendsen_wang_step", "WolffPotts",
           "SwendsenWangPotts", "exact_moments",
           "callback_energy_per_spin", "callback_order_parameter"]


@dataclasses.dataclass(frozen=True)
class PottsState:
    """Chain-batched state; ``q`` is not a field (it is static)."""
    spins: torch.Tensor   # (M, L1, L2) int8 colours in {0, .., q-1}
    beta: torch.Tensor    # (M,)
    j: torch.Tensor       # (M,) coupling
    energy: torch.Tensor  # (M,) cached total energy


def _bond_matches(spins):
    """Per-site matches with the up and left neighbours; summed over the
    lattice this counts every nearest-neighbour bond once."""
    s = spins
    return ((s == torch.roll(s, 1, 1)).to(torch.float32)
            + (s == torch.roll(s, 1, 2)).to(torch.float32))


def _total_energy(spins, j):
    return -j * torch.sum(_bond_matches(spins), dim=(1, 2))


def _neighbour_matches(spins, colors):
    """For each site, how many of its 4 neighbours equal ``colors``."""
    s = spins
    return ((torch.roll(s, 1, 1) == colors).to(torch.float32)
            + (torch.roll(s, -1, 1) == colors).to(torch.float32)
            + (torch.roll(s, 1, 2) == colors).to(torch.float32)
            + (torch.roll(s, -1, 2) == colors).to(torch.float32))


def make_system(q: int) -> SystemDef:
    def log_target(state: PottsState):
        return -state.beta * state.energy

    def frame(state: PottsState):
        return {"e": state.energy, "m": _order_parameter(state.spins, q)}

    def format_frame(t, fr):
        return f"{t} {float(fr['m'])!r} {float(fr['e'])!r}"

    return SystemDef(name=f"Potts{q}", log_target=log_target, frame=frame,
                     format_frame=format_frame)


def init_chains(n_chains: int, size: int, q: int, beta: float,
                j: float = 1.0, seed: int = 42, device=None) -> PottsState:
    """Uniform random colours from ``key(seed)`` as the reference draws
    them (the same seed gives its chains), made on ``device``, the card
    (``cuda``) when it is None."""
    device = resolve_device(device)
    spins = prng.randint(prng.key(seed, device), (n_chains, size, size), 0,
                         q, dtype=torch.int8)
    full = lambda v: torch.full((n_chains,), v, dtype=torch.float32,
                                device=device)
    jj = full(j)
    return PottsState(spins=spins, beta=full(beta), j=jj,
                      energy=_total_energy(spins, jj))


def _other_color(r, old):
    """A uniform colour other than ``old`` from ``r`` uniform in [0, q-1)."""
    return r + (r >= old).to(r.dtype)


# ---------------------------------------------------------------------------
# Path 1: single-site recolouring through the generic move protocol
# ---------------------------------------------------------------------------

class UniformRecolor(Policy):
    """(site, new colour) uniform over L² sites × the (q-1) other colours:
    a symmetric proposal, so its log density cancels in the MH ratio."""

    def __init__(self, q: int):
        self.q = int(q)

    def sample(self, params, key, state):
        k_site, k_col = prng.split(key).unbind(-2)
        m, lx, ly = state.spins.shape
        site = prng.randint(k_site, (), 0, lx * ly, dtype=torch.int64)
        old = state.spins.reshape(m, -1).gather(1, site[:, None])[:, 0].to(
            torch.int64)
        r = prng.randint(k_col, (), 0, self.q - 1, dtype=torch.int64)
        return {"site": site, "color": _other_color(r, old).to(torch.int8)}

    def log_density(self, params, action, state):
        m, lx, ly = state.spins.shape
        return torch.full((m,), -float(np.log(np.float32(lx * ly
                                                         * (self.q - 1)))),
                          dtype=torch.float32, device=state.spins.device)


def color_flip_move(q: int, weight: float = 1.0) -> Move:
    def apply(state: PottsState, action):
        s = state.spins
        m, lx, ly = s.shape
        site, new = action["site"], action["color"]
        i, k = site // ly, site % ly
        rows = torch.arange(m, device=s.device)
        old = s[rows, i, k]
        nbs = (s[rows, (i - 1) % lx, k], s[rows, (i + 1) % lx, k],
               s[rows, i, (k - 1) % ly], s[rows, i, (k + 1) % ly])
        n_old = sum((nb == old).to(torch.float32) for nb in nbs)
        n_new = sum((nb == new).to(torch.float32) for nb in nbs)
        d_e = -state.j * (n_new - n_old)
        spins = s.clone()
        spins[rows, i, k] = new
        new_state = dataclasses.replace(
            state, spins=spins, energy=state.energy + d_e)
        return new_state, -state.beta * d_e

    def invert(action, new_state):
        # the proposal density depends only on (L², q): self-inverse in logq
        return action

    def reward(action, new_state):
        return torch.ones(action["site"].shape, dtype=torch.float32,
                          device=action["site"].device)

    md = MoveDef(name="PottsRecolor", policy=UniformRecolor(q), apply=apply,
                 invert=invert, reward=reward, kind="potts_recolor")
    return Move(move=md, params={"dummy": torch.zeros(())}, weight=weight)


# ---------------------------------------------------------------------------
# Path 2: checkerboard whole-lattice sweeps
# ---------------------------------------------------------------------------

def checkerboard_half_sweep(state: PottsState, q: int, parity: int, r, u):
    """Metropolis-recolour every site of one sublattice at once: each
    proposes the colour ``r`` (an (M, L1, L2) integer tensor in [0, q-1))
    names among its ``q - 1`` others and accepts with ``min(1,
    exp(-beta dE))`` against the uniforms ``u``.  Needs even lattice
    dimensions.  Returns ``(new_state, n_accepted)``."""
    s = state.spins
    _require_even(s.shape[1:], "checkerboard sweeps")
    mask = parity_mask(s.shape[1], s.shape[2], parity, s.device)
    prop = _other_color(r.to(torch.int32), s.to(torch.int32)).to(s.dtype)
    d_e = -state.j[:, None, None] * (_neighbour_matches(s, prop)
                                     - _neighbour_matches(s, s))
    accept = mask & (torch.log(u) < -state.beta[:, None, None] * d_e)
    spins = torch.where(accept, prop, s)
    energy = state.energy + torch.sum(torch.where(accept, d_e, 0.0),
                                      dim=(1, 2))
    new_state = dataclasses.replace(state, spins=spins, energy=energy)
    return new_state, torch.sum(accept, dim=(1, 2), dtype=torch.int32)


def checkerboard_sweep(state: PottsState, q: int, r0, u0, r1, u1):
    """The even then the odd half-sweep, with their draws."""
    state, a0 = checkerboard_half_sweep(state, q, 0, r0, u0)
    state, a1 = checkerboard_half_sweep(state, q, 1, r1, u1)
    return state, a0 + a1


def CheckerboardPotts(q: int):
    """Device-algorithm factory: a checkerboard Metropolis sampler bound to a
    static ``q``.  Usage: ``dict(algorithm=potts.CheckerboardPotts(3),
    sweeps=1, seed=...)``."""

    class _CheckerboardPotts(CheckerboardMetropolis):
        state_key = "checkerboard_potts"

        # a single sweep splits the step's key too, as the reference's does
        split_single = True

        def sweep(self, sys, key):
            # the half-sweeps' keys k0, k1, each split into (k_col, k_acc)
            k = prng.split(prng.split(key), 2)             # (M, 2, 2, 2)
            shape = tuple(sys.spins.shape[1:])
            r = prng.randint(k[:, :, 0], shape, 0, q - 1)
            u = prng.uniform(k[:, :, 1], shape)
            return checkerboard_sweep(sys, q, r[:, 0], u[:, 0], r[:, 1],
                                      u[:, 1])

        def write_summary(self, io, scheduler):
            io.write(f"\tCheckerboardPotts(q={q})\n")
            io.write(f"\t\tCalls: {_n_calls(scheduler)}\n")
            io.write(f"\t\tLattice sweeps per step: {self.sweeps}\n")
            io.write(f"\t\tLattice: {self.lattice_shape}\n")

    _CheckerboardPotts.__name__ = f"CheckerboardPotts_q{q}"
    return _CheckerboardPotts


# ---------------------------------------------------------------------------
# Path 3: cluster algorithms (Wolff + Swendsen-Wang via FK representation)
# ---------------------------------------------------------------------------

def _p_bond(state: PottsState):
    """The FK bond probability ``1 - exp(-beta J)`` (the delta
    Hamiltonian's bond gap is J, not 2J as in Ising)."""
    return 1.0 - torch.exp(-state.beta * state.j)


def wolff_step(state: PottsState, q: int, u_right, u_down, site, r):
    """One Wolff cluster move on every chain: the FK cluster of the seed
    ``site`` (M,) through same-colour bonds active where ``u_right`` /
    ``u_down`` < ``1 - exp(-beta J)``, recoloured to the colour ``r`` (M,)
    in [0, q-1) names among the other ``q - 1``.  Returns ``(new_state,
    cluster_size)``."""
    from ..ops.cluster import seed_component_mask

    s = state.spins
    m = s.shape[0]
    act_right, act_down = bond_activation(s, _p_bond(state), u_right, u_down)
    mask = seed_component_mask(act_right, act_down, site)
    old = s.reshape(m, -1).gather(1, site[:, None].to(torch.int64))[:, 0]
    new = _other_color(r.to(torch.int32), old.to(torch.int32)).to(s.dtype)
    spins = torch.where(mask, new[:, None, None], s)
    new_state = dataclasses.replace(state, spins=spins,
                                    energy=_total_energy(spins, state.j))
    return new_state, torch.sum(mask, dim=(1, 2), dtype=torch.int32)


def swendsen_wang_step(state: PottsState, q: int, u_right, u_down, fresh):
    """One Swendsen-Wang sweep on every chain: every FK component labelled
    and given the colour ``fresh`` (an (M, L1 L2) integer tensor in
    [0, q)) holds at its canonical site.  Valid on odd lattices.  Returns
    ``(new_state, n_clusters)``."""
    from ..ops.cluster import component_labels

    s = state.spins
    act_right, act_down = bond_activation(s, _p_bond(state), u_right, u_down)
    labels = component_labels(act_right, act_down)
    spins = fresh_by_label(fresh.to(s.dtype), labels)
    new_state = dataclasses.replace(state, spins=spins,
                                    energy=_total_energy(spins, state.j))
    return new_state, own_labels(labels)


def WolffPotts(q: int):
    """Device-algorithm factory: the Wolff sampler bound to a static ``q``.
    Usage: ``dict(algorithm=potts.WolffPotts(3), clusters=1, seed=...)``;
    its ``wolff`` counters read as ``ising2d``'s."""

    class _WolffPotts(WolffCluster):
        def __init__(self, sim, clusters: int = 1, seed: int = 1,
                     dependencies=(), **_):
            super().__init__(sim, clusters=clusters, seed=seed)

        def _check_ferromagnetic(self, sim, rule):
            super()._check_ferromagnetic(
                sim, "the FK bond probability 1 - exp(-beta J)")

        flip_keys = 4     # k_seed, k_right, k_down, k_col

        def flip(self, sys, key):
            k, u_right, u_down, site = self.draws(key, sys.spins.shape)
            r = prng.randint(k[:, 3], (), 0, q - 1)
            return wolff_step(sys, q, u_right, u_down, site, r)

        def write_summary(self, io, scheduler):
            io.write(f"\tWolffPotts(q={q})\n")
            io.write(f"\t\tCalls: {_n_calls(scheduler)}\n")
            io.write(f"\t\tCluster flips per step: {self.clusters}\n")
            io.write(f"\t\tLattice: {self.lattice_shape}\n")

    _WolffPotts.__name__ = f"WolffPotts_q{q}"
    return _WolffPotts


def SwendsenWangPotts(q: int):
    """Device-algorithm factory: the Swendsen-Wang sampler bound to a static
    ``q``.  Usage: ``dict(algorithm=potts.SwendsenWangPotts(3), sweeps=1,
    seed=...)``."""

    class _SwendsenWangPotts(SwendsenWang):
        def __init__(self, sim, sweeps: int = 1, seed: int = 1,
                     dependencies=(), **_):
            super().__init__(sim, sweeps=sweeps, seed=seed)

        def _check_ferromagnetic(self, sim, rule):
            super()._check_ferromagnetic(
                sim, "the FK bond probability 1 - exp(-beta J)")

        def sweep(self, sys, key):
            # k_right, k_down, k_col
            k, u_right, u_down = self.draws(key, sys.spins.shape)
            lx, ly = sys.spins.shape[1:]
            fresh = prng.randint(k[:, 2], (lx * ly,), 0, q,
                                 dtype=torch.int8)
            return swendsen_wang_step(sys, q, u_right, u_down, fresh)

        def write_summary(self, io, scheduler):
            io.write(f"\tSwendsenWangPotts(q={q})\n")
            io.write(f"\t\tCalls: {_n_calls(scheduler)}\n")
            io.write(f"\t\tLattice sweeps per step: {self.sweeps}\n")
            io.write(f"\t\tLattice: {self.lattice_shape}\n")

    _SwendsenWangPotts.__name__ = f"SwendsenWangPotts_q{q}"
    return _SwendsenWangPotts


# ---------------------------------------------------------------------------
# Observables + exact ground truth
# ---------------------------------------------------------------------------

def _order_parameter(spins, q: int):
    """Potts order parameter m = (q * max_c f_c - 1) / (q - 1), f_c the
    fraction of sites of colour c; 0 when disordered, 1 when ordered."""
    n = spins.shape[-1] * spins.shape[-2]
    counts = torch.stack(
        [torch.sum(spins == c, dim=(-2, -1)) for c in range(q)], dim=-1)
    fmax = torch.amax(counts, dim=-1).to(torch.float32) / n
    return (q * fmax - 1.0) / (q - 1.0)


def callback_energy_per_spin(view):
    n = view.sys.spins.shape[-1] * view.sys.spins.shape[-2]
    return torch.mean(view.sys.energy) / n


def callback_order_parameter(q: int):
    def cb(view):
        return torch.mean(_order_parameter(view.sys.spins, q))
    cb.__name__ = "callback_order_parameter"
    return cb


def exact_moments(size: int, q: int, beta: float, j: float = 1.0):
    """Brute-force Boltzmann expectations on an L x L periodic lattice
    (all q^(L²) colourings, feasible for q^(L²) ≤ ~2e5):
    ``(energy per spin, mean order parameter)``."""
    n = size * size
    if q ** n > 300_000:
        raise ValueError("exact enumeration infeasible for this (q, L)")
    idx = np.arange(q ** n, dtype=np.int64)
    digits = np.empty((q ** n, n), np.int8)
    for d in range(n):
        digits[:, d] = idx % q
        idx = idx // q
    s = digits.reshape(-1, size, size)
    matches = ((s == np.roll(s, 1, axis=1)).astype(np.float64)
               + (s == np.roll(s, 1, axis=2)).astype(np.float64))
    e = -j * matches.sum(axis=(1, 2))
    w = np.exp(-beta * (e - e.min()))
    z = w.sum()
    counts = np.stack([(s == c).sum(axis=(1, 2)) for c in range(q)], axis=-1)
    m = (q * counts.max(axis=-1) / n - 1.0) / (q - 1.0)
    return float((w * e).sum() / z / n), float((w * m).sum() / z)
