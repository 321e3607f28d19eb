"""1-D Ising ring with single-spin-flip Metropolis moves.

Port of ``montecarlo_tpu/models/ising.py``: the move protocol on a discrete
system.  The state is an int8 spin vector per chain with a cached energy,
the move flips one uniformly chosen site, and the delta-energy is the local
bond sum, O(1) per attempt.  Every function works on all chains at once:
the spins are one (M, N) tensor.

Exact check: the periodic-ring energy per spin is
``-J (t + t^{N-1}) / (1 + t^N)`` with ``t = tanh(beta J)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.moves import Move, MoveDef, Policy
from ..core.system import SystemDef
from ..utils import prng
from ..utils.device import resolve_device

__all__ = ["IsingState", "make_system", "init_chains", "spin_flip_move",
           "exact_energy_per_spin", "callback_energy_per_spin",
           "callback_magnetisation"]


@dataclasses.dataclass(frozen=True)
class IsingState:
    """Chain-batched state."""
    spins: torch.Tensor   # (M, N) int8 in {-1, +1}
    beta: torch.Tensor    # (M,)
    j: torch.Tensor       # (M,) coupling
    energy: torch.Tensor  # (M,) cached total energy


def _total_energy(spins, j):
    s = spins.to(torch.float32)
    return -j * torch.sum(s * torch.roll(s, 1, -1), dim=-1)


def make_system() -> SystemDef:
    def log_target(state: IsingState):
        return -state.beta * state.energy

    def frame(state: IsingState):
        return {"e": state.energy,
                "m": torch.mean(state.spins.to(torch.float32), dim=-1)}

    def format_frame(t, fr):
        return f"{t} {float(fr['m'])!r} {float(fr['e'])!r}"

    return SystemDef(name="Ising1D", log_target=log_target, frame=frame,
                     format_frame=format_frame)


def random_spins(shape, seed: int, device) -> torch.Tensor:
    """int8 spins in {-1, +1}, +1 where ``bernoulli(key(seed), 0.5,
    shape)`` holds: the reference's draw over the whole shape from the one
    key (not a key a chain)."""
    up = prng.bernoulli(prng.key(seed, device), 0.5, shape)
    return 2 * up.to(torch.int8) - 1


def init_chains(n_chains: int, n_spins: int, beta: float, j: float = 1.0,
                seed: int = 42, device=None) -> IsingState:
    """Random spins from ``key(seed)`` as the reference draws them (the same
    seed gives its chains), made on ``device``, the card (``cuda``) when it
    is None."""
    device = resolve_device(device)
    spins = random_spins((n_chains, n_spins), seed, device)
    full = lambda v: torch.full((n_chains,), v, dtype=torch.float32,
                                device=device)
    jj = full(j)
    return IsingState(spins=spins, beta=full(beta), j=jj,
                      energy=_total_energy(spins, jj))


class UniformSiteFlip(Policy):
    """Pick a site uniformly; the proposal is symmetric and self-inverse."""

    def sample(self, params, key, state):
        n = state.spins.shape[1]
        return prng.randint(key, (), 0, n, dtype=torch.int64)

    def log_density(self, params, action, state):
        m, n = state.spins.shape
        return torch.full((m,), -float(np.log(np.float32(n))),
                          dtype=torch.float32, device=state.spins.device)


def _flip(spins, flat_site):
    """``spins`` (M, ...) with each chain's site ``flat_site`` (M,) negated,
    and the old values there."""
    m = spins.shape[0]
    flat = spins.reshape(m, -1)
    old = torch.gather(flat, 1, flat_site[:, None])
    return flat.scatter(1, flat_site[:, None], -old).reshape(spins.shape), \
        old[:, 0]


def spin_flip_move(weight: float = 1.0) -> Move:
    def apply(state: IsingState, site):
        s = state.spins
        n = s.shape[-1]
        nb = lambda k: torch.gather(s, 1, k[:, None])[:, 0].to(torch.float32)
        left, right = nb((site - 1) % n), nb((site + 1) % n)
        spins, si = _flip(s, site)
        d_e = 2.0 * state.j * si.to(torch.float32) * (left + right)
        new_state = dataclasses.replace(
            state, spins=spins, energy=state.energy + d_e)
        return new_state, -state.beta * d_e

    def invert(site, new_state):
        return site  # self-inverse

    def reward(site, new_state):
        return torch.ones(site.shape, dtype=torch.float32,
                          device=site.device)

    md = MoveDef(name="SpinFlip", policy=UniformSiteFlip(), apply=apply,
                 invert=invert, reward=reward, kind="ising_spin_flip")
    return Move(move=md, params={"dummy": torch.zeros(())}, weight=weight)


def exact_energy_per_spin(beta: float, n: int, j: float = 1.0) -> float:
    """Exact periodic-ring mean energy per spin at inverse temperature
    beta (transfer-matrix result)."""
    t = np.tanh(beta * j)
    return float(-j * (t + t ** (n - 1)) / (1.0 + t ** n))


def callback_energy_per_spin(view):
    n = view.sys.spins.shape[-1]
    return torch.mean(view.sys.energy) / n


def callback_magnetisation(view):
    return torch.mean(torch.abs(
        torch.mean(view.sys.spins.to(torch.float32), dim=-1)))
