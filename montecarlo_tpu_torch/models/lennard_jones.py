"""2-D Lennard-Jones particle system (ParticlesMC-style).

Port of the 2-D subset of ``montecarlo_tpu/models/lennard_jones.py``: the
binary Kob-Andersen mixture with truncated-and-shifted pair energies, the
local displacement move and the species-swap move, each with an O(N)
incremental ΔE against the energy cached in the state.  Every function works
on all chains at once: positions are one (M, N, 2) tensor.

Volume moves, the virial pressure, event-chain MC, the cell-MC closures and
3-D states are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.moves import Move, MoveDef, Policy
from ..core.system import SystemDef
from ..utils.device import resolve_device

__all__ = [
    "LJState",
    "LJParams",
    "make_system",
    "init_chains",
    "lj_displacement_move",
    "lj_swap_move",
    "total_energy",
    "callback_energy_per_particle",
]


@dataclasses.dataclass(frozen=True)
class LJState:
    """Chain-batched state."""
    pos: torch.Tensor       # (M, N, 2) positions in [0, L)
    species: torch.Tensor   # (M, N) int32 species labels (0=A, 1=B)
    beta: torch.Tensor      # (M,) inverse temperature
    energy: torch.Tensor    # (M,) cached total potential energy
    box: torch.Tensor       # (M,) periodic box edge L


@dataclasses.dataclass(frozen=True)
class LJParams:
    """Static interaction table (Kob-Andersen defaults).

    eps/sig are 2x2 species tables; rcut is in units of sig_ab (truncated &
    shifted so u(rcut)=0).
    """
    eps: tuple = ((1.0, 1.5), (1.5, 0.5))
    sig: tuple = ((1.0, 0.8), (0.8, 0.88))
    rcut: float = 2.5

    def coeffs(self, s_i, s_j):
        """Species-pair (eps, sig) via arithmetic select."""
        same = s_i == s_j
        is_a = s_i == 0
        eps = torch.where(
            same, torch.where(is_a, self.eps[0][0], self.eps[1][1]),
            self.eps[0][1])
        sig = torch.where(
            same, torch.where(is_a, self.sig[0][0], self.sig[1][1]),
            self.sig[0][1])
        return eps, sig


def _pair_energy(r2, eps, sig, rcut):
    """Truncated-and-shifted LJ on squared distances (elementwise)."""
    sig2 = sig * sig
    rc2 = (rcut * sig) ** 2
    # avoid div-by-zero at the self-distance slot; masked out by caller
    inv = sig2 / torch.clamp(r2, min=1e-12)
    i6 = inv * inv * inv
    u = 4.0 * eps * (i6 * i6 - i6)
    ic = 1.0 / (rcut * rcut)
    ic6 = ic * ic * ic
    ushift = 4.0 * eps * (ic6 * ic6 - ic6)
    return torch.where(r2 < rc2, u - ushift, 0.0)


def _min_image_r2(pos, x, box):
    """(M, N) squared min-image distances from each chain's point ``x``
    (M, 2) to its particles."""
    d = pos - x[:, None, :]
    b = box[:, None, None]
    d = d - b * torch.round(d / b)
    return torch.sum(d * d, dim=-1)


def _row_energy(state: LJState, x, s_i, mask, params: LJParams):
    """(M,) interaction energy of a (virtual) particle at ``x`` (M, 2) with
    species ``s_i`` (M,) against each chain's particles (slots where ``mask``
    (M, N) is True excluded)."""
    r2 = _min_image_r2(state.pos, x, state.box)
    eps, sig = params.coeffs(s_i[:, None], state.species)
    u = _pair_energy(r2, eps, sig, params.rcut)
    return torch.sum(torch.where(mask, 0.0, u), dim=-1)


def total_energy(state: LJState, params: LJParams, row_batch: int = None):
    """(M,) full O(N^2) energies — used for initialisation and cache
    validation.

    ``row_batch`` bounds peak memory to ``M x row_batch x N`` pair terms
    (the dense path materialises the full (M, N, N, 2) displacement tensor);
    results are the same up to float32 summation order.
    """
    pos, spc, box = state.pos, state.species, state.box
    n = pos.shape[-2]
    if row_batch is None or row_batch >= n:
        d = pos[:, :, None, :] - pos[:, None, :, :]
        b = box[:, None, None, None]
        d = d - b * torch.round(d / b)
        r2 = torch.sum(d * d, dim=-1)
        eps, sig = params.coeffs(spc[:, :, None], spc[:, None, :])
        u = _pair_energy(r2, eps, sig, params.rcut)
        mask = ~torch.eye(n, dtype=torch.bool, device=pos.device)
        return 0.5 * torch.sum(torch.where(mask, u, 0.0), dim=(1, 2))
    cols = torch.arange(n, device=pos.device)
    rows = []
    for start in range(0, n, row_batch):
        idx = cols[start:start + row_batch]
        d = pos[:, None, :, :] - pos[:, idx, None, :]         # (M, R, N, 2)
        b = box[:, None, None, None]
        d = d - b * torch.round(d / b)
        r2 = torch.sum(d * d, dim=-1)
        eps, sig = params.coeffs(spc[:, idx, None], spc[:, None, :])
        u = _pair_energy(r2, eps, sig, params.rcut)
        u = torch.where(idx[:, None] == cols[None, :], 0.0, u)
        rows.append(torch.sum(u, dim=-1))
    return 0.5 * torch.sum(torch.cat(rows, dim=1), dim=1)


def _energies(state, params, row_batch, pair_budget, total=total_energy):
    """``total(state, params, row_batch)`` (an O(N^2) energy, by default
    :func:`total_energy`) over chain batches of at most ``pair_budget`` pair
    terms each, so that many chains at large N stay bounded."""
    m, n = state.pos.shape[:2]
    per_chain = min(row_batch or n, n) * n
    batch = max(1, min(m, pair_budget // per_chain))
    if batch >= m:
        return total(state, params, row_batch)
    return torch.cat([
        total(type(state)(*(getattr(state, f.name)[s:s + batch]
                            for f in dataclasses.fields(state))),
              params, row_batch)
        for s in range(0, m, batch)])


def make_system(params: LJParams = LJParams()) -> SystemDef:
    def log_target(state: LJState):
        return -state.beta * state.energy

    def frame(state: LJState):
        return {"pos": state.pos, "species": state.species,
                "energy": state.energy}

    def format_frame(t, fr):
        n, d = fr["pos"].shape
        lines = [f"{t} {n} {float(fr['energy'])!r}"]
        for k in range(n):
            coords = " ".join(repr(float(fr["pos"][k, a]))
                              for a in range(d))
            lines.append(f"{int(fr['species'][k])} {coords}")
        return "\n".join(lines)

    def refresh(state: LJState):
        # revalidate the incremental-ΔE energy cache (float drift bound);
        # row- and chain-batched so many chains at large N stay bounded
        n = state.pos.shape[-2]
        rb = None if n <= 256 else 64
        return dataclasses.replace(
            state, energy=_energies(state, params, rb, 2 ** 24))

    return SystemDef(name="LennardJones2D", log_target=log_target,
                     frame=frame, format_frame=format_frame,
                     refresh=refresh)


def init_chains(n_chains: int, n_particles: int, rho: float, beta: float,
                frac_b: float = 0.0, seed: int = 42,
                params: LJParams = LJParams(), device=None) -> LJState:
    """Chain-stacked initial state: square lattice + small jitter (avoids
    overlaps), species assigned round-robin to hit ``frac_b``.  The jitter
    comes from a ``torch.Generator`` seeded with ``seed`` — a different
    stream than the JAX package's, so ``interop.chains_from_reference``
    carries its chains over instead.  The chains are made on ``device``, the
    card (``cuda``) when it is None."""
    device = resolve_device(device)
    box = float((n_particles / rho) ** (1.0 / 2))
    side = int(np.ceil(n_particles ** (1.0 / 2)))
    spacing = box / side
    grid = np.stack(np.meshgrid(np.arange(side), np.arange(side)),
                    axis=-1).reshape(-1, 2)[:n_particles]
    base = (grid + 0.5) * spacing

    n_b = int(round(frac_b * n_particles))
    species = np.zeros(n_particles, np.int32)
    if n_b:
        species[np.linspace(0, n_particles - 1, n_b).astype(int)] = 1

    gen = torch.Generator(device=device).manual_seed(seed)
    jitter = (0.1 * spacing) * (2.0 * torch.rand(
        (n_chains, n_particles, 2), generator=gen, device=device) - 1.0)
    pos = (torch.as_tensor(base, dtype=torch.float32, device=device)[None]
           + jitter) % box
    state = LJState(
        pos=pos,
        species=torch.as_tensor(species, device=device).expand(
            n_chains, n_particles).contiguous(),
        beta=torch.full((n_chains,), beta, dtype=torch.float32,
                        device=device),
        energy=torch.zeros((n_chains,), dtype=torch.float32, device=device),
        box=torch.full((n_chains,), box, dtype=torch.float32, device=device),
    )
    rb = None if n_particles <= 1024 else 256
    return dataclasses.replace(
        state, energy=_energies(state, params, rb, 2 ** 27))


# ---------------------------------------------------------------------------
# Moves
# ---------------------------------------------------------------------------

class GaussianDisplacement2D(Policy):
    """Uniform particle pick + isotropic Gaussian displacement.

    The particle-selection factor 1/N is identical forward/backward and the
    Gaussian is symmetric, so logq_f == logq_b — both are still computed by
    the generic step and cancel in the ratio.
    """

    def sample(self, params, generator, state):
        m, n, d = state.pos.shape
        dev = state.pos.device
        i = torch.randint(0, n, (m,), generator=generator, device=dev)
        sigma = params["sigma"]
        delta = sigma[..., None] * torch.randn(
            (m, d), generator=generator, dtype=sigma.dtype, device=dev)
        return {"i": i, "delta": delta}

    def log_density(self, params, action, state):
        sigma = params["sigma"]
        d2 = torch.sum(action["delta"] ** 2, dim=-1)
        _, n, d = state.pos.shape
        return (-d2 / (2.0 * sigma * sigma)
                - (d / 2.0) * torch.log(2.0 * torch.pi * sigma * sigma)
                - torch.log(torch.tensor(float(n), dtype=sigma.dtype)))


def _slot_mask(state: LJState, i):
    n = state.pos.shape[1]
    return torch.arange(n, device=state.pos.device)[None, :] == i[:, None]


def _gather_species(state: LJState, mask):
    return torch.sum(torch.where(mask, state.species, 0), dim=1).to(
        state.species.dtype)


def _gather_pos(state: LJState, mask):
    return torch.sum(torch.where(mask[..., None], state.pos, 0.0), dim=1)


def lj_displacement_move(sigma: float, weight: float = 1.0,
                         params: LJParams = LJParams()) -> Move:
    """Local displacement with O(N) incremental ΔE."""

    def apply(state: LJState, action):
        mask = _slot_mask(state, action["i"])
        # one-hot reduce instead of a gather, masked select instead of a
        # scatter, as the reference writes them
        old = _gather_pos(state, mask)
        s_i = _gather_species(state, mask)
        new = old + action["delta"]
        e_old = _row_energy(state, old, s_i, mask, params)
        e_new = _row_energy(state, new, s_i, mask, params)
        d_e = e_new - e_old
        wrapped = new % state.box[:, None]
        pos = torch.where(mask[..., None], wrapped[:, None, :], state.pos)
        new_state = dataclasses.replace(
            state, pos=pos, energy=state.energy + d_e)
        return new_state, -state.beta * d_e

    def invert(action, new_state):
        return {"i": action["i"], "delta": -action["delta"]}

    def reward(action, new_state):
        return torch.sum(action["delta"] ** 2, dim=-1)

    md = MoveDef(name="LJDisplacement", policy=GaussianDisplacement2D(),
                 apply=apply, invert=invert, reward=reward,
                 kind="lj_displacement_2d", aux=params)
    return Move(move=md,
                params={"sigma": torch.tensor(sigma, dtype=torch.float32)},
                weight=weight)


class UniformPairSwap(Policy):
    """Pick an (A, B) pair uniformly; proposal is symmetric (self-inverse),
    so logq_f == logq_b by construction."""

    def sample(self, params, generator, state):
        m, n = state.species.shape
        dev = state.species.device
        is_b = state.species == 1
        n_b = torch.sum(is_b, dim=1)
        n_a = n - n_b

        def rank(count):     # uniform in [0, max(count, 1))
            hi = torch.clamp(count, min=1)
            u = torch.rand((m,), generator=generator, dtype=torch.float64,
                           device=dev)
            return torch.minimum((u * hi).to(torch.int64), hi - 1)

        ka, kb = rank(n_a), rank(n_b)
        # index of the k-th A (resp. B) particle via cumulative counts
        a_rank = torch.cumsum(~is_b, dim=1) - 1
        b_rank = torch.cumsum(is_b, dim=1) - 1
        i = torch.argmax(((a_rank == ka[:, None]) & ~is_b).to(torch.int8),
                         dim=1)
        j = torch.argmax(((b_rank == kb[:, None]) & is_b).to(torch.int8),
                         dim=1)
        return {"i": i, "j": j}

    def log_density(self, params, action, state):
        is_b = state.species == 1
        n_b = torch.sum(is_b, dim=1).to(torch.float32)
        n_a = is_b.shape[1] - n_b
        return -torch.log(torch.clamp(n_a, min=1.0)) - torch.log(
            torch.clamp(n_b, min=1.0))


def lj_swap_move(weight: float = 1.0,
                 params: LJParams = LJParams()) -> Move:
    """Species-swap move: exchange the species labels of an (A, B) pair.

    ΔE is two O(N) row updates (remove both old identities, add both new);
    the i–j pair keeps its species pair under the exchange, so its energy
    cancels.
    """

    def apply(state: LJState, action):
        mask_i = _slot_mask(state, action["i"])
        mask_j = _slot_mask(state, action["j"])
        mask_ij = mask_i | mask_j
        s_i, s_j = _gather_species(state, mask_i), _gather_species(state,
                                                                    mask_j)
        x_i, x_j = _gather_pos(state, mask_i), _gather_pos(state, mask_j)
        e_old = (_row_energy(state, x_i, s_i, mask_ij, params)
                 + _row_energy(state, x_j, s_j, mask_ij, params))
        e_new = (_row_energy(state, x_i, s_j, mask_ij, params)
                 + _row_energy(state, x_j, s_i, mask_ij, params))
        d_e = e_new - e_old
        species = torch.where(mask_i, s_j[:, None],
                              torch.where(mask_j, s_i[:, None],
                                          state.species))
        new_state = dataclasses.replace(
            state, species=species, energy=state.energy + d_e)
        return new_state, -state.beta * d_e

    def invert(action, new_state):
        return action  # self-inverse

    def reward(action, new_state):
        return torch.ones_like(new_state.energy)

    md = MoveDef(name="LJSwap", policy=UniformPairSwap(),
                 apply=apply, invert=invert, reward=reward,
                 kind="lj_swap", aux=params)
    return Move(move=md, params={"dummy": torch.zeros(())}, weight=weight)


def callback_energy_per_particle(view):
    n = view.sys.pos.shape[-2]
    return torch.mean(view.sys.energy) / n
