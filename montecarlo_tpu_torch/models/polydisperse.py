"""Continuously polydisperse soft spheres in 2-D — swap Monte Carlo for
glasses.

Port of the 2-D subset of ``montecarlo_tpu/models/polydisperse.py``: an
inverse-power-law pair potential ``u = (sigma_ij / r)^12`` with a C2-smooth
cutoff at ``r = x_c sigma_ij`` and the non-additive cross diameter
``sigma_ij = (d_i + d_j) / 2 * (1 - eps |d_i - d_j|)``, diameters drawn from
``P(d) ~ d^-3``, the local displacement move and the diameter-swap move
(Ninarello, Berthier & Coslovich 2017), each with an O(N) incremental ΔE
against the energy cached in the state.  Every function works on all chains
at once: positions are one (M, N, 2) tensor.

Volume moves, the density callback, the cell-MC closures, event-chain MC
and 3-D states are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.moves import Move, MoveDef, Policy
from ..core.system import SystemDef
from ..utils.device import resolve_device
from . import lennard_jones as _lj
from .lennard_jones import GaussianDisplacement2D, _gather_pos, _slot_mask

__all__ = [
    "PolyState",
    "PolyParams",
    "make_system",
    "init_chains",
    "sample_diameters",
    "displacement_move",
    "swap_move",
    "total_energy",
    "callback_energy_per_particle",
]


@dataclasses.dataclass(frozen=True)
class PolyState:
    """Chain-batched state."""
    pos: torch.Tensor     # (M, N, 2) positions in [0, L)
    diam: torch.Tensor    # (M, N) particle diameters
    beta: torch.Tensor    # (M,) inverse temperature
    energy: torch.Tensor  # (M,) cached total potential energy
    box: torch.Tensor     # (M,) box edge L


def _smoothing_coeffs(xc: float):
    """(c0, c2, c4) with u(xc)=u'(xc)=u''(xc)=0 for u = x^-12 + c0 + c2 x^2
    + c4 x^4 (x = r/sigma_ij), solved in float64 as the reference does."""
    a = np.array([
        [1.0, xc ** 2, xc ** 4],
        [0.0, 2 * xc, 4 * xc ** 3],
        [0.0, 2.0, 12 * xc ** 2],
    ])
    b = np.array([-xc ** -12, 12 * xc ** -13, -156 * xc ** -14])
    c0, c2, c4 = np.linalg.solve(a, b)
    return float(c0), float(c2), float(c4)


@dataclasses.dataclass(frozen=True)
class PolyParams:
    """Static model constants (Ninarello-Berthier-Coslovich values)."""
    eps: float = 0.2          # cross-diameter non-additivity
    xc: float = 1.25          # cutoff in units of sigma_ij
    d_min: float = 0.73       # diameter distribution support
    d_max: float = 1.62

    def coeffs(self):
        return _smoothing_coeffs(self.xc)


def _pair_energy(r2, sig, params: PolyParams, c0, c2, c4):
    """Smoothed IPL-12 on squared distances (elementwise)."""
    sig2 = sig * sig
    x2 = r2 / torch.clamp(sig2, min=1e-12)
    inv2 = 1.0 / torch.clamp(x2, min=1e-12)
    inv12 = inv2 * inv2 * inv2
    inv12 = inv12 * inv12
    u = inv12 + c0 + c2 * x2 + c4 * x2 * x2
    return torch.where(x2 < params.xc ** 2, u, 0.0)


def _sigma_ij(d_i, d_j, eps):
    return 0.5 * (d_i + d_j) * (1.0 - eps * torch.abs(d_i - d_j))


def _row_energy(state: PolyState, x, d_i, mask, params: PolyParams, coeffs):
    """(M,) energy of a (virtual) particle at ``x`` (M, 2) with diameter
    ``d_i`` (M,) against each chain's particles (slots where ``mask``
    (M, N) is True excluded)."""
    d = state.pos - x[:, None, :]
    b = state.box[:, None, None]
    d = d - b * torch.round(d / b)
    r2 = torch.sum(d * d, dim=-1)
    sig = _sigma_ij(d_i[:, None], state.diam, params.eps)
    u = _pair_energy(r2, sig, params, *coeffs)
    return torch.sum(torch.where(mask, 0.0, u), dim=-1)


def total_energy(state: PolyState, params: PolyParams = PolyParams(),
                 row_batch: int = None):
    """(M,) full O(N^2) energies; ``row_batch`` bounds peak memory to
    ``M x row_batch x N`` pair terms (see ``lennard_jones.total_energy``)."""
    coeffs = params.coeffs()
    pos, dia, box = state.pos, state.diam, state.box
    n = pos.shape[-2]
    b = box[:, None, None, None]
    if row_batch is None or row_batch >= n:
        d = pos[:, :, None, :] - pos[:, None, :, :]
        d = d - b * torch.round(d / b)
        r2 = torch.sum(d * d, dim=-1)
        sig = _sigma_ij(dia[:, :, None], dia[:, None, :], params.eps)
        u = _pair_energy(r2, sig, params, *coeffs)
        mask = ~torch.eye(n, dtype=torch.bool, device=pos.device)
        return 0.5 * torch.sum(torch.where(mask, u, 0.0), dim=(1, 2))
    cols = torch.arange(n, device=pos.device)
    rows = []
    for start in range(0, n, row_batch):
        idx = cols[start:start + row_batch]
        d = pos[:, None, :, :] - pos[:, idx, None, :]         # (M, R, N, 2)
        d = d - b * torch.round(d / b)
        r2 = torch.sum(d * d, dim=-1)
        sig = _sigma_ij(dia[:, idx, None], dia[:, None, :], params.eps)
        u = _pair_energy(r2, sig, params, *coeffs)
        u = torch.where(idx[:, None] == cols[None, :], 0.0, u)
        rows.append(torch.sum(u, dim=-1))
    return 0.5 * torch.sum(torch.cat(rows, dim=1), dim=1)


def _energies(state: PolyState, params: PolyParams, row_batch, pair_budget):
    """:func:`total_energy` over chain batches of at most ``pair_budget``
    pair terms each (``lennard_jones._energies``)."""
    return _lj._energies(state, params, row_batch, pair_budget,
                         total=total_energy)


def make_system(params: PolyParams = PolyParams()) -> SystemDef:
    def log_target(state: PolyState):
        return -state.beta * state.energy

    def frame(state: PolyState):
        return {"pos": state.pos, "diam": state.diam,
                "energy": state.energy}

    def format_frame(t, fr):
        n, d = fr["pos"].shape
        lines = [f"{t} {n} {float(fr['energy'])!r}"]
        for k in range(n):
            coords = " ".join(repr(float(fr["pos"][k, a]))
                              for a in range(d))
            lines.append(f"{float(fr['diam'][k])!r} {coords}")
        return "\n".join(lines)

    def refresh(state: PolyState):
        # revalidate the incremental-ΔE energy cache (float drift bound);
        # row- and chain-batched so many chains at large N stay bounded
        n = state.pos.shape[-2]
        rb = None if n <= 256 else 64
        return dataclasses.replace(
            state, energy=_energies(state, params, rb, 2 ** 24))

    return SystemDef(name="PolydisperseSoftSpheres2D",
                     log_target=log_target, frame=frame,
                     format_frame=format_frame, refresh=refresh)


def sample_diameters(n: int, params: PolyParams = PolyParams(),
                     seed: int = 0) -> np.ndarray:
    """P(d) ~ d^-3 on [d_min, d_max] by inverse CDF (numpy, host-side; the
    reference's draw bit for bit)."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(size=n)
    a, b = params.d_min, params.d_max
    # CDF(d) = (a^-2 - d^-2) / (a^-2 - b^-2)
    inv2 = a ** -2 - u * (a ** -2 - b ** -2)
    return (inv2 ** -0.5).astype(np.float32)


def init_chains(n_chains: int, n_particles: int, rho: float, beta: float,
                seed: int = 42, params: PolyParams = PolyParams(),
                device=None) -> PolyState:
    """Square-lattice start with a small jitter; every chain gets the same
    diameter draw (the composition is quenched disorder shared across
    chains), ``sample_diameters(n_particles, params, seed + 1)`` as in the
    reference.  The jitter comes from a ``torch.Generator`` seeded with
    ``seed`` — a different stream than the JAX package's, so
    ``interop.chains_from_reference`` carries its chains over instead.  The
    chains are made on ``device``, the card (``cuda``) when it is None."""
    device = resolve_device(device)
    box = float((n_particles / rho) ** (1.0 / 2))
    side = int(np.ceil(n_particles ** (1.0 / 2)))
    spacing = box / side
    grid = np.stack(np.meshgrid(np.arange(side), np.arange(side)),
                    axis=-1).reshape(-1, 2)[:n_particles]
    base = (grid + 0.5) * spacing
    diam = sample_diameters(n_particles, params, seed=seed + 1)

    gen = torch.Generator(device=device).manual_seed(seed)
    jitter = (0.1 * spacing) * (2.0 * torch.rand(
        (n_chains, n_particles, 2), generator=gen, device=device) - 1.0)
    pos = (torch.as_tensor(base, dtype=torch.float32, device=device)[None]
           + jitter) % box
    state = PolyState(
        pos=pos,
        diam=torch.as_tensor(diam, device=device).expand(
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

def _gather_diam(state: PolyState, mask):
    return torch.sum(torch.where(mask, state.diam, 0.0), dim=1)


def displacement_move(sigma: float, weight: float = 1.0,
                      params: PolyParams = PolyParams()) -> Move:
    """Local displacement (uniform pick, isotropic Gaussian step) with O(N)
    incremental ΔE."""
    coeffs = params.coeffs()

    def apply(state: PolyState, action):
        mask = _slot_mask(state, action["i"])
        old = _gather_pos(state, mask)
        d_i = _gather_diam(state, mask)
        new = old + action["delta"]
        e_old = _row_energy(state, old, d_i, mask, params, coeffs)
        e_new = _row_energy(state, new, d_i, mask, params, coeffs)
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

    md = MoveDef(name="PolyDisplacement", policy=GaussianDisplacement2D(),
                 apply=apply, invert=invert, reward=reward,
                 kind="poly_displacement_2d", aux=params)
    return Move(move=md,
                params={"sigma": torch.tensor(sigma, dtype=torch.float32)},
                weight=weight)


class UniformPair(Policy):
    """Uniform unordered particle pair with j != i; a self-inverse swap
    proposal."""

    def sample(self, params, generator, state):
        m, n = state.diam.shape
        dev = state.diam.device
        i = torch.randint(0, n, (m,), generator=generator, device=dev)
        # j uniform over the other n-1 indices
        j = torch.randint(0, n - 1, (m,), generator=generator, device=dev)
        return {"i": i, "j": torch.where(j >= i, j + 1, j)}

    def log_density(self, params, action, state):
        m, n = state.diam.shape
        return -torch.log(torch.full((m,), float(n * (n - 1)),
                                     device=state.diam.device))


def swap_move(weight: float = 1.0,
              params: PolyParams = PolyParams()) -> Move:
    """Exchange the diameters of particles (i, j) — the glass-equilibration
    accelerator.  ΔE is two O(N) row updates each way; the i–j pair term is
    invariant (sigma_ij symmetric in the exchange) and cancels."""
    coeffs = params.coeffs()

    def apply(state: PolyState, action):
        mask_i = _slot_mask(state, action["i"])
        mask_j = _slot_mask(state, action["j"])
        mask_ij = mask_i | mask_j
        d_i, d_j = _gather_diam(state, mask_i), _gather_diam(state, mask_j)
        x_i, x_j = _gather_pos(state, mask_i), _gather_pos(state, mask_j)
        e_old = (_row_energy(state, x_i, d_i, mask_ij, params, coeffs)
                 + _row_energy(state, x_j, d_j, mask_ij, params, coeffs))
        e_new = (_row_energy(state, x_i, d_j, mask_ij, params, coeffs)
                 + _row_energy(state, x_j, d_i, mask_ij, params, coeffs))
        d_e = e_new - e_old
        diam = torch.where(mask_i, d_j[:, None],
                           torch.where(mask_j, d_i[:, None], state.diam))
        new_state = dataclasses.replace(
            state, diam=diam, energy=state.energy + d_e)
        return new_state, -state.beta * d_e

    def invert(action, new_state):
        return action  # self-inverse

    def reward(action, new_state):
        return torch.ones_like(new_state.energy)

    md = MoveDef(name="PolySwap", policy=UniformPair(),
                 apply=apply, invert=invert, reward=reward,
                 kind="poly_swap", aux=params)
    return Move(move=md, params={"dummy": torch.zeros(())}, weight=weight)


def callback_energy_per_particle(view):
    n = view.sys.pos.shape[-2]
    return torch.mean(view.sys.energy) / n
