"""Continuously polydisperse soft spheres in 2-D or 3-D — swap Monte Carlo
for glasses.

Port of ``montecarlo_tpu/models/polydisperse.py``: an
inverse-power-law pair potential ``u = (sigma_ij / r)^12`` with a C2-smooth
cutoff at ``r = x_c sigma_ij`` and the non-additive cross diameter
``sigma_ij = (d_i + d_j) / 2 * (1 - eps |d_i - d_j|)``, diameters drawn from
``P(d) ~ d^-3``, the local displacement move and the diameter-swap move
(Ninarello, Berthier & Coslovich 2017), each with an O(N) incremental ΔE
against the energy cached in the state, the ln-V volume move of NPT swap
MC, and the closures the checkerboard cell-MC path takes
(:func:`cell_closures`).  Every function works on all chains at once:
positions are one (M, N, dim) tensor (``init_chains(dim=3)`` gives the 3-D
glass former).

Straight event chains with exact factor events (:func:`ecmc_model`) run
under :class:`~montecarlo_tpu_torch.core.ecmc.EventChain`.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..core.ecmc import (CHECK_EVERY, EventChainModel, StraightChain,
                         run_chain, squared_norm)
from ..core.moves import Move, MoveDef, MoveFamily, Policy
from ..core.system import SystemDef
from ..ops import poly_sweep
from ..ops.cell_mc import CellModel
from ..utils import prng
from ..utils.device import resolve_device
from . import lennard_jones as _lj
from .lennard_jones import (GaussianDisplacement2D, _full_batching,
                            _gather_pos, _jittered, _lattice, _slot_mask,
                            callback_density)

__all__ = [
    "PolyState",
    "PolyParams",
    "make_system",
    "init_chains",
    "sample_diameters",
    "displacement_move",
    "swap_move",
    "volume_move",
    "total_energy",
    "callback_energy_per_particle",
    "callback_density",
    "cell_closures",
    "ecmc_model",
]


@dataclasses.dataclass(frozen=True)
class PolyState:
    """Chain-batched state."""
    pos: torch.Tensor     # (M, N, dim) positions in [0, L)
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
    """(M,) energy of a (virtual) particle at ``x`` (M, dim) with diameter
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
        d = pos[:, None, :, :] - pos[:, idx, None, :]       # (M, R, N, dim)
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
                device=None, dim: int = 2) -> PolyState:
    """Square (``dim=2``) or cubic (``dim=3``) lattice start with a small
    jitter; every chain gets the same diameter draw (the composition is
    quenched disorder shared across chains),
    ``sample_diameters(n_particles, params, seed + 1)`` as in the reference.
    The jitter is the reference's draw from ``seed``, so the JAX package's
    ``init_chains`` gives the same positions.  The chains are made on
    ``device``, the card (``cuda``) when it is None."""
    device = resolve_device(device)
    box = float((n_particles / rho) ** (1.0 / dim))
    base, spacing = _lattice(n_particles, box, dim)
    diam = sample_diameters(n_particles, params, seed=seed + 1)
    state = PolyState(
        pos=_jittered(base, 0.1 * spacing, n_chains, box, seed, device),
        diam=torch.as_tensor(diam, device=device).expand(
            n_chains, n_particles).contiguous(),
        beta=torch.full((n_chains,), beta, dtype=torch.float32,
                        device=device),
        energy=torch.zeros((n_chains,), dtype=torch.float32, device=device),
        box=torch.full((n_chains,), box, dtype=torch.float32, device=device),
    )
    return dataclasses.replace(
        state, energy=_energies(state, params, *_full_batching(n_particles)))


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
                 kind="poly_displacement_2d", aux=params, family=FAMILY)
    return Move(move=md,
                params={"sigma": torch.tensor(sigma, dtype=torch.float32)},
                weight=weight)


class UniformPair(Policy):
    """Uniform unordered particle pair with j != i; a self-inverse swap
    proposal."""

    def sample(self, params, key, state):
        ki, kj = prng.split(key).unbind(-2)
        n = state.diam.shape[1]
        i = prng.randint(ki, (), 0, n, dtype=torch.int64)
        # j uniform over the other n-1 indices
        j = prng.randint(kj, (), 0, n - 1, dtype=torch.int64)
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
                 kind="poly_swap", aux=params, family=FAMILY)
    return Move(move=md, params={"dummy": torch.zeros(())}, weight=weight)


def volume_move(dlnv: float, pressure: float, weight: float = 1.0,
                params: PolyParams = PolyParams()) -> Move:
    """Isotropic ln-V volume move: NPT swap MC, the constant-pressure glass
    protocol, with the acceptance of ``lennard_jones.lj_volume_move``."""
    return _lj._volume_move("PolyVolume", "poly_volume", _energies, dlnv,
                            pressure, weight, params, FAMILY)


def callback_energy_per_particle(view):
    n = view.sys.pos.shape[-2]
    return torch.mean(view.sys.energy) / n


@functools.lru_cache(maxsize=None)
def cell_closures(params: PolyParams):
    """(pair_energy, rcut2_of, rcut_max) for the checkerboard cell-MC path
    (``ops/cell_mc.py``); the attributes are the particle diameters."""
    coeffs = params.coeffs()

    def pair_energy(r2, d_i, d_j):
        return _pair_energy(r2, _sigma_ij(d_i, d_j, params.eps), params,
                            *coeffs)

    def rcut2_of(d_i, d_j):
        return (params.xc * _sigma_ij(d_i, d_j, params.eps)) ** 2

    # sigma_ij <= max(d_i, d_j): the non-additive term only shrinks it
    rcut_max = params.xc * params.d_max
    return pair_energy, rcut2_of, rcut_max


#: the row sweep of a displacement and a diameter swap (a lone displacement
#: has no kernel, in the reference as here; at N = 1 the reference's kernel
#: draws j = -1, the port leaves that pool to the generic path), the cell path
FAMILY = MoveFamily(
    roles={"poly_displacement_2d": "disp", "poly_swap": "swap",
           "poly_volume": "vol"},
    row=functools.partial(_lj._pair_rows, module=poly_sweep, attr="diam",
                          kinds=("poly_displacement_2d", "poly_swap"),
                          names=(None, "poly_mixed_sweep"), min_n=2),
    cell=lambda params: CellModel(*cell_closures(params), swap_mode="pair",
                                  attr="diam"))


# ---------------------------------------------------------------------------
# Event-chain MC for the smoothed IPL potential (exact factor events)
# ---------------------------------------------------------------------------

def ecmc_model(chain_length: float, params: PolyParams = PolyParams(),
               max_events_per_chain: int = 512, bisect_iters: int = 26,
               check_every: int = CHECK_EVERY):
    """Straight event chains for the polydisperse smoothed-IPL mixture.

    The factorized scheme of ``lennard_jones.ecmc_model``, simplified by
    monotonicity: the smoothed IPL-12 is purely repulsive, so a factor's
    cumulative uphill energy is nonzero only while approaching,
    ``E(s) = u(r(s)) - u(r0)``, and saturates at the impact parameter,
    ``E_max = u(b) - u(r0)``.  The inversion ``u(r_ev) = u(r0) + dE`` has no
    closed form (the C2-smoothing polynomial), so it runs ``bisect_iters``
    bisection steps on the bracket [b^2, min(r0, rc)^2] over every pair at
    once.  Receding pairs never fire, so the ``excess`` statistic (signed
    separation at the event) is positive, and
    ``beta P / rho = 1 + <excess per chain> / chain_length``.
    ``check_every`` is the loop's
    :func:`~montecarlo_tpu_torch.core.ecmc.event_loop` interval; it changes
    no result."""

    c0, c2, c4 = params.coeffs()
    rcut_max = params.xc * params.d_max
    xc2 = params.xc ** 2

    def event_step(state, lift, draws):
        pos0, box, beta = state.pos, state.box, state.beta
        n, dim = pos0.shape[1:]
        s_cap = torch.clamp(box / 2.0 - rcut_max, min=0.0)
        a0, d = draws.start(n, dim)
        geo = StraightChain(pos0, d, box)

        def body(carry, i):
            pos, a, budget, ncoll, niter, excess = carry
            mask_a, p, rel = geo.active(pos, a)
            d_a = geo.at(state.diam, a)
            rel = geo.min_image(rel)
            along = geo.along(rel)
            r0sq = squared_norm(rel)
            w2 = torch.clamp(r0sq - along * along, min=0.0)

            sig = _sigma_ij(d_a[:, None], state.diam, params.eps)
            sig2 = torch.clamp(sig * sig, min=1e-12)

            def u_r2(r2):
                x2 = r2 / sig2
                inv2 = 1.0 / torch.clamp(x2, min=1e-12)
                inv12 = inv2 * inv2 * inv2
                inv12 = inv12 * inv12
                u = inv12 + c0 + c2 * x2 + c4 * x2 * x2
                return torch.where(x2 < xc2, u, 0.0)

            d_e = -torch.log(draws.thresholds(i, n)) / beta[:, None]
            approaching = along > 0.0
            v = u_r2(r0sq) + d_e                      # target energy
            e_max = u_r2(w2)                          # u at impact parameter
            fires = approaching & (v < e_max) & ~mask_a

            # bisection for u(r_ev) = v on [b, min(r0, rc)] (u decreasing)
            lo = w2
            hi = torch.minimum(r0sq, xc2 * sig2)
            for _ in range(bisect_iters):
                mid = 0.5 * (lo + hi)
                gt = u_r2(mid) >= v
                lo, hi = torch.where(gt, mid, lo), torch.where(gt, hi, mid)
            r_ev2 = 0.5 * (lo + hi)
            s_j = along - torch.sqrt(torch.clamp(r_ev2 - w2, min=0.0))
            s_j = torch.where(fires, torch.clamp(s_j, min=0.0), torch.inf)

            s_min, j_star = geo.first_hit(s_j)
            limit = torch.minimum(budget, s_cap)
            hit = s_min < limit
            s = torch.minimum(s_min, limit)
            pos = geo.advance(pos, mask_a, p, s)
            a = torch.where(hit, j_star, a)
            excess = excess + torch.where(hit, geo.at(along, j_star) - s,
                                          0.0)
            return (pos, a, budget - s, ncoll + hit.to(torch.int32),
                    niter + 1, excess)

        pos, stats = run_chain(body, pos0, a0, chain_length,
                               max_events_per_chain, check_every)
        return dataclasses.replace(state, pos=pos), lift, stats

    def init_lift(state, draws):
        return {}

    return EventChainModel(init_lift=init_lift, event_step=event_step,
                           name="PolyIPLStraightECMC")
