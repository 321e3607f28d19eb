"""Lennard-Jones particle system in 2-D or 3-D (ParticlesMC-style).

Port of ``montecarlo_tpu/models/lennard_jones.py``: the binary Kob-Andersen
mixture with truncated-and-shifted pair energies, the local displacement
move and the species-swap move, each with an O(N) incremental ΔE against
the energy cached in the state, the isotropic ln-V volume move of the NPT
ensemble with its observables (virial pressure, density), and the closures
the checkerboard cell-MC path takes (:func:`cell_closures`).  Every
function works on all chains at once: positions are one (M, N, dim) tensor,
and the spatial dimension is read from it (``init_chains(dim=3)`` gives
3-D states).

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
from ..ops import lj_sweep
from ..ops.cell_mc import CellModel
from ..ops.lj_energy import lj_total_energy
from ..utils import prng
from ..utils.device import resolve_device
from ..utils.tree import tree_leaves

__all__ = [
    "LJState",
    "LJParams",
    "make_system",
    "init_chains",
    "lj_displacement_move",
    "lj_swap_move",
    "lj_volume_move",
    "total_energy",
    "virial_pressure",
    "callback_energy_per_particle",
    "callback_pressure",
    "callback_density",
    "cell_closures",
    "ecmc_model",
]


@dataclasses.dataclass(frozen=True)
class LJState:
    """Chain-batched state."""
    pos: torch.Tensor       # (M, N, dim) positions in [0, L)
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
    (M, dim) to its particles."""
    d = pos - x[:, None, :]
    b = box[:, None, None]
    d = d - b * torch.round(d / b)
    return torch.sum(d * d, dim=-1)


def _row_energy(state: LJState, x, s_i, mask, params: LJParams):
    """(M,) interaction energy of a (virtual) particle at ``x`` (M, dim) with
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
        d = pos[:, None, :, :] - pos[:, idx, None, :]       # (M, R, N, dim)
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


def _lj_energies(state, params, row_batch, pair_budget):
    """:func:`total_energy` of every chain.  A 2-D float32 state on the card
    takes the CUDA kernel (``ops/lj_energy.py``): every chain in one call,
    with no pair tensors, so neither bound applies; any other state takes
    :func:`_energies`."""
    pos = state.pos
    if pos.is_cuda and pos.dtype == torch.float32 and pos.shape[-1] == 2:
        return lj_total_energy(pos, state.species, state.box, params)
    return _energies(state, params, row_batch, pair_budget)


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
        # revalidate the incremental-ΔE energy cache (float drift bound); off
        # the kernel's path row- and chain-batched so many chains at large N
        # stay bounded
        n = state.pos.shape[-2]
        rb = None if n <= 256 else 64
        return dataclasses.replace(
            state, energy=_lj_energies(state, params, rb, 2 ** 24))

    return SystemDef(name="LennardJones2D", log_target=log_target,
                     frame=frame, format_frame=format_frame,
                     refresh=refresh)


def _lattice(n_particles: int, box: float, dim: int):
    """(N, dim) centres of the square or cubic lattice that fills ``box``
    row by row, as the reference lays it out (``np.meshgrid``'s default
    indexing), and the lattice spacing."""
    side = int(np.ceil(n_particles ** (1.0 / dim)))
    spacing = box / side
    axes = [np.arange(side)] * dim
    grid = np.stack(np.meshgrid(*axes), axis=-1).reshape(-1, dim)
    return (grid[:n_particles] + 0.5) * spacing, spacing


def _jittered(base, spacing_amp, n_chains, box, seed, device):
    """(M, N, dim) lattice ``base`` plus a uniform jitter in
    ``[-spacing_amp, spacing_amp)`` per coordinate, drawn from
    ``jax.random.key(seed)``'s stream as the reference draws it, wrapped
    into the box."""
    n, dim = base.shape
    jitter = spacing_amp * prng.uniform(
        prng.key(seed, device), (n_chains, n, dim), minval=-1.0, maxval=1.0)
    return (torch.as_tensor(base, dtype=torch.float32, device=device)[None]
            + jitter) % box


def _full_batching(n: int):
    """(row_batch, pair_budget) of a full energy pass outside the refresh
    (initial energies, volume moves): dense up to N 1024, else 256 rows a
    pass, ~1.3e8 pair terms a chain batch, as the reference sizes its
    initial energies."""
    return (None if n <= 1024 else 256), 2 ** 27


def init_chains(n_chains: int, n_particles: int, rho: float, beta: float,
                frac_b: float = 0.0, seed: int = 42,
                params: LJParams = LJParams(), device=None,
                dim: int = 2) -> LJState:
    """Chain-stacked initial state: square (``dim=2``) or cubic (``dim=3``)
    lattice + small jitter (avoids overlaps), species assigned round-robin
    to hit ``frac_b``.  The jitter is the reference's draw from ``seed``, so
    the JAX package's ``init_chains`` gives the same positions.  The chains
    are made on ``device``, the card (``cuda``) when it is None."""
    device = resolve_device(device)
    box = float((n_particles / rho) ** (1.0 / dim))
    base, spacing = _lattice(n_particles, box, dim)

    n_b = int(round(frac_b * n_particles))
    species = np.zeros(n_particles, np.int32)
    if n_b:
        species[np.linspace(0, n_particles - 1, n_b).astype(int)] = 1

    state = LJState(
        pos=_jittered(base, 0.1 * spacing, n_chains, box, seed, device),
        species=torch.as_tensor(species, device=device).expand(
            n_chains, n_particles).contiguous(),
        beta=torch.full((n_chains,), beta, dtype=torch.float32,
                        device=device),
        energy=torch.zeros((n_chains,), dtype=torch.float32, device=device),
        box=torch.full((n_chains,), box, dtype=torch.float32, device=device),
    )
    return dataclasses.replace(
        state, energy=_lj_energies(state, params,
                                   *_full_batching(n_particles)))


# ---------------------------------------------------------------------------
# Moves
# ---------------------------------------------------------------------------

class GaussianDisplacement2D(Policy):
    """Uniform particle pick + isotropic Gaussian displacement.

    The particle-selection factor 1/N is identical forward/backward and the
    Gaussian is symmetric, so logq_f == logq_b — both are still computed by
    the generic step and cancel in the ratio.
    """

    def sample(self, params, key, state):
        ki, kd = prng.split(key).unbind(-2)
        _, n, d = state.pos.shape
        i = prng.randint(ki, (), 0, n, dtype=torch.int64)
        delta = params["sigma"][..., None] * prng.normal(kd, (d,))
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
                 kind="lj_displacement_2d", aux=params, family=FAMILY)
    return Move(move=md,
                params={"sigma": torch.tensor(sigma, dtype=torch.float32)},
                weight=weight)


class UniformPairSwap(Policy):
    """Pick an (A, B) pair uniformly; proposal is symmetric (self-inverse),
    so logq_f == logq_b by construction."""

    def sample(self, params, key, state):
        ki, kj = prng.split(key).unbind(-2)
        n = state.species.shape[1]
        is_b = state.species == 1
        n_b = torch.sum(is_b, dim=1)
        n_a = n - n_b
        ka = prng.randint(ki, (), 0, torch.clamp(n_a, min=1))
        kb = prng.randint(kj, (), 0, torch.clamp(n_b, min=1))
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
                 kind="lj_swap", aux=params, family=FAMILY)
    return Move(move=md, params={"dummy": torch.zeros(())}, weight=weight)


def callback_energy_per_particle(view):
    n = view.sys.pos.shape[-2]
    return torch.mean(view.sys.energy) / n


@functools.lru_cache(maxsize=None)
def cell_closures(params: LJParams):
    """(pair_energy, rcut2_of, rcut_max) for the checkerboard cell-MC path
    (``ops/cell_mc.py``): the pair energy of :func:`total_energy` on the
    species labels as float32 attributes; the caller gates the cutoff with
    ``rcut2_of``."""

    def pair_energy(r2, s_i, s_j):
        eps, sig = params.coeffs(s_i, s_j)
        return _pair_energy(r2, eps, sig, params.rcut)

    def rcut2_of(s_i, s_j):
        _, sig = params.coeffs(s_i, s_j)
        return (params.rcut * sig) ** 2

    rcut_max = params.rcut * float(np.max(np.asarray(params.sig)))
    return pair_energy, rcut2_of, rcut_max


def _pair_rows(pool, state0, mesh, interpret, module, attr, kinds, names,
               min_n=1):
    """``MoveFamily.row`` of 2-D pools of the displacement ``kinds[0]``, in
    ``module``'s ``fused_<names[0]>``, or with the swap ``kinds[1]`` of the
    ``attr`` leaf in ``fused_<names[1]>`` (``sharded_*`` on a mesh), from
    ``min_n`` to ``MAX_PARTICLES`` particles.  One box for all chains, as
    the reference passes ``sys.box[0]``: read here, once."""
    tags = [m.move.kind for m in pool]
    name = names[len(pool) - 1] if len(pool) <= 2 and sorted(tags) == \
        sorted(kinds[:len(pool)]) else None
    pos = getattr(state0, "pos", None)
    if (name is None or pos is None or pos.shape[-1] != 2
            or pos.shape[-2] < min_n
            or any(m.move.aux != pool[0].move.aux for m in pool)
            or not interpret and pos.shape[-2] > lj_sweep.MAX_PARTICLES):
        return None
    disp = tags.index(kinds[0])
    aux = pool[disp].move.aux
    weights = np.asarray([m.weight for m in pool], np.float32)
    w_disp = (float(weights[disp] / weights.sum()),) if len(pool) == 2 else ()
    box = float(state0.box.reshape(-1)[0])
    name = ("sharded_" if mesh else "fused_") + name

    def run(sys, params, seed, micro_t0, n_steps):
        # the entry point looked up at each call, as a test may replace it
        out = getattr(module, name)(
            *mesh, sys.pos, getattr(sys, attr), sys.beta, sys.energy, box,
            tree_leaves(params[disp])[0], *w_disp, seed, micro_t0, n_steps,
            params=aux, interpret=interpret)
        if not w_disp:                          # (pos, energy, accepted)
            acc = out[2][:, None]
            out = (out[0], getattr(sys, attr), out[1], acc,
                   torch.full_like(acc, n_steps))
        pos, a, energy, acc, tot = out
        # (M, kind, [accepted, attempted]), kinds in the pool's order
        inc = torch.stack([acc, tot], dim=-1)
        return (dataclasses.replace(sys, pos=pos, energy=energy,
                                    **{attr: a}),
                inc.flip(1) if disp == 1 else inc)

    return run


FAMILY = MoveFamily(
    roles={"lj_displacement_2d": "disp", "lj_swap": "swap",
           "lj_volume": "vol"},
    row=functools.partial(_pair_rows, module=lj_sweep, attr="species",
                          kinds=("lj_displacement_2d", "lj_swap"),
                          names=("lj_sweep", "lj_mixed_sweep")),
    cell=lambda params: CellModel(*cell_closures(params), swap_mode="species",
                                  attr="species", kernel_params=params))


def virial_pressure(state: LJState, params: LJParams = LJParams(),
                    row_batch: int = None):
    """(M,) instantaneous virial pressure of each chain (any dimension d).

    ``P = rho / beta + W / (d V)`` with the pair virial
    ``w(r) = -r du/dr = 24 eps [2 (sig/r)^12 - (sig/r)^6]`` summed over the
    pairs inside the cutoff: exact for the truncated-and-shifted potential
    the sampler targets (no impulsive cutoff term, no tail correction).
    ``row_batch`` bounds peak memory to ``M x row_batch x N`` pair terms.
    """
    pos, spc, box = state.pos, state.species, state.box
    m, n, dim = pos.shape
    cols = torch.arange(n, device=pos.device)
    step = n if row_batch is None or row_batch >= n else row_batch
    w_sum = 0.0
    for start in range(0, n, step):
        idx = cols[start:start + step]
        d = pos[:, None, :, :] - pos[:, idx, None, :]       # (M, R, N, dim)
        b = box.reshape(-1, 1, 1, 1)
        d = d - b * torch.round(d / b)
        r2 = torch.sum(d * d, dim=-1)
        eps, sig = params.coeffs(spc[:, idx, None], spc[:, None, :])
        rc2 = (params.rcut * sig) ** 2
        inv = sig * sig / torch.clamp(r2, min=1e-12)
        i6 = inv * inv * inv
        w = torch.where(r2 < rc2, 24.0 * eps * (2.0 * i6 * i6 - i6), 0.0)
        w = torch.where(idx[:, None] == cols[None, :], 0.0, w)
        w_sum = w_sum + torch.sum(w, dim=(1, 2))
    v = box ** dim
    return (n / v) / state.beta + 0.5 * w_sum / (dim * v)


def callback_pressure(view, params: LJParams = LJParams()):
    """Mean instantaneous virial pressure over chains (NVT observable),
    row-batched beyond N 1024."""
    n = view.sys.pos.shape[-2]
    rb = None if n <= 1024 else 256
    return torch.mean(virial_pressure(view.sys, params, row_batch=rb))


# ---------------------------------------------------------------------------
# NPT ensemble: volume moves
# ---------------------------------------------------------------------------

class UniformLogVolume(Policy):
    """Symmetric uniform step in ln V (the standard NPT volume proposal)."""

    def sample(self, params, key, state):
        return params["dlnv"] * prng.uniform(key, (), minval=-1.0,
                                             maxval=1.0)

    def log_density(self, params, action, state):
        return (-torch.log(2.0 * params["dlnv"])).expand(action.shape)


def _volume_move(name, kind, energies, dlnv, pressure, weight, params,
                 family):
    """An isotropic ln-V move whose full energy is ``energies(state, params,
    row_batch, pair_budget)``: the box edge and every position scale by
    ``exp(delta / dim)``, the energy is recomputed in full (O(N^2): volume
    moves are scheduled rarely), and

        dlog pi = -beta (dE + P dV) + (N + 1) delta.

    ``aux`` carries (interaction table, pressure): the cell-MC planner needs
    the pressure for its volume substeps."""

    def apply(state, delta):
        n, dim = state.pos.shape[-2:]
        scale = torch.exp(delta / dim)
        new = dataclasses.replace(state, pos=state.pos * scale[:, None, None],
                                  box=state.box * scale)
        e_new = energies(new, params, *_full_batching(n))
        d_e = e_new - state.energy
        d_v = state.box ** dim * (torch.exp(delta) - 1.0)
        dlogp = -state.beta * (d_e + pressure * d_v) + (n + 1) * delta
        return dataclasses.replace(new, energy=e_new), dlogp

    def invert(delta, new_state):
        return -delta

    def reward(delta, new_state):
        return delta * delta

    md = MoveDef(name=name, policy=UniformLogVolume(), apply=apply,
                 invert=invert, reward=reward, kind=kind,
                 aux=(params, float(pressure)), family=family)
    return Move(move=md,
                params={"dlnv": torch.tensor(dlnv, dtype=torch.float32)},
                weight=weight)


def lj_volume_move(dlnv: float, pressure: float, weight: float = 1.0,
                   params: LJParams = LJParams()) -> Move:
    """Isotropic volume-scaling move: the NPT ensemble (``_volume_move``).
    In the ideal-gas limit (eps = 0) ``<V> = (N + 1) / (beta P)``
    exactly."""
    return _volume_move("LJVolume", "lj_volume", _lj_energies, dlnv,
                        pressure, weight, params, FAMILY)


def callback_density(view):
    """Mean number density N / V over chains (NPT observable)."""
    n, d = view.sys.pos.shape[-2:]
    return torch.mean(n / view.sys.box ** d)


# ---------------------------------------------------------------------------
# Event-chain MC for the soft LJ potential (exact factor events)
# ---------------------------------------------------------------------------

def ecmc_model(chain_length: float, params: LJParams = LJParams(),
               max_events_per_chain: int = 512,
               check_every: int = CHECK_EVERY):
    """Straight event chains for the truncated-and-shifted LJ mixture.

    Factorized-Metropolis ECMC (Peters & de With 2012; Michel, Kapfer &
    Krauth 2014): each pair (i, j) is a factor whose event fires when the
    cumulative uphill energy of that pair along the active particle's path
    reaches an Exp(1)/beta threshold.  For straight-line motion past a
    radial potential the uphill energy is piecewise monotone in r, and the
    truncated-shifted LJ inverts in closed form on each branch
    (``4 eps (y^2 - y - c0) = v`` with ``y = (sigma/r)^6`` is a quadratic),
    so one O(N) pass per iteration gives every factor's exact event
    distance:

    - approach (along > 0): the most uphill is ``E1 = u(b) - u(a1)`` with
      impact parameter ``b`` and ``a1 = min(r0, r_m)``, ``r_m = 2^(1/6)
      sigma``; a threshold below E1 fires on the core branch at
      ``s = along - sqrt(r_ev^2 - w^2)``;
    - recede: the climb out of the well from ``a2 = max(b or r0, r_m)`` to
      the cutoff, ``E2 = -u(a2)``, fires on the outer branch at
      ``s = along + sqrt(r_ev^2 - w^2)``;
    - otherwise the factor cannot fire before the pair leaves range.

    An iteration's advance is capped at ``box/2 - rcut`` so min-image
    coordinates stay unambiguous; drawing the thresholds anew after an
    advance with no event is exact by the memorylessness of the
    exponential.  The lifting transfers to the arg-min factor.  The cached
    ``state.energy`` is not tracked (the system's ``refresh`` revalidates it
    at every observation point).  ``check_every`` is the loop's
    :func:`~montecarlo_tpu_torch.core.ecmc.event_loop` interval; it changes
    no result.

    Statistics: ``t``, ``chains``, ``collisions`` (lifting transfers),
    ``cap_hits`` (keep at 0) and ``excess``, the sum of signed
    along-direction separations at lifting events, for the pressure
    estimator ``beta P / rho = 1 + <excess per chain> / chain_length``."""

    rcut_max = params.rcut * float(np.max(np.asarray(params.sig)))
    xc2 = 1.0 / (params.rcut * params.rcut)     # (sigma / rcut_ij)^2
    xc6 = xc2 * xc2 * xc2
    # u_ts(r) = 4 eps [(sig/r)^12 - (sig/r)^6] - c_eps,  c_eps = 4 eps c0
    c0 = xc6 * xc6 - xc6                        # (negative) shift / (4 eps)

    def u_ts(r2, eps, sig):
        """Truncated-shifted LJ on squared distance, no cutoff gate."""
        q = sig * sig / torch.clamp(r2, min=1e-12)
        y = q * q * q
        return 4.0 * eps * (y * y - y - c0)

    def event_step(state, lift, draws):
        pos0, box, beta = state.pos, state.box, state.beta
        n, dim = pos0.shape[1:]
        # the advance cap keeps min-image coordinates unambiguous; a box
        # below 2 rcut_max deadlocks into the iteration cap (cap_hits)
        s_cap = torch.clamp(box / 2.0 - rcut_max, min=0.0)
        a0, d = draws.start(n, dim)
        geo = StraightChain(pos0, d, box)

        def body(carry, i):
            pos, a, budget, ncoll, niter, excess = carry
            mask_a, p, rel = geo.active(pos, a)
            s_a = geo.at(state.species, a)
            rel = geo.min_image(rel)                       # signed
            along = geo.along(rel)
            r0sq = squared_norm(rel)
            w2 = torch.clamp(r0sq - along * along, min=0.0)
            r0 = torch.sqrt(r0sq)
            b = torch.sqrt(w2)

            eps, sig = params.coeffs(s_a[:, None], state.species)
            r_m = (2.0 ** (1.0 / 6.0)) * sig
            rc = params.rcut * sig
            u_rm = 4.0 * eps * (-0.25 - c0)               # u_ts at r_m

            approaching = along > 0.0
            d_e = -torch.log(draws.thresholds(i, n)) / beta[:, None]

            # approach branch: uphill from a1 = min(r0, r_m) down to b
            a1 = torch.minimum(r0, r_m)
            u_a1 = torch.where(r0 < r_m, u_ts(r0 * r0, eps, sig), u_rm)
            e1_max = torch.where(approaching & (b < a1),
                                 u_ts(b * b, eps, sig) - u_a1, 0.0)
            # recede branch: uphill from a2 = max(b or r0, r_m) to cutoff
            rr = torch.where(approaching, b, r0)
            a2 = torch.maximum(rr, r_m)
            u_a2 = torch.where(rr > r_m, u_ts(rr * rr, eps, sig), u_rm)
            e2_max = torch.where(a2 < rc, -u_a2, 0.0)

            in_core = approaching & (d_e < e1_max)
            d_e2 = d_e - torch.where(approaching, e1_max, 0.0)
            in_outer = ~in_core & (d_e2 < e2_max)

            def invert(v, sign):
                # 4 eps (y^2 - y - c0) = v  =>  y^2 - y - (c0 + v/4eps) = 0
                disc = torch.sqrt(torch.clamp(1.0 + 4.0 * c0 + v / eps,
                                              min=0.0))
                y = torch.clamp((1.0 + sign * disc) / 2.0, min=1e-12)
                return sig * y ** (-1.0 / 6.0)

            r_core = invert(u_a1 + d_e, +1.0)
            r_outer = invert(u_a2 + d_e2, -1.0)
            s_core = along - torch.sqrt(
                torch.clamp(r_core * r_core - w2, min=0.0))
            s_outer = along + torch.sqrt(
                torch.clamp(r_outer * r_outer - w2, min=0.0))
            s_j = torch.where(in_core, s_core,
                              torch.where(in_outer, s_outer, torch.inf))
            s_j = torch.where(mask_a, torch.inf, torch.clamp(s_j, min=0.0))

            s_min, j_star = geo.first_hit(s_j)
            limit = torch.minimum(budget, s_cap)
            hit = s_min < limit
            s = torch.minimum(s_min, limit)
            pos = geo.advance(pos, mask_a, p, s)
            a = torch.where(hit, j_star, a)
            # the signed separation along e at the event (the pair moved s
            # closer by then): the MKK pressure excess
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
                           name="LJStraightECMC")
