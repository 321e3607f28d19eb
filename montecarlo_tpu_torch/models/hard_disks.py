"""Hard disks (2-D) and hard spheres (3-D): uniform measure over
non-overlapping configurations.

Port of ``montecarlo_tpu/models/hard_disks.py``: disks or spheres of
diameter 1 in a periodic square or cubic box, sampled by the generic
Metropolis path (:func:`displacement_move`: a uniform square proposal, any
overlap a certain rejection; :func:`volume_move`: the hard-core NPT ln-V
move), at large N by the checkerboard cell-MC path (:func:`cell_closures`:
the hard core as an infinite energy wall), or by straight event chains
(:func:`ecmc_model`, with the pressure estimator :func:`ecmc_pressure`).
Every function works on all chains at once: positions are one (M, N, dim)
tensor.  :func:`psi6` stays 2-D, as in the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.ecmc import (CHECK_EVERY, EventChainModel, StraightChain,
                         run_chain, squared_norm)
from ..core.moves import Move, MoveDef, MoveFamily, Policy
from ..core.system import SystemDef
from ..ops.cell_mc import CellModel
from ..utils import prng
from ..utils.device import resolve_device
from .lennard_jones import UniformLogVolume, _jittered, _lattice

__all__ = [
    "HardDiskState",
    "make_system",
    "init_chains",
    "displacement_move",
    "volume_move",
    "min_pair_distance",
    "overlap_free",
    "callback_min_distance",
    "psi6",
    "callback_psi6",
    "cell_closures",
    "ecmc_model",
    "ecmc_pressure",
]

_DIAM = 1.0          # disk diameter (unit of length)
_ROW_BATCH = 256     # rows per pass of the O(N^2) observables above N 1024


@dataclasses.dataclass(frozen=True)
class HardDiskState:
    """Chain-batched state."""
    pos: torch.Tensor    # (M, N, dim) centers in [0, L)
    box: torch.Tensor    # (M,) box edge L


def make_system() -> SystemDef:
    def log_target(state: HardDiskState):
        # uniform over valid configurations; the moves enforce the hard core
        return torch.zeros(state.pos.shape[0], dtype=torch.float32,
                           device=state.pos.device)

    def frame(state: HardDiskState):
        return state.pos

    def format_frame(t, pos):
        n, d = pos.shape
        lines = [f"{t} {n}"]
        for k in range(n):
            lines.append(" ".join(repr(float(pos[k, a]))
                                  for a in range(d)))
        return "\n".join(lines)

    return SystemDef(name="HardDisks2D", log_target=log_target, frame=frame,
                     format_frame=format_frame)


def init_chains(n_chains: int, n_disks: int, eta: float, seed: int = 42,
                device=None, dim: int = 2) -> HardDiskState:
    """Square (``dim=2``) or cubic (``dim=3``: hard spheres) lattice start
    at packing fraction ``eta`` (area fraction in 2-D, volume fraction in
    3-D; the lattice must have no overlap: eta < pi/4 ~ 0.785 in 2-D,
    < pi/6 ~ 0.524 in 3-D), each particle jittered uniformly by up to 0.45
    of the lattice's free spacing.  The jitter is the reference's draw
    from ``seed``, so the JAX package's ``init_chains`` gives the same
    positions.  The chains are made on ``device``, the card (``cuda``)
    when it is None."""
    device = resolve_device(device)
    if dim == 2:
        content = n_disks * np.pi * (_DIAM / 2) ** 2
    else:
        content = n_disks * (np.pi / 6.0) * _DIAM ** 3
    box = float((content / eta) ** (1.0 / dim))
    base, spacing = _lattice(n_disks, box, dim)
    if spacing < _DIAM:
        raise ValueError(f"eta={eta} too dense for a lattice start")
    pos = _jittered(base, 0.45 * (spacing - _DIAM), n_chains,
                    box, seed, device)
    return HardDiskState(pos=pos, box=torch.full(
        (n_chains,), box, dtype=torch.float32, device=device))


# -- geometry ---------------------------------------------------------------

def _rows_d(state: HardDiskState, rows):
    """(M, R, N, dim) min-image displacements from particles ``rows`` to
    all."""
    b = state.box[:, None, None, None]
    d = state.pos[:, rows, None, :] - state.pos[:, None, :, :]
    return d - b * torch.round(d / b)


def _row_slices(n: int, row_batch):
    if row_batch is None and n > 1024:
        row_batch = _ROW_BATCH
    step = n if row_batch is None or row_batch >= n else row_batch
    return [slice(s, min(s + step, n)) for s in range(0, n, step)]


def min_pair_distance(state: HardDiskState, row_batch: int = None):
    """(M,) minimum min-image center distance over all pairs of each chain.

    ``row_batch`` bounds peak memory to ``M x row_batch x N`` pair terms;
    it defaults to 256 rows beyond N = 1024, as in the reference."""
    n = state.pos.shape[1]
    cols = torch.arange(n, device=state.pos.device)
    best = None
    for rows in _row_slices(n, row_batch):
        d = _rows_d(state, rows)
        r2 = torch.sum(d * d, dim=-1)
        r2 = torch.where(cols[rows, None] == cols[None, :], torch.inf, r2)
        m = torch.amin(r2, dim=(1, 2))
        best = m if best is None else torch.minimum(best, m)
    return torch.sqrt(best)


def overlap_free(state: HardDiskState, tol: float = 1e-5):
    """(M,) True where no two disks of the chain overlap."""
    return min_pair_distance(state) >= _DIAM - tol


def callback_min_distance(view):
    return torch.mean(min_pair_distance(view.sys))


def psi6(state: HardDiskState, r_nbr: float = 1.4, row_batch: int = None):
    """(M,) global bond-orientational order |<psi6>| of each chain.

    ``psi6_j = mean_k exp(6 i theta_jk)`` over neighbours within ``r_nbr``;
    returns ``|mean_j psi6_j|`` (Bernard & Krauth 2011).  Row-batched
    beyond N = 1024 like :func:`min_pair_distance`."""
    n = state.pos.shape[1]
    pc, ps = [], []
    for rows in _row_slices(n, row_batch):
        d = _rows_d(state, rows)
        r2 = torch.sum(d * d, dim=-1)
        # self-pairs have r2 == 0 exactly; exclude them by distance
        nbr = (r2 < r_nbr * r_nbr) & (r2 > 1e-12)
        theta = torch.atan2(d[..., 1], d[..., 0])
        c = torch.where(nbr, torch.cos(6.0 * theta), 0.0)
        s = torch.where(nbr, torch.sin(6.0 * theta), 0.0)
        cnt = torch.clamp(torch.sum(nbr, dim=2), min=1)
        pc.append(torch.sum(c, dim=2) / cnt)
        ps.append(torch.sum(s, dim=2) / cnt)
    return torch.sqrt(torch.mean(torch.cat(pc, 1), dim=1) ** 2
                      + torch.mean(torch.cat(ps, 1), dim=1) ** 2)


def callback_psi6(view):
    """Chain-mean |psi6| (the slow orientational observable)."""
    return torch.mean(psi6(view.sys))


def cell_closures():
    """(pair_energy, rcut2_of, rcut_max) for the checkerboard cell-MC path
    (``ops/cell_mc.py``).

    The hard core is an INFINITE energy wall: an overlapping proposal has
    ``-beta dE = -inf``, and ``log(u) < -inf`` is False for every uniform
    draw, the exact 0.0 included (whose ``log`` is also ``-inf``; a finite
    wall such as 1e30 would accept there, about once per 2^23 attempts).
    The current configuration is overlap-free, so the old energy is exactly
    0 and no NaN arises.  Attributes are unused (pass zeros)."""

    def pair_energy(r2, a_i, a_j):
        return torch.full_like(r2, torch.inf)

    def rcut2_of(a_i, a_j):
        return _DIAM * _DIAM

    return pair_energy, rcut2_of, _DIAM


_CELL_MODEL = CellModel(*cell_closures(), proposal="square")
FAMILY = MoveFamily(roles={"hard_disk_displacement_2d": "disp",
                           "hard_disk_volume": "vol"},
                    cell=lambda aux: _CELL_MODEL)


# -- Metropolis displacement move ------------------------------------------

class UniformSquare(Policy):
    """Uniform particle pick + uniform square displacement (symmetric)."""

    def sample(self, params, key, state):
        ki, kd = prng.split(key).unbind(-2)
        _, n, d = state.pos.shape
        i = prng.randint(ki, (), 0, n, dtype=torch.int64)
        delta = params["delta"][..., None] * prng.uniform(
            kd, (d,), minval=-1.0, maxval=1.0)
        return {"i": i, "delta": delta}

    def log_density(self, params, action, state):
        m, n, dim = state.pos.shape
        d = params["delta"]
        return (-dim * torch.log(2.0 * d)
                - torch.log(torch.tensor(float(n), dtype=d.dtype))
                ).expand(m)


def displacement_move(delta: float, weight: float = 1.0) -> Move:
    """Local move with hard-core rejection: overlap => dlogp = -inf."""

    def apply(state: HardDiskState, action):
        i, dlt = action["i"], action["delta"]
        n = state.pos.shape[1]
        mask = torch.arange(n, device=state.pos.device)[None, :] == i[:, None]
        old = torch.sum(torch.where(mask[..., None], state.pos, 0.0), dim=1)
        new = torch.remainder(old + dlt, state.box[:, None])
        b = state.box[:, None, None]
        d = state.pos - new[:, None, :]
        d = d - b * torch.round(d / b)
        r2 = torch.sum(d * d, dim=-1)
        overlap = torch.any(~mask & (r2 < _DIAM * _DIAM), dim=1)
        pos = torch.where(mask[..., None], new[:, None, :], state.pos)
        dlogp = torch.where(overlap, -torch.inf, 0.0)
        return dataclasses.replace(state, pos=pos), dlogp

    def invert(action, new_state):
        return {"i": action["i"], "delta": -action["delta"]}

    def reward(action, new_state):
        return torch.sum(action["delta"] ** 2, dim=-1)

    md = MoveDef(name="HardDiskDisplacement", policy=UniformSquare(),
                 apply=apply, invert=invert, reward=reward,
                 kind="hard_disk_displacement_2d", family=FAMILY)
    return Move(move=md,
                params={"delta": torch.tensor(delta, dtype=torch.float32)},
                weight=weight)


# -- NPT volume move ------------------------------------------------------

def volume_move(dlnv: float, beta_pressure: float,
                weight: float = 1.0) -> Move:
    """Isotropic ln-V volume move of the hard-core NPT ensemble (constant-
    pressure hard disks or spheres).  Only the product beta P enters:

        dlog pi = -betaP dV + (N + 1) delta,   overlap => -inf.

    On the cell path it runs as a volume substep: the infinite energy wall
    makes the cell energy at the proposed box exactly 0 (valid) or +inf
    (overlap: a certain rejection)."""

    def apply(state: HardDiskState, delta):
        n, d = state.pos.shape[-2:]
        scale = torch.exp(delta / d)
        new = dataclasses.replace(state, pos=state.pos * scale[:, None, None],
                                  box=state.box * scale)
        overlap = min_pair_distance(new) < _DIAM
        d_v = state.box ** d * (torch.exp(delta) - 1.0)
        dlogp = torch.where(overlap, -torch.inf,
                            -beta_pressure * d_v + (n + 1) * delta)
        return new, dlogp

    def invert(delta, new_state):
        return -delta

    def reward(delta, new_state):
        return delta * delta

    md = MoveDef(name="HardDiskVolume", policy=UniformLogVolume(),
                 apply=apply, invert=invert, reward=reward,
                 kind="hard_disk_volume", aux=(None, float(beta_pressure)),
                 family=FAMILY)
    return Move(move=md,
                params={"dlnv": torch.tensor(dlnv, dtype=torch.float32)},
                weight=weight)


# -- straight event-chain model ---------------------------------------------

def ecmc_model(chain_length: float, max_events_per_chain: int = 256,
               check_every: int = CHECK_EVERY) -> EventChainModel:
    """Straight event chains along the +axis directions (2-D or 3-D: the
    collision geometry only uses the squared perpendicular distance
    ``w2 = r0^2 - along^2``).

    One ``event_step`` runs one full chain on every chain: a fresh (active
    disk, direction) pair is drawn, then the active disk slides and the
    lifting transfers at collisions until the chain's displacement reaches
    ``chain_length``.  Per collision the distances ``s_j`` to every disk
    along the direction are one O(N) pass — ``s_j = u_j - sqrt(1 - w_j^2)``
    with ``u`` forward-wrapped and ``w`` min-imaged — and a masked min.
    ``max_events_per_chain`` bounds the loop; a chain that hits it stops
    early and counts a ``cap_hits``.  ``check_every`` is the loop's
    :func:`~montecarlo_tpu_torch.core.ecmc.event_loop` interval; it changes
    no result.

    Statistics: ``t`` (displacement), ``chains``, ``collisions``,
    ``cap_hits`` and ``excess``, the sum of projected contact separations
    sqrt(1 - w^2) over collisions, for the pressure estimator
    beta P / rho = 1 + <excess per chain> / chain_length
    (:func:`ecmc_pressure`)."""

    def init_lift(state, draws):
        return {}          # the lifting variables are drawn per chain

    def event_step(state, lift, draws):
        pos0, box = state.pos, state.box
        n, dim = pos0.shape[1:]
        a0, d = draws.start(n, dim)
        geo = StraightChain(pos0, d, box)

        def body(carry, i):
            pos, a, budget, ncoll, niter, excess = carry
            mask_a, p, rel = geo.active(pos, a)
            along = geo.along(rel)
            relm = geo.min_image(rel)
            alongm = geo.along(relm)
            w2 = torch.clamp(squared_norm(relm) - alongm * alongm, min=0.0)
            u = torch.remainder(along, geo.box)            # forward-wrapped
            hittable = ~mask_a & (w2 < _DIAM * _DIAM)
            root = torch.sqrt(torch.clamp(_DIAM * _DIAM - w2, min=0.0))
            s_j = u - root
            # a partner whose s_j rounds to just below 0 is an immediate
            # collision, not one a period later: wrapping it would let the
            # active disk tunnel through (the reference's contact epsilon)
            s_j = torch.where(s_j < -1e-5, s_j + geo.box,
                              torch.clamp(s_j, min=0.0))
            s_j = torch.where(hittable, s_j, torch.inf)
            s_min, j_star = geo.first_hit(s_j)
            hit = s_min < budget
            s = torch.minimum(s_min, budget)
            pos = geo.advance(pos, mask_a, p, s)
            a = torch.where(hit, j_star, a)
            excess = excess + torch.where(hit, geo.at(root, j_star), 0.0)
            return (pos, a, budget - s, ncoll + hit.to(torch.int32),
                    niter + 1, excess)

        pos, stats = run_chain(body, pos0, a0, chain_length,
                               max_events_per_chain, check_every)
        return dataclasses.replace(state, pos=pos), lift, stats

    return EventChainModel(init_lift=init_lift, event_step=event_step,
                           name="HardDiskStraightECMC")


def ecmc_pressure(stats, chain_length: float, burn_excess=None,
                  burn_chains=None):
    """Reduced pressure beta P / rho from accumulated ECMC statistics:
    ``1 + <excess per chain> / chain_length`` (Michel, Kapfer & Krauth
    2014), summed in float64.  Pass the ``ecmc`` slice's ``stats`` (tensors
    or arrays); to discard equilibration, subtract a snapshot
    (``burn_excess``, ``burn_chains``) taken at the end of the burn-in."""

    def total(x):
        if torch.is_tensor(x):
            x = x.detach().cpu().numpy()
        return np.asarray(x, np.float64).sum()

    excess = total(stats["excess"])
    chains = total(stats["chains"])
    if burn_excess is not None:
        excess -= total(burn_excess)
        chains -= total(burn_chains)
    return 1.0 + excess / (chains * chain_length)
