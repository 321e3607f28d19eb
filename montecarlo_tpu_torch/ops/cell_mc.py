"""Checkerboard cell-list Monte Carlo for large-N particle systems (2-D and
3-D, NVT and NPT).

Port of ``montecarlo_tpu/ops/cell_mc.py``.  The row kernels (``lj_sweep``,
``poly_sweep``) cost O(N) a move, and a chain's moves are sequential.  Here
the box is divided into an ``nc^dim`` grid of cells (``nc`` even, >= 4) of
width ``w = box / nc >= rcut + 2 d_cap``, colored in a 2^dim checkerboard:

- In one *substep* every cell of one color proposes a move for ONE
  uniformly picked occupant.  Two active cells are never adjacent, and a
  particle stays within a halo of its storage cell for the whole segment
  (a move leaving the halo is rejected: a symmetric restriction of the
  proposal set), so the simultaneous moves do not interact and the substep
  is a product of independent MH updates.
- A particle's partners within ``rcut`` lie in its 3^dim cell
  neighbourhood, gathered once per substep.
- Positions are stored as fractions of the box, and the grid's origin is
  shifted by a fresh uniform offset per chain at every bind, which keeps
  the halo coverage position-independent across segments.
- Between segments the particles are binned anew (one stable argsort per
  chain).
- **Volume substeps** (optional, NPT): an ln-V rescale per chain on the
  bound state.  Fractional coordinates do not change under the rescale, so
  nothing is re-bound; the full energy at the proposed box is one all-cells
  3^dim-neighbourhood pass, and a box below the grid's validity floor
  ``box_min`` is rejected.  With volume substeps the halo is the fixed
  fraction ``d_cap / box_min`` of the box, so it does not change when a
  volume move is accepted mid-segment (the reference's ``d_cap / box``
  would make the restriction asymmetric there); it is ``d_cap`` or more in
  real units and keeps the geometry valid for every box >= ``box_min``.
  Without volume substeps the halo is ``d_cap / box``, the reference's.

Substeps draw their random numbers from a *draws* object
(:class:`KeyDraws` in a run): the substep-shared variant (kind, color)
sequence on the host, so each substep runs one branch and the host never
waits for the card inside a segment, and the per-cell and per-chain
uniforms and proposals as tensors.  :class:`KeyDraws` derives them from
the segment's threefry key as the reference does (``utils/prng.py``), so a
segment gives the JAX package's numbers from the same key; a test can
feed any other draws.

**Sum order.**  Three sums decide what a segment computes: a move's energy
over its 3^dim neighbourhood (the pair terms against every slot, about
``9 cap`` of them in 2-D), a chain's accepted energy changes over its
active cells in a substep, and the all-cells total energy of a volume
substep.  Each takes its float32 terms, accumulates them in float64
(:data:`ACCUMULATE`) in whatever order the device reduces, and rounds the
sum to float32 once.  An addition is exact while the term's lowest bit
lies within the partial sum's 53 significant bits (a term below about
2^-29 of the partial sum loses bits), so a sum of ``n`` terms is exact in every order while the
terms span less than about 2^(29 - log2 n) in magnitude: 2^21 for a 2-D
neighbourhood's 288.  Past that (LJ terms just inside the cutoff, beside a
close contact) the float64 sums of two orders may differ in their last
bits, and the float32 results then differ only where the sum lies within
that difference of a float32 rounding midpoint.  So the float32 bits that
decide a move, and each chain's energy, do not depend on the reduction's
order but with that small chance, and an independent replay that sums the
same terms in float64 and rounds once reproduces the path bit for bit.
The reference's float32 sums follow XLA's order, so against the JAX package
energies agree to float32 rounding, not bit for bit.

A displacement substep evaluates its pair terms at the new and the old
position in one pass (the probes stacked on a leading axis), a swap its
four rows in one pass; each row is summed on its own, so the stacking
changes no bit and spares the launches of the passes it merges (the
eager substep is bound by the host's launch work).

**Spans and counters** (``utils/observability.py``), under ``mc.advance``:
``mc.cell.bind`` (a segment's grid shift, binning and packing),
``mc.cell.substep`` (one substep) and ``mc.cell.unbind`` (the particles
back in their order, the positions in real units); the run's counters
``cell_binds`` (segments bound) and ``cell_substeps``.

**The substep kernel.**  The displacement and species-swap substeps of
2-D Lennard-Jones chains with float32 state on a CUDA device run in the
hand-written kernel ``csrc/cell_substep.cu`` (:data:`CELL_SUBSTEP_KERNEL`,
entry point ``mc_cell_substep``): one call a substep, every chain and every
active cell of the colour, the packed cells updated in place and the
chains' sums added to the segment's accumulators.  The torch substeps of
:func:`_make_substep` are its plain twin, with the same float32 terms and
float64 sums; they run everything the kernel does not take (the CPU,
float64, 3-D, the polydisperse and hard-disk models, the volume substep).
:func:`cell_mc_segment` decides from what it is given (:func:`_kernel_takes`:
a :class:`CellModel` that carries the kernel's parameters); the reference
has no Pallas kernel here.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import itertools
import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..utils import prng
from ..utils.observability import count, span
from ._cuda import CudaKernel
from .lj_energy import _PairTable, _pair_table

__all__ = ["CellGrid", "plan_grid", "bind_cells", "unbind_cells",
           "cell_total_energy", "cell_mc_segment", "KeyDraws"]

#: the dtype every sum of float32 terms accumulates in before its one
#: rounding to float32 (the module's "Sum order")
ACCUMULATE = torch.float64


def _sum32(x, dim):
    """float32 ``x`` summed over ``dim`` in :data:`ACCUMULATE`, rounded to
    float32 once."""
    return torch.sum(x, dim=dim, dtype=ACCUMULATE).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class CellModel:
    """A particle family's model on the cell path (``MoveFamily.cell``):
    the pair terms ``pair_energy(r2, a_i, a_j)`` and ``rcut2_of(a_i, a_j)``
    on the particles' attributes, the largest cutoff ``rcut_max``, the swap
    substep (:func:`_make_substep`), the ``proposal`` (``"gaussian"`` or
    the hard-disk ``"square"``), the state field ``attr`` the attribute is
    read from (None: no attribute, ``beta`` or ``energy``), and the
    parameters :data:`CELL_SUBSTEP_KERNEL` takes, or None."""

    pair_energy: Callable
    rcut2_of: Callable
    rcut_max: float
    swap_mode: Optional[str] = None
    proposal: str = "gaussian"
    attr: Optional[str] = None
    kernel_params: Any = None

    def leaves(self, sys):
        """A segment's ``(attr, beta, energy)`` of the state ``sys``."""
        if self.attr is not None:
            return (getattr(sys, self.attr).to(torch.float32), sys.beta,
                    sys.energy)
        f32, m = dict(dtype=torch.float32, device=sys.pos.device), len(sys.pos)
        return (torch.zeros(sys.pos.shape[:-1], **f32), torch.ones(m, **f32),
                torch.zeros(m, **f32))

    def update(self, sys, upd, attr, energy):
        """``sys`` with ``upd`` and a segment's ``attr`` and ``energy``."""
        if self.attr is not None:
            upd = {**upd, self.attr: attr.to(getattr(sys, self.attr).dtype),
                   "energy": energy}
        return dataclasses.replace(sys, **upd)


class CellGrid:
    """Static cell-decomposition plan (hashable).

    ``box`` is the *planning* box (used only to choose ``nc``); a chain's
    own box must be at least ``box_min = nc * (rcut + 2 d_cap)``.
    """

    def __init__(self, nc: int, cap: int, box: float, d_cap: float,
                 rcut: float, dim: int = 2):
        self.nc = int(nc)
        self.cap = int(cap)
        self.box = float(box)
        self.dim = int(dim)
        self.w = self.box / self.nc          # planning-box cell width
        self.d_cap = float(d_cap)
        self.rcut = float(rcut)
        self.wmin = self.rcut + 2.0 * self.d_cap
        self.box_min = self.nc * self.wmin   # smallest valid box edge

    def __repr__(self):
        return (f"CellGrid(nc={self.nc}, cap={self.cap}, box={self.box}, "
                f"d_cap={self.d_cap}, rcut={self.rcut}, dim={self.dim})")

    def _key(self):
        return (self.nc, self.cap, self.box, self.d_cap, self.rcut, self.dim)

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return isinstance(other, CellGrid) and self._key() == other._key()


def plan_grid(n_particles: int, box: float, rcut: float,
              d_cap: float = 0.45, cap_slack: float = 2.0, dim: int = 2,
              max_occupancy: int = None, box_margin: float = 0.0) -> CellGrid:
    """Choose the largest even cell grid with ``w >= rcut + 2 d_cap``.

    ``box_margin`` shrinks the box used for planning by that fraction.
    ``cap`` (slots per cell) is the larger of ``mean occupancy x
    cap_slack`` and ``max_occupancy + 2`` (the observed initial per-cell
    maximum, when the caller measured one), rounded up to a multiple of 8.
    Raises if the box only fits a grid smaller than 4 cells per axis (the
    3^dim neighbourhood must hold distinct cells).
    """
    plan_box = box * (1.0 - box_margin)
    nc = int(plan_box / (rcut + 2.0 * d_cap))
    nc -= nc % 2
    if nc < 4:
        raise ValueError(
            f"box {box:.3g} too small for cell MC with rcut {rcut}, "
            f"d_cap {d_cap} and margin {box_margin}: need >= 4 cells per "
            f"axis")
    mean_occ = n_particles / (nc ** dim)
    cap = mean_occ * cap_slack
    if max_occupancy is not None:
        cap = max(cap, max_occupancy + 2.0)
    cap = max(8, int(math.ceil(cap / 8.0)) * 8)
    return CellGrid(nc=nc, cap=cap, box=box, d_cap=d_cap, rcut=rcut,
                    dim=dim)


# ---------------------------------------------------------------------------
# Binding: (M, N, ...) particle tensors <-> (M, ..., nc, ..., C) cell tensors
# ---------------------------------------------------------------------------

def bind_cells(grid: CellGrid, s, attr):
    """Bin every chain's particles (fractional coordinates) into cell slots.

    Args:
      s: (M, N, dim) fractional positions in [0, 1).
      attr: (M, N) per-particle attribute (species label or diameter).

    Returns a dict: ``crd`` (M, dim, nc, ..., C) fractional coordinates,
    ``attr`` (M, nc, ..., C) float32, ``occ`` (bool) and ``idx`` (int32,
    the particle's index, N where the slot is empty), each (M, nc, ..., C),
    and ``overflow`` (M,) bool: some cell of the chain holds more than C
    particles (the caller must treat the chain's segment as invalid).  In
    an overflowing cell the slot C - 1 holds its last particle, as the
    reference's last-write-wins scatter leaves it.
    """
    m, n, dim = s.shape
    nc, cap = grid.nc, grid.cap
    dev = s.device
    ci = torch.clamp((s * nc).to(torch.int32), 0, nc - 1)
    cid = ci[..., 0]
    for a in range(1, dim):
        cid = cid * nc + ci[..., a]
    order = torch.argsort(cid, dim=1, stable=True)
    cid_s = torch.gather(cid, 1, order)
    r = torch.arange(n, device=dev)
    step = cid_s[:, 1:] != cid_s[:, :-1]
    edge = torch.ones((m, 1), dtype=torch.bool, device=dev)
    is_new = torch.cat([edge, step], dim=1)
    is_last = torch.cat([step, edge], dim=1)
    seg_start = torch.cummax(torch.where(is_new, r, 0), dim=1).values
    rank = r - seg_start
    overflow = torch.any(rank >= cap, dim=1)
    n_slots = nc ** dim * cap
    # one writer per slot: a spare column takes the particles the
    # reference's scatter overwrites, so the card's scatter is deterministic
    write = (rank < cap - 1) | is_last
    slot = torch.where(write, cid_s.long() * cap + torch.clamp(rank, max=cap - 1),
                       n_slots)
    shape = (m,) + (nc,) * dim + (cap,)

    def scatter(src, fill):
        out = torch.full((m, n_slots + 1), fill, dtype=src.dtype, device=dev)
        out.scatter_(1, slot, torch.gather(src, 1, order))
        return out[:, :n_slots].reshape(shape)

    return {
        "crd": torch.stack([scatter(s[..., a], 0.0) for a in range(dim)],
                           dim=1),
        "attr": scatter(attr.to(torch.float32), 0.0),
        "occ": scatter(torch.ones((m, n), dtype=torch.bool, device=dev),
                       False),
        "idx": scatter(r.to(torch.int32).expand(m, n), n),
        "overflow": overflow,
    }


def unbind_cells(cells, n: int):
    """Inverse of :func:`bind_cells`: (M, N, dim) fractional positions and
    (M, N) attributes in the ORIGINAL particle order (via ``idx``)."""
    crd = cells["crd"]
    m, dim = crd.shape[:2]
    idx = cells["idx"].reshape(m, -1).long()

    def gather_back(src):
        out = torch.zeros((m, n + 1), dtype=torch.float32, device=crd.device)
        out.scatter_(1, idx, src.reshape(m, -1))
        return out[:, :n]

    s = torch.stack([gather_back(crd[:, a]) for a in range(dim)], dim=-1)
    return s, gather_back(cells["attr"])


# ---------------------------------------------------------------------------
# The substep
# ---------------------------------------------------------------------------
# Inside a segment the cells are one packed float32 tensor P of shape
# (M, dim + 2, nc, ..., C): the fractional coordinates, the attribute and
# the occupancy (1.0 / 0.0), so that one gather builds a color's whole
# neighbourhood.

@functools.lru_cache(maxsize=None)
def _geometry(nc: int, dim: int, parity: tuple, device: str):
    """A color's static geometry: the flat cell index of each active cell's
    3^dim neighbours, (h^dim * 3^dim,) in active-cell order and the
    reference's offset order; and the active cells' fractional origins
    (dim, h, ..., h) (float32, divided as the reference divides)."""
    h = nc // 2
    offsets = list(itertools.product((-1, 0, 1), repeat=dim))
    active = np.stack(np.meshgrid(*[np.arange(h)] * dim, indexing="ij"),
                      axis=-1) * 2 + np.asarray(parity)     # (h, ..., dim)
    nb = (active[..., None, :] + np.asarray(offsets)) % nc  # (..., 3^d, dim)
    flat = np.zeros(nb.shape[:-1], np.int64)
    for a in range(dim):
        flat = flat * nc + nb[..., a]
    origin = np.moveaxis(active.astype(np.float32) / np.float32(nc), -1, 0)
    return (torch.as_tensor(flat.reshape(-1), device=device),
            torch.as_tensor(np.ascontiguousarray(origin), device=device))


def _active(P, parity):
    """View of the active color's cells: (M, F, h, ..., h, C)."""
    return P[(slice(None), slice(None))
             + tuple(slice(p, None, 2) for p in parity)]


def _make_substep(grid: CellGrid, pair_energy, rcut2_of, swap_mode=None,
                  vol=None):
    """Build the one-color multi-move MH substeps over all chains.

    ``pair_energy(r2, a_i, a_j) -> u`` and ``rcut2_of(a_i, a_j) -> rc^2``
    define the model (attributes are the species labels or diameters).

    Returns ``(variants, total_energy)``: ``variants[kind][color]`` is a
    function ``(P, box, sigma, beta, *draws) -> (dE, n_att, n_acc)`` that
    updates the packed cells ``P`` in place and returns per-chain sums
    (``variants[kind]`` is None for a kind the pool lacks); kind 0 is the
    displacement, kind 1 (when ``swap_mode`` is set) the
    within-cell attribute swap: ``"species"`` exchanges the labels of one A
    and one B occupant, ``"pair"`` the diameters of an ordered pair of
    distinct occupants.  Both keep the pick probabilities of the reverse
    swap, and swapped particles never move, so same-color swaps are
    independent by the displacement's geometry.

    ``vol = (n_particles, pressure)`` adds kind 2, ``variants[2][0]``: the
    per-chain ln-V volume substep ``(P, box, energy, dlnv, beta, u_delta,
    u_acc) -> (box', energy', n_att, n_acc)``, with ``u_delta`` uniform in
    [-1, 1).  It also fixes the displacement's halo at ``d_cap / box_min``
    of the box (the module docstring).
    """
    nc, cap, dim = grid.nc, grid.cap, grid.dim
    d_cap = grid.d_cap
    h = nc // 2
    n_off = 3 ** dim
    centre = n_off // 2
    w_f = 1.0 / nc
    parities = tuple(itertools.product((0, 1), repeat=dim))

    def neighbourhood(P, parity):
        """The active cells' 3^dim neighbourhoods, one gather of the packed
        fields: (M, F, h, ..., h, 3^dim * C), offset-major along the slots,
        as the reference concatenates them (on an H100 the gather took
        ~1/14 the time of the reference's large-grid layout, a torus roll
        per offset: ``chip_smoke.py`` phase 7c)."""
        flat, _ = _geometry(nc, dim, parity, str(P.device))
        m, f = P.shape[:2]
        nb = P.reshape(m, f, nc ** dim, cap).index_select(2, flat)
        return nb.reshape((m, f) + (h,) * dim + (n_off * cap,))

    def excl_centre(occ9, sel):
        """``occ9`` with ``sel`` (M, h, ..., C) masked out of the centre
        block (the mover's or the swappers' own slots), in place."""
        blk = occ9[..., centre * cap:(centre + 1) * cap]
        blk &= ~sel
        return occ9

    def dist2(pc, crd9, box2):
        """Squared min-image distances from probes ``pc`` (..., M, dim, h..,
        1; leading axes stack a substep's probes) to the neighbourhood,
        scaled to real units once after the sum."""
        d = crd9 - pc
        d = d - torch.round(d)
        d = d * d
        axis = -(dim + 2)
        r2 = d.select(axis, 0)
        for a in range(1, dim):
            r2 = r2 + d.select(axis, a)
        return r2 * box2

    def energy(r2, pa, as9, ok9):
        """Each probe's neighbourhood energy; ``r2`` and ``pa`` may stack
        several probes on a leading axis, so that one pass of the pair
        terms serves them all."""
        u = pair_energy(r2, pa, as9)
        ok = ok9 & (r2 < rcut2_of(pa, as9))
        return _sum32(torch.where(ok, u, 0.0), -1)

    def pick(sel_idx, act):
        """The fields of each active cell's picked slot: (M, F, h.., 1)."""
        idx = sel_idx.unsqueeze(1).expand(act.shape[:-1] + (1,))
        return torch.gather(act, -1, idx)

    def gumbel_pick(u, mask):
        """One-hot uniform pick among ``mask`` slots (all False where the
        mask is empty), the lowest slot breaking float ties, and the picked
        slot's index."""
        score = torch.where(mask, u, -1.0)
        k = torch.argmax(score, dim=-1, keepdim=True)
        slots = torch.arange(cap, device=u.device)
        return (slots == k) & mask, k

    def chain_view(x):
        return x.reshape((-1,) + (1,) * dim)

    def make_color(parity):
        def color_substep(P, box, sigma, beta, u_pick, draw, u_acc):
            _, origin = _geometry(nc, dim, parity, str(P.device))
            act = _active(P, parity)              # (M, F, h.., C)
            occ_a = act[:, dim + 1] > 0.5
            sel, k = gumbel_pick(u_pick, occ_a)
            has = torch.any(occ_a, dim=-1)
            picked = pick(k, act)
            pi = picked[:, :dim]                  # (M, dim, h.., 1)
            ai = picked[:, dim]                   # (M, h.., 1)
            # fractional displacement, then the anchor halo: the new
            # position must stay within d_cap of the storage cell
            delta = chain_view(sigma / box)[..., None] * draw
            pn = pi + torch.movedim(delta, -1, 1)[..., None]
            d_cap_f = chain_view(torch.full_like(box, d_cap) / (
                box if vol is None else torch.full_like(box, grid.box_min)))
            d_cap_f = d_cap_f[:, None]                # (M, 1, 1..)
            x = pn[..., 0]                            # (M, dim, h..)
            inbox = torch.all((x >= origin - d_cap_f)
                              & (x < (origin + w_f) + d_cap_f), dim=1)
            nb = neighbourhood(P, parity)
            crd9, as9 = nb[:, :dim], nb[:, dim]
            ok9 = excl_centre(nb[:, dim + 1] > 0.5, sel)
            box2 = chain_view(box * box)[..., None]
            # the new and the old position in one pass
            e = energy(dist2(torch.stack([pn, pi]), crd9, box2), ai, as9,
                       ok9)
            d_e = e[0] - e[1]
            accept = has & inbox & (torch.log(u_acc)
                                    < chain_view(-beta) * d_e)
            upd = (sel & accept[..., None]).unsqueeze(1)
            crd_a = act[:, :dim]
            crd_a.copy_(torch.where(upd, pn, crd_a))
            return _chain_sums(d_e, has, accept)

        return color_substep

    def make_color_swap(parity):
        def swap_substep(P, box, sigma, beta, u_i, u_j, u_acc):
            act = _active(P, parity)
            occ_a = act[:, dim + 1] > 0.5
            attr_a = act[:, dim]
            if swap_mode == "species":
                is_b = attr_a > 0.5
                sel_i, k_i = gumbel_pick(u_i, occ_a & ~is_b)
                sel_j, k_j = gumbel_pick(u_j, occ_a & is_b)
            else:                       # "pair": ordered distinct pair
                sel_i, k_i = gumbel_pick(u_i, occ_a)
                sel_j, k_j = gumbel_pick(u_j, occ_a & ~sel_i)
            valid = torch.any(sel_i, dim=-1) & torch.any(sel_j, dim=-1)
            p_i, p_j = pick(k_i, act), pick(k_j, act)
            nb = neighbourhood(P, parity)
            crd9, as9 = nb[:, :dim], nb[:, dim]
            # both swappers excluded: their own pair term is symmetric under
            # the exchange and cancels in dE
            ok9 = excl_centre(nb[:, dim + 1] > 0.5, sel_i | sel_j)
            box2 = chain_view(box * box)[..., None]
            r2 = dist2(torch.stack([p_i[:, :dim], p_j[:, :dim]]), crd9, box2)
            ai, aj = p_i[:, dim], p_j[:, dim]
            # four rows in one pass: i and j as they are, then exchanged
            e = energy(torch.cat([r2, r2]), torch.stack([ai, aj, aj, ai]),
                       as9, ok9)
            d_e = (e[2] + e[3]) - (e[0] + e[1])
            accept = valid & (torch.log(u_acc) < chain_view(-beta) * d_e)
            upd_i = sel_i & accept[..., None]
            upd_j = sel_j & accept[..., None]
            attr_a.copy_(torch.where(upd_i, aj,
                                     torch.where(upd_j, ai, attr_a)))
            return _chain_sums(d_e, valid, accept)

        return swap_substep

    def total_energy(P, box):
        """(M,) full energy of the bound configurations: one all-cells
        3^dim-neighbourhood pass."""
        m = P.shape[0]
        crd, attr, occ = P[:, :dim], P[:, dim], P[:, dim + 1] > 0.5
        box2 = (box * box).reshape((m,) + (1,) * (dim + 2))
        spatial = tuple(range(1, dim + 1))
        e = None
        for off in itertools.product((-1, 0, 1), repeat=dim):
            shift = tuple(-o for o in off)
            crd_n = torch.roll(crd, shift, tuple(s + 1 for s in spatial))
            attr_n = torch.roll(attr, shift, spatial)
            occ_n = torch.roll(occ, shift, spatial)
            r2 = 0.0
            for a in range(dim):
                d = crd_n[:, a][..., None, :] - crd[:, a][..., :, None]
                d = d - torch.round(d)
                r2 = r2 + d * d                    # (M, nc.., C, C)
            r2 = r2 * box2
            a_i = attr[..., :, None]
            a_j = attr_n[..., None, :]
            ok = (occ[..., :, None] & occ_n[..., None, :]
                  & (r2 < rcut2_of(a_i, a_j)))
            if off == (0,) * dim:
                ok = ok & ~torch.eye(cap, dtype=torch.bool, device=P.device)
            u = pair_energy(r2, a_i, a_j)
            s = torch.sum(torch.where(ok, u, 0.0).reshape(m, -1), dim=1,
                          dtype=ACCUMULATE)
            e = s if e is None else e + s
        return (0.5 * e).to(torch.float32)

    def make_volume():
        n_particles, pressure = vol

        def vol_substep(P, box, energy, dlnv, beta, u_delta, u_acc):
            delta = dlnv * u_delta
            box_new = box * torch.exp(delta / dim)
            # boxes below the grid's floor are rejected outright: a
            # symmetric restriction, the reverse move being in range
            # whenever the forward one is
            in_range = box_new >= grid.box_min
            e_new = total_energy(P, box_new)
            d_e = e_new - energy
            d_v = box ** dim * (torch.exp(delta) - 1.0)
            dlogp = (-beta * (d_e + pressure * d_v)
                     + (n_particles + 1) * delta)
            accept = in_range & (torch.log(u_acc) < dlogp)
            return (torch.where(accept, box_new, box),
                    torch.where(accept, e_new, energy),
                    torch.ones_like(accept), accept)

        return vol_substep

    # kinds 0, 1 and 2; None where the pool has no such kind
    variants = [[make_color(p) for p in parities],
                None if swap_mode is None
                else [make_color_swap(p) for p in parities],
                None if vol is None else [make_volume()]]
    return variants, total_energy


def _chain_sums(d_e, attempted, accept):
    """Per-chain (accepted dE, attempts, accepts) of one substep."""
    axes = tuple(range(1, d_e.dim()))
    return (_sum32(torch.where(accept, d_e, 0.0), axes),
            torch.sum(attempted, dim=axes, dtype=torch.int32),
            torch.sum(accept, dim=axes, dtype=torch.int32))


def _pack(cells):
    return torch.cat([cells["crd"], cells["attr"][:, None],
                      cells["occ"][:, None].to(torch.float32)], dim=1)


def _chain_box(box, m, device, default):
    if box is None:
        box = default
    return torch.as_tensor(box, dtype=torch.float32,
                           device=device).reshape(-1).expand(m)


def cell_total_energy(grid: CellGrid, pair_energy, rcut2_of, pos, attr,
                      box):
    """(M,) full energies of chain-stacked configurations (positions
    (M, N, dim) in real units, box (M,) or a scalar) through the cell
    decomposition."""
    m = pos.shape[0]
    box = _chain_box(box, m, pos.device, grid.box)
    s = torch.remainder(pos / box[:, None, None], 1.0)
    _, total = _make_substep(grid, pair_energy, rcut2_of)
    return total(_pack(bind_cells(grid, s, attr)), box)


# ---------------------------------------------------------------------------
# The substep kernel
# ---------------------------------------------------------------------------

CELL_SUBSTEP_KERNEL = CudaKernel(
    "cell_substep.cu", "mc_cell_substep",
    [ctypes.c_void_p] * 5 + [_PairTable] + [ctypes.c_void_p] * 5
    + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def _kernel_takes(model: CellModel, dim, device, *tensors) -> bool:
    """Whether :data:`CELL_SUBSTEP_KERNEL` runs a segment's displacement and
    swap substeps: the model carries the kernel's parameters, the state is
    2-D, on a CUDA device, and ``tensors`` (the packed cells, beta, the
    energies) are float32."""
    return (model.kernel_params is not None and dim == 2
            and device.type == "cuda"
            and all(t.dtype == torch.float32 for t in tensors))


def _kernel_args(grid: CellGrid, sigma, box, beta, vol):
    """The kernel's per-chain arguments, (4, M) float32, each computed as
    the twin computes it: ``sigma / box`` (a displacement's step per unit
    draw), the halo as a fraction of the box (``d_cap / box``, or ``d_cap /
    box_min`` with volume substeps), ``-beta`` and ``box * box``.  They
    change with the box, so a volume substep asks for them anew."""
    m = box.shape[0]
    halo = torch.full_like(box, grid.d_cap) / (
        box if vol is None else torch.full_like(box, grid.box_min))
    return torch.stack([torch.broadcast_to(sigma / box, (m,)), halo,
                        torch.broadcast_to(-beta, (m,)), box * box])


def _kernel_substeps(grid: CellGrid, P, params, e, att, acc):
    """A segment's launcher of :data:`CELL_SUBSTEP_KERNEL` on its packed
    cells ``P`` (M, 4, nc, nc, C) float32 on the card: ``launch(kind,
    color, args, *draws)`` runs one displacement (kind 0) or swap (kind 1)
    substep, updates ``P`` in place and adds its chain sums to ``e`` (M,)
    float32 and column ``kind`` of ``att``, ``acc`` (M, 3) int32, as the
    twin's ``e + d_e`` and ``att[:, kind] += n_att`` do.  ``args`` is
    :func:`_kernel_args`; the draws are the twin's.  The buffers are checked
    here and the draws at the first launch of each kind (a segment's draws
    keep their shapes), raising on what the kernel does not take.  The
    caller makes ``P``'s device the current one."""
    m, nc, cap = P.shape[0], grid.nc, grid.cap
    h = nc // 2

    def check(name, t, dtype, shape):
        if (t.dtype != dtype or tuple(t.shape) != shape
                or t.device != P.device or not t.is_contiguous()):
            raise ValueError(
                f"{name} must be a contiguous {dtype} {shape} tensor on "
                f"{P.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")

    for name, t, dtype, shape in (
            ("P", P, torch.float32, (m, 4, nc, nc, cap)),
            ("e", e, torch.float32, (m,)),
            ("att", att, torch.int32, (m, 3)),
            ("acc", acc, torch.int32, (m, 3))):
        check(name, t, dtype, shape)
    cell_de = torch.empty((m * h * h,), dtype=torch.float32, device=P.device)
    flags = torch.empty((m * h * h,), dtype=torch.uint8, device=P.device)
    table = _pair_table(params)
    with torch.cuda.device(P.device):
        stream = torch.cuda.current_stream().cuda_stream
    cells = (m, h, h)
    shapes = {0: (cells + (cap,), cells + (2,), cells),
              1: (cells + (cap,), cells + (cap,), cells)}
    checked = set()

    def launch(kind, color, args, *draws):
        if kind not in checked:
            for t, shape in zip((args,) + draws, ((4, m),) + shapes[kind]):
                check("a substep kernel draw", t, torch.float32, shape)
            checked.add(kind)
        CELL_SUBSTEP_KERNEL.launch(
            P.data_ptr(), draws[0].data_ptr(), draws[1].data_ptr(),
            draws[2].data_ptr(), args.data_ptr(), table, e.data_ptr(),
            att.data_ptr(), acc.data_ptr(), cell_de.data_ptr(),
            flags.data_ptr(), m, nc, cap, kind, color >> 1, color & 1,
            stream)

    return launch


# ---------------------------------------------------------------------------
# Draws
# ---------------------------------------------------------------------------

class KeyDraws:
    """A segment's draws (the protocol :func:`cell_mc_segment` takes), from
    the segment's base key ``fold_in(key(seed), micro_t0)`` (``micro_t0``
    the segment's absolute first micro-step), as the reference's
    ``cell_mc_segment`` derives them (``montecarlo_tpu/ops/cell_mc.py:605-
    659``):

    - ``variants(n_substeps, n_colors, w_disp, w_swap, swap, vol)``: a host
      (n, 2) int array of each substep's (kind, color), shared by all
      chains, from the variant stream ``kv_i = fold_in(fold_in(fold_in(
      base, 0x7C01), 0xC0110), i)``: the color ``randint(kv_i, 0,
      n_colors)``, the kind from ``u = uniform(fold_in(kv_i, 1))``, a
      displacement (0) where u < ``w_disp``, else a swap (1) where the pool
      has one and, with a volume move too, u < ``w_disp + w_swap``
      (float32), else a volume substep (2).  All substeps in one plain
      call a draw, on the host;
    - ``shift(m, dim, device)``: the (M, dim) uniform grid origins,
      ``uniform(fold_in(kshift, c), (dim,))`` with ``kshift = fold_in(
      fold_in(base, 0x5A1F7), 0x0F5E7)``;
    - ``substep(i, kind, m, h, cap, dim, proposal, device)``: substep
      ``i``'s tensors from ``split(fold_in(fold_in(base, c), i), 3)``
      (every substep's keys of the segment made at its first substep, in
      two batched calls):
      ``(u_pick, draw, u_acc)`` for a displacement (the draw (M, h.., dim):
      standard normal for the ``"gaussian"`` proposal, uniform in [-1, 1)
      for the ``"square"`` one) and ``(u_i, u_j, u_acc)`` for a swap; the
      uniforms are in [0, 1);
    - ``volume(i, m, device)``: a volume substep's (M,) ``(u_delta,
      u_acc)``, uniform in [-1, 1) and [0, 1), from ``split(fold_in(
      fold_in(base, c), i))``: the first two of those three keys (a
      split's keys are the block at counts 0, 1, ..., whatever their
      number).

    ``chain_ids`` are the chains' global ids (a rank of a chain mesh holds
    a slice of them), so a rank draws what one process draws for its
    chains."""

    def __init__(self, seed: int, micro_t0: int, chain_ids):
        self.seed = int(seed)
        self.micro_t0 = int(micro_t0)
        self.chain_ids = chain_ids
        self._base = {}
        self._chains = None
        self._substeps = None
        self._n = 0

    def base(self, device):
        """The segment's base key on ``device``."""
        device = torch.device(device)
        if device not in self._base:
            self._base[device] = prng.fold_in(
                prng.key(self.seed, device), self.micro_t0)
        return self._base[device]

    def variants(self, n_substeps, n_colors, w_disp, w_swap, swap, vol):
        n = int(n_substeps)
        self._n = n
        if n == 0:
            return np.zeros((0, 2), np.int64)
        kc = prng.fold_in(prng.fold_in(self.base("cpu"), 0x7C01), 0xC0110)
        kv = prng.fold_in(kc, torch.arange(n))                  # (n, 2)
        color = prng.randint(kv, (), 0, n_colors).numpy().astype(np.int64)
        kind = np.zeros(n, np.int64)
        if swap or vol:
            u = prng.uniform(prng.fold_in(kv, 1)).numpy()
            kind = _kinds(u, w_disp, w_swap, swap, vol)
        return np.stack([kind, color], axis=1)

    def _chain_keys(self, device):
        if self._chains is None:
            ids = self.chain_ids.to(device)
            self._chains = prng.fold_in(self.base(device)[None], ids)
        return self._chains

    def shift(self, m, dim, device):
        ks = prng.fold_in(prng.fold_in(self.base(device), 0x5A1F7), 0x0F5E7)
        ids = self.chain_ids.to(device)
        return prng.uniform(prng.fold_in(ks[None], ids), (dim,))

    def _substep_keys(self, i, n, device):
        """(M, n, 2): the first ``n`` keys of ``split(fold_in(chain key,
        i), 3)``, from the segment's (M, substeps, 3, 2) keys."""
        if self._substeps is None or i >= self._substeps.shape[1]:
            steps = torch.arange(max(self._n, i + 1), device=device)
            self._substeps = prng.split(
                prng.fold_in(self._chain_keys(device)[:, None], steps), 3)
        return self._substeps[:, i, :n]

    def substep(self, i, kind, m, h, cap, dim, proposal, device):
        cells = (h,) * dim
        k = self._substep_keys(i, 3, device)                 # (M, 3, 2)
        first = prng.uniform(k[:, 0], cells + (cap,))
        if kind == 1:
            second = prng.uniform(k[:, 1], cells + (cap,))
        elif proposal == "square":
            second = prng.uniform(k[:, 1], cells + (dim,), minval=-1.0,
                                  maxval=1.0)
        else:
            second = prng.normal(k[:, 1], cells + (dim,))
        return first, second, prng.uniform(k[:, 2], cells)

    def volume(self, i, m, device):
        k = self._substep_keys(i, 2, device)
        return (prng.uniform(k[:, 0], (), minval=-1.0, maxval=1.0),
                prng.uniform(k[:, 1], ()))


def _kinds(u, w_disp, w_swap, swap, vol):
    """Each substep's kind from its float32 uniform ``u`` (the reference's
    rule, ``montecarlo_tpu/ops/cell_mc.py:642-652``)."""
    if not (swap or vol):
        return np.zeros(u.shape, np.int64)
    rest = 1 if swap else 2
    if swap and vol:
        rest = np.where(u < np.float32(w_disp) + np.float32(w_swap), 1, 2)
    return np.where(u < np.float32(w_disp), 0, rest).astype(np.int64)


# ---------------------------------------------------------------------------
# Segment driver
# ---------------------------------------------------------------------------

def cell_mc_segment(grid: CellGrid, model: CellModel, draws, pos, attr, beta,
                    energy, sigma, n_substeps: int, w_disp: float = 1.0,
                    w_swap: float = 0.0, box=None, vol=None, dlnv=0.0):
    """Run ``n_substeps`` checkerboard substeps on chain-stacked state.

    Args:
      grid: the :class:`CellGrid` plan.
      model: the :class:`CellModel` (``swap_mode`` None without swaps);
        :func:`_kernel_takes` says when its displacement and swap substeps
        run in :data:`CELL_SUBSTEP_KERNEL`, the same numbers as the twin's.
      draws: the segment's draws (:class:`KeyDraws`'s protocol).
      pos: (M, N, dim) real-space positions; attr: (M, N);
      beta, energy: (M,); box: (M,) per-chain box edges, or a scalar.
      sigma: proposal width (real units): a Gaussian's standard deviation,
        or the square proposal's half-width.
      n_substeps: host int; a displacement or swap substep attempts
        ~nc^dim / 2^dim moves per chain, a volume substep one.
      w_disp / w_swap: the probabilities that a substep is a displacement
        or a swap; the rest are volume substeps (swaps without ``vol``).
      vol: None, or ``(n_particles, pressure)``: volume substeps with the
        ln-V half-width ``dlnv`` (a float or a 0-d tensor).

    Returns ``(pos', attr', energy', box', attempts, accepts, invalid)``
    with box' (M,), attempts/accepts (M, 3) int32 (columns: displacement,
    swap, volume) and invalid (M,) bool: the chain's bind overflowed a
    cell, or its box is below the grid's validity floor.  Invalid chains
    pass through UNCHANGED with zero counters; the caller must surface the
    flag.  The host does not wait for the device anywhere in here.
    """
    m, n, dim = pos.shape
    if dim != grid.dim:
        raise ValueError(f"grid is {grid.dim}-D but positions are {dim}-D")
    dev = pos.device
    swap_mode = model.swap_mode
    variants, _ = _make_substep(grid, model.pair_energy, model.rcut2_of,
                                swap_mode, vol)
    box = _chain_box(box, m, dev, grid.box)
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=dev)
    dlnv = torch.as_tensor(dlnv, dtype=torch.float32, device=dev)
    seq = draws.variants(int(n_substeps), 2 ** dim, w_disp, w_swap,
                         swap_mode is not None, vol is not None)
    count("cell_binds")
    with span("mc.cell.bind"):
        shift = draws.shift(m, dim, dev)                  # (M, dim)
        s = torch.remainder(pos / box[:, None, None] + shift[:, None, :],
                            1.0)
        s = torch.where(s >= 1.0, 0.0, s)   # f32 mod of -eps can return 1.0
        cells = bind_cells(grid, s, attr)
        invalid = cells["overflow"] | (box < grid.box_min)
        P = _pack(cells)
    e, bx = energy, box
    att = torch.zeros((m, 3), dtype=torch.int32, device=dev)
    acc = torch.zeros((m, 3), dtype=torch.int32, device=dev)
    h = grid.nc // 2
    kernel = None
    if _kernel_takes(model, dim, dev, P, beta, energy):
        # the kernel adds each substep's chain sums to e, att, acc in place
        e = energy.clone(memory_format=torch.contiguous_format)
        kernel = _kernel_substeps(grid, P, model.kernel_params, e, att, acc)
        args = _kernel_args(grid, sigma, bx, beta, vol)
    with (contextlib.nullcontext() if kernel is None
          else torch.cuda.device(dev)):
        for i, (kind, color) in enumerate(seq.tolist()):
            with span("mc.cell.substep"):
                if kind == 2:
                    bx, e_vol, n_att, n_acc = variants[2][0](
                        P, bx, e, dlnv, beta, *draws.volume(i, m, dev))
                    if kernel is None:
                        e = e_vol
                    else:
                        e.copy_(e_vol)
                        args = _kernel_args(grid, sigma, bx, beta, vol)
                else:
                    d = draws.substep(i, kind, m, h, grid.cap, dim,
                                      model.proposal, dev)
                    if kernel is not None:
                        kernel(kind, color, args, *d)
                        continue
                    d_e, n_att, n_acc = variants[kind][color](P, bx, sigma,
                                                              beta, *d)
                    e = e + d_e
                att[:, kind] += n_att.to(torch.int32)
                acc[:, kind] += n_acc.to(torch.int32)
    count("cell_substeps", len(seq))
    with span("mc.cell.unbind"):
        s_out, attr_out = unbind_cells(
            {"crd": P[:, :dim], "attr": P[:, dim], "idx": cells["idx"]}, n)
        frac = torch.remainder(s_out - shift[:, None, :], 1.0)
        # keep pos strictly in [0, box)
        frac = torch.where(frac >= 1.0, 0.0, frac)
        pos_out = frac * bx[:, None, None]
        # invalid chains: the whole segment is a no-op (their bind dropped
        # particles), counters zeroed so the corruption cannot leak
        pos_out = torch.where(invalid[:, None, None], pos, pos_out)
        attr_out = torch.where(invalid[:, None], attr.to(torch.float32),
                               attr_out)
        e = torch.where(invalid, energy, e)
        bx = torch.where(invalid, box, bx)
        att = torch.where(invalid[:, None], 0, att)
        acc = torch.where(invalid[:, None], 0, acc)
    return pos_out, attr_out, e, bx, att, acc, invalid
