"""Fused sweep for polydisperse soft-sphere swap Monte Carlo (2-D).

Port of ``montecarlo_tpu/ops/poly_sweep.py``.  :func:`fused_poly_mixed_sweep`
runs the displacement + diameter-swap pool of
``models/polydisperse.py`` (C2-smoothed IPL-12, non-additive cross
diameters): each step draws one move kind per block of the reference's
chain grid; a displacement is a uniform pick and a 2-D Box–Muller step with
ΔE from two O(N) rows, a swap exchanges the diameters of a uniform pair
j != i with ΔE from four rows, the i–j term cancelling.

CUDA tensors launch the hand-written kernel in ``csrc/poly_sweep.cu`` (one
block of :func:`poly_block_warps` warps per chain, the chain's positions and
diameters in shared memory for the whole segment, every draw made a batch
of steps ahead) or raise; CPU tensors and ``interpret=True`` take the plain
torch version below.  Both draw from the reference's counter-hash stream
with the reference's block geometry, so the plain version reproduces its
interpret-mode results on the CPU (equal counts and diameters, positions
within float32 ulps of log/cos/sin), and the kernel reproduces the plain
version bit for bit on the card.  As in ``ops/lj_sweep.py``, the pair terms
use exact reciprocals, as the reference kernel does, and the row sums are
taken in the CUDA kernel's thread order
(:func:`~montecarlo_tpu_torch.ops.lj_sweep._lane_sum` for W warps).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._cuda import CudaKernel
from .fused_sweep import _GOLDEN, _MASK, _mesh_seed, _mul32
from .lj_sweep import (_ARGS, _SHAPE, _TAIL, _cuda_sweep, _disp_step, _grid,
                       _lane_sum, _pow2_warps, _run_steps, _table, _uniform)

__all__ = ["fused_poly_mixed_sweep", "sharded_poly_mixed_sweep",
           "poly_block_warps", "POLY_KERNEL"]

_LANES = 128
_SWAP_TAG = 0x51AB

POLY_KERNEL = CudaKernel(
    "poly_sweep.cu", "mc_poly_mixed_sweep",
    _ARGS + [ctypes.c_void_p] * 5 + _SHAPE + [ctypes.c_int] + _TAIL)


def poly_block_warps(n: int) -> int:
    """W, the warps of the block that serves one chain of ``n`` particles
    in the polydisperse kernel, a power of two: one slot a thread up to 8
    warps (N <= 256), then 8 warps while a thread has at most three slots
    (N <= 768), then 16.  Timed on an H100 at 64 chains for every W and N
    from 128 to 4096 (``chip_smoke.py``, ``poly_warp_times``): where the
    LJ kernels' rule (:func:`~montecarlo_tpu_torch.ops.lj_sweep.block_warps`)
    keeps 8 warps to N 1024, 16 warps were faster here at N 1024.  It
    depends on N alone, because the row sums' order follows it: the plain
    version and the kernel read it here."""
    return max(_pow2_warps(n, 96), min(8, _pow2_warps(n, 32)))


# -- the scalar table ----------------------------------------------------------

def _poly_scalars(params, box, sigma, w_disp):
    """The reference kernel's 9-float table (numpy float32): sigma, box,
    1/box, eps, x_c^2, c0, c2, c4, w_disp, rounded as the reference rounds
    them (1/box in float32, the others from float64)."""
    box_f = np.float32(box)
    c0, c2, c4 = params.coeffs()
    return np.concatenate([
        np.asarray([sigma, box_f, np.float32(1.0) / box_f], np.float32),
        np.asarray([params.eps, params.xc ** 2, c0, c2, c4], np.float32),
        np.asarray([w_disp], np.float32)])


# -- the plain version -----------------------------------------------------------

def _row_energy(tab, x, y, dia, xi, yi, d_i, excl):
    """(M,) energy of a virtual particle at (xi, yi) with diameter ``d_i``
    (each (M, 1)) against every chain's particles, slots ``excl`` left out:
    the reference's ``row_energy`` term by term."""
    box, inv_box, eps, xc2, c0, c2, c4 = (tab[k] for k in range(1, 8))
    dx = x - xi
    dy = y - yi
    dx = dx - box * torch.round(dx * inv_box)
    dy = dy - box * torch.round(dy * inv_box)
    r2 = dx * dx + dy * dy
    sig = 0.5 * (d_i + dia) * (1.0 - eps * torch.abs(d_i - dia))
    x2 = r2 * torch.reciprocal(torch.clamp(sig * sig, min=1e-12))
    inv2 = torch.reciprocal(torch.clamp(x2, min=1e-12))
    i6 = inv2 * inv2 * inv2
    u = i6 * i6 + c0 + c2 * x2 + c4 * x2 * x2
    u = torch.where((x2 < xc2) & ~excl, u, 0.0)
    return _lane_sum(u, poly_block_warps(u.shape[1]))


def _swap_step(tab, x, y, dia, e, beta, seeds, lanes, col):
    """One diameter-swap attempt on every chain (the reference's
    ``swap_branch``): i uniform, j uniform over the other N - 1 slots.
    Returns (dia, e, accepted)."""
    n = x.shape[1]
    swap_seeds = seeds ^ _SWAP_TAG
    u_i, u_j, u_acc = (_uniform(lanes[c], swap_seeds, 0) for c in range(3))
    i_sel = torch.clamp((u_i * n).to(torch.int64), max=n - 1)[:, None]
    j_raw = torch.clamp((u_j * (n - 1)).to(torch.int64), max=n - 2)[:, None]
    j_sel = j_raw + (j_raw >= i_sel).to(torch.int64)
    oh_i = col == i_sel
    oh_j = col == j_sel
    oh_ij = oh_i | oh_j
    x_i, y_i, d_i = (a.gather(1, i_sel) for a in (x, y, dia))
    x_j, y_j, d_j = (a.gather(1, j_sel) for a in (x, y, dia))
    e_old = (_row_energy(tab, x, y, dia, x_i, y_i, d_i, oh_ij)
             + _row_energy(tab, x, y, dia, x_j, y_j, d_j, oh_ij))
    e_new = (_row_energy(tab, x, y, dia, x_i, y_i, d_j, oh_ij)
             + _row_energy(tab, x, y, dia, x_j, y_j, d_i, oh_ij))
    d_e = e_new - e_old
    accept = torch.log(u_acc) < -beta * d_e
    upd = accept[:, None]
    dia = torch.where(upd & oh_i, d_j, torch.where(upd & oh_j, d_i, dia))
    return dia, e + torch.where(accept, d_e, 0.0), accept


def _plain_sweep(pos, diam, beta, energy, tab, w_disp, seed, t0, n_steps,
                 bc):
    """The reference kernel in plain torch ops, step by step."""
    m, n, _ = pos.shape
    dev = pos.device
    col = torch.arange(n, device=dev)[None, :]
    pid, rows = _grid(m, bc, dev)
    lanes = [_mul32(rows * _LANES + c, _GOLDEN) for c in range(4)]

    def disp(x, y, dia, e, seeds):
        return _disp_step(tab, x, y, dia, e, beta, seeds, lanes, col,
                          row=_row_energy)

    def swap(x, y, dia, e, seeds):
        return _swap_step(tab, x, y, dia, e, beta, seeds, lanes, col)

    x, y, dia, e, acc, tot = _run_steps(
        pos[..., 0], pos[..., 1], diam, energy, pid, bc, seed, t0, n_steps,
        w_disp, disp, swap)
    return torch.stack([x, y], dim=-1), dia.clone(), e.clone(), acc, tot


# -- the entry point ---------------------------------------------------------------

def fused_poly_mixed_sweep(pos, diam, beta, energy, box, sigma, w_disp, seed,
                           t0, n_steps, *, params, interpret=False,
                           block_chains=256):
    """Run ``n_steps`` mixed displacement/diameter-swap attempts per chain
    in one call (the reference's ``fused_poly_mixed_sweep``).

    Args:
      pos: (M, N, 2) float32 positions, N >= 2.
      diam: (M, N) float32 diameters.
      beta: (M,) float32; energy: (M,) float32 cached totals.
      box: float periodic box edge, the same for every chain.
      sigma: displacement width (float or 0-d float32 tensor).
      w_disp: probability of drawing the displacement move
        (``weight_disp / (weight_disp + weight_swap)``).
      seed, t0, n_steps: ints; step k is seeded from ``seed + t0 + k``, so
        results do not depend on how a run is cut into segments.
      params: :class:`~montecarlo_tpu_torch.models.polydisperse.PolyParams`.
      interpret: run the plain torch version on any device.
      block_chains: chains per block of the reference's Pallas grid; the
        block index is folded into the stream and each block draws its own
        move kind, so this must match the reference's to reproduce its bits.

    Returns:
      ``(pos', diam', energy', accepted, attempted)`` with accepted and
      attempted (M, 2) int32: column 0 displacement, column 1 swap.

    CPU tensors and ``interpret=True`` take the plain version; CUDA tensors
    launch the kernel, or raise when it cannot take them.
    """
    seed, t0, n_steps = int(seed) & _MASK, int(t0), int(n_steps)
    if n_steps < 0:
        raise ValueError(f"n_steps must be >= 0, got {n_steps}")
    if pos.dim() != 3 or pos.shape[-1] != 2:
        raise ValueError(f"pos must be (M, N, 2), got {tuple(pos.shape)}")
    m, n, _ = pos.shape
    if n < 2:
        raise ValueError(
            f"the polydisperse sweep needs N >= 2 particles per chain (a "
            f"swap exchanges two), got {n}")
    bc = min(block_chains, max(8, m))
    tab = _table(params, box, sigma, w_disp, pos.device, build=_poly_scalars)
    if interpret or pos.device.type == "cpu":
        return _plain_sweep(pos, diam, beta, energy, tab, np.float32(w_disp),
                            seed, t0, n_steps, bc)
    if pos.device.type != "cuda":
        raise ValueError(f"no polydisperse sweep kernel for device "
                         f"{pos.device}")
    return _cuda_sweep(POLY_KERNEL, True, pos, diam, beta, energy, tab, seed,
                       t0, n_steps, bc, poly_block_warps(n),
                       attr=("diam", torch.float32))



def sharded_poly_mixed_sweep(mesh, axis, pos, diam, beta, energy, box,
                             sigma, w_disp, seed, t0, n_steps, *, params,
                             interpret=False, block_chains=256):
    """Multi-device fused polydisperse swap sweep (the reference's
    ``shard_map`` wrapper): this rank runs :func:`fused_poly_mixed_sweep`
    on its local chains with its index on ``mesh`` folded into the seed
    (``fused_sweep._shard_seed``); box, sigma, w_disp, seed, t0 and n_steps
    are the same on every rank, the block geometry is the local one.  On a
    CUDA tensor it launches the kernel, or raises."""
    return fused_poly_mixed_sweep(pos, diam, beta, energy, box, sigma,
                                  w_disp, _mesh_seed(mesh, axis, seed), t0,
                                  n_steps, params=params, interpret=interpret,
                                  block_chains=block_chains)
