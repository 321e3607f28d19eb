"""The O(N^2) total energy of 2-D Lennard-Jones chains on the card.

:func:`lj_total_energy` launches the hand-written CUDA kernel
``csrc/lj_energy.cu`` (:data:`LJ_ENERGY_KERNEL`): every chain of the batch
in one call, one block per (chain, tile of :func:`block_rows` rows), the
rows summed by a fixed tree, so two calls give the same bits and a chain's
energy does not depend on the other chains of the call.  It takes CUDA
tensors only and raises on anything else; its plain twin is
:func:`montecarlo_tpu_torch.models.lennard_jones.total_energy`, which
``lennard_jones._lj_energies`` takes (through ``_energies``) everywhere the
kernel does not run (the CPU, float64, 3-D); the polydisperse energy never
comes here.  The two compute each pair term in the same float32 arithmetic
(but the minimum image's ``d / box``, which the kernel takes as
``d * (1 / box)``) and sum in different orders, so they agree to float32
rounding.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ._cuda import CudaKernel

__all__ = ["lj_total_energy", "block_rows", "COLUMN_TILE", "LJ_ENERGY_KERNEL"]

_WARP = 32
_MAX_ROWS = 128
#: particles a block stages in shared memory a pass (``kCols``): a chain of
#: more takes several passes
COLUMN_TILE = 2048


class _PairTable(ctypes.Structure):
    """``csrc/lj_pair_table.cuh: PairTable``, passed by value."""
    _fields_ = [(f, ctypes.c_float * 3) for f in ("e4", "s2", "rc2", "sh")]


LJ_ENERGY_KERNEL = CudaKernel(
    "lj_energy.cu", "mc_lj_energy",
    [ctypes.c_void_p] * 3 + [_PairTable] + [ctypes.c_void_p] * 2
    + [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def block_rows(n: int) -> int:
    """Rows (threads) of the block that serves a tile of a chain of ``n``
    particles: 128, or ``n`` rounded up to whole warps below that.  The row
    sums' tree depends on it, so it depends on ``n`` alone."""
    return min(_MAX_ROWS, max(1, -(-n // _WARP)) * _WARP)


@functools.lru_cache(maxsize=None)
def _pair_table(params) -> _PairTable:
    """The species pairs' constants (AA, AB, BB) in float32, each rounded
    where ``lennard_jones._pair_energy`` rounds it: ``4 eps``, ``sig^2``,
    ``(rcut sig)^2`` and the shift ``4 eps * (ic6^2 - ic6)`` with ``ic6`` in
    float64 taken to float32 as torch takes a Python scalar."""
    f32 = np.float32
    ic = 1.0 / (params.rcut * params.rcut)
    ic6 = ic * ic * ic
    shift = f32(ic6 * ic6 - ic6)
    tab = _PairTable()
    for k, (a, b) in enumerate(((0, 0), (0, 1), (1, 1))):
        e4 = f32(4.0) * f32(params.eps[a][b])
        sig = f32(params.sig[a][b])
        tab.e4[k] = e4
        tab.s2[k] = sig * sig
        rc = f32(params.rcut) * sig
        tab.rc2[k] = rc * rc
        tab.sh[k] = e4 * shift
    return tab


def lj_total_energy(pos, species, box, params) -> torch.Tensor:
    """(M,) float32 total energies of the chains: half the sum over ordered
    pairs ``i != j`` of the truncated-and-shifted pair energy of
    ``params`` (a ``lennard_jones.LJParams``) under the minimum image, as
    ``lennard_jones.total_energy`` defines it.

    Args:
      pos: (M, N, 2) float32 positions on a CUDA device.
      species: (M, N) int32 labels, paired as ``LJParams.coeffs`` pairs
        them: equal labels take the AA constants when 0, else BB; unequal
        ones AB.
      box: (M,) float32 box edges.

    Launches the kernel once (two CUDA launches: the rows, then the
    chains' sums), or raises on arguments it does not take.
    """
    for name, t, dtype in (("pos", pos, torch.float32),
                           ("species", species, torch.int32),
                           ("box", box, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != pos.device:
            raise ValueError(f"{name} is on {t.device}, pos on {pos.device}")
    if pos.device.type != "cuda":
        raise ValueError(f"no LJ energy kernel for device {pos.device}")
    if pos.dim() != 3 or pos.shape[-1] != 2:
        raise ValueError(f"pos must be (M, N, 2), got {tuple(pos.shape)}")
    m, n, _ = pos.shape
    if species.shape != (m, n) or box.shape != (m,):
        raise ValueError(
            f"expected species (M, N) and box (M,) for pos {tuple(pos.shape)},"
            f" got {tuple(species.shape)}, {tuple(box.shape)}")
    rows = block_rows(n)
    tiles = -(-n // rows)
    if m * tiles > 2 ** 31 - 1:
        raise ValueError(f"{m} chains of {n} particles exceed the grid")
    out = torch.empty((m,), dtype=torch.float32, device=pos.device)
    if m == 0 or n == 0:
        return out.zero_()
    pos, species = pos.contiguous(), species.contiguous()
    box = box.contiguous()
    partial = torch.empty((m, tiles), dtype=torch.float32, device=pos.device)
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream().cuda_stream
        LJ_ENERGY_KERNEL.launch(pos.data_ptr(), species.data_ptr(),
                                box.data_ptr(), _pair_table(params),
                                partial.data_ptr(), out.data_ptr(), m, n,
                                rows, stream)
    return out
