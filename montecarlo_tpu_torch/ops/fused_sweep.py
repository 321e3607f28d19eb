"""Fused Metropolis sweep for 1-D scalar systems.

Port of ``montecarlo_tpu/ops/fused_sweep.py``.  ``fused_gaussian_sweep``
runs ``n_steps`` Metropolis steps of one symmetric Gaussian displacement
move over all chains in one call, and has two bodies:

- the hand-written CUDA kernel ``csrc/fused_sweep.cu``, launched for CUDA
  tensors: a group of T lanes of a warp per chain (:func:`group_lanes`),
  which make the noise of T step pairs side by side and then apply the
  pairs' accept steps in order, the state in registers for the whole
  segment;
- a plain PyTorch version, taken for CPU tensors or under
  ``interpret=True`` (the engine's ``fused='interpret'``).  The tests hold it
  against the reference's Pallas kernel in interpret mode, and
  ``chip_smoke.py`` holds the CUDA kernel against it.

Both draw from the reference's counter-hash stream (``software_bits``), so
they reproduce the reference's interpret-mode results: same accept counts,
positions within float32 ulps of the transcendental functions.  The
symmetric proposal's forward and backward log densities cancel, so the rule
is ``log u < beta (U(x) - U(x'))``.

The 32-bit hash is done in int64 tensors masked to 32 bits: torch's ``>>``
on int32 is arithmetic where the reference shifts logically, and int32
overflow is not a torch contract.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.device import resolve_device
from ._cuda import CudaKernel

__all__ = ["fused_gaussian_sweep", "sharded_gaussian_sweep", "software_bits",
           "kernel_potential", "group_lanes", "SWEEP_KERNEL"]

_LANES = 128
_SUBLANES = 8
_TILE = _LANES * _SUBLANES
_MASK = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9          # int32 -1640531527
_DRAW_TAG = 0x3243F6A9

SWEEP_KERNEL = CudaKernel(
    "fused_sweep.cu", "mc_fused_gaussian_sweep",
    [ctypes.c_void_p] * 6 + [ctypes.c_int64, ctypes.c_int64, ctypes.c_uint32,
                             ctypes.c_int32, ctypes.c_int32, ctypes.c_int,
                             ctypes.c_int, ctypes.c_float, ctypes.c_float,
                             ctypes.c_float, ctypes.c_void_p])


# -- the counter-hash stream -------------------------------------------------

def _mul32(a, c: int):
    """``a * c mod 2**32`` for int64 ``a`` in [0, 2**32) and a constant
    ``c``, with no intermediate above 2**49."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _hash32(s):
    """Murmur3-style finalizer on uint32 values held in int64 tensors (or
    Python ints)."""
    if isinstance(s, int):
        s &= _MASK
        s = (s * 0x85EBCA6B) & _MASK
        s ^= s >> 13
        s = (s * 0xC2B2AE35) & _MASK
        return s ^ (s >> 16)
    s = _mul32(s & _MASK, 0x85EBCA6B)
    s = s ^ (s >> 13)
    s = _mul32(s, 0xC2B2AE35)
    return s ^ (s >> 16)


def _draw_bits(h, draw: int):
    """Bits of draw ``draw`` for lanes whose hash base is
    ``h = flat * 0x9E3779B9 + step_seed``."""
    h = _hash32(h ^ ((draw * _DRAW_TAG) & _MASK))
    return _hash32((h + draw) & _MASK)


def software_bits(step_seed: int, draw: int, shape, device=None):
    """Counter-based uint32 bits (as int64 in [0, 2**32)) for a plane of
    ``shape``: lane ``flat = row * shape[-1] + col`` over the first and last
    axes, as the reference's ``software_bits``; on ``device``, the card
    (``cuda``) when it is None."""
    device = resolve_device(device)
    rows = torch.arange(shape[0], dtype=torch.int64, device=device)
    cols = torch.arange(shape[-1], dtype=torch.int64, device=device)
    view = (-1,) + (1,) * (len(shape) - 1)
    flat = (rows.view(view) * shape[-1] + cols).expand(tuple(shape))
    return _draw_bits((_mul32(flat, _GOLDEN) + int(step_seed)) & _MASK, draw)


def _uniform_from_bits(bits):
    """uint32 bits -> float32 uniform in (0, 1] (mantissa trick)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return 2.0 - f


def _shard_seed(shard_index: int, seed: int) -> int:
    """Fold a shard index into a sweep seed (one stream per shard)."""
    return (seed + (shard_index + 1) * _GOLDEN) & _MASK


def _mesh_seed(mesh, axis, seed) -> int:
    """This rank's sweep seed on ``mesh``: the reference's ``_shard_seed``
    of the shard index along ``axis``, the mesh's one axis."""
    if axis != mesh.axis:
        raise ValueError(f"the mesh has the one axis {mesh.axis!r}, not "
                         f"{axis!r}")
    return _shard_seed(mesh.rank, int(seed))


# -- potentials the kernel knows ---------------------------------------------

def kernel_potential(potential):
    """``(kind, a^2, h, a^4)`` of a potential the CUDA kernel evaluates, or
    None: 0 is ``particle1d.harmonic``, 1 is ``particle1d.double_well``
    (optionally a ``functools.partial`` of it binding ``a``/``h``)."""
    from ..models import particle1d as p1d
    if potential is p1d.harmonic:
        return 0, 0.0, 0.0, 0.0
    kw = {}
    if isinstance(potential, functools.partial):
        if potential.args or set(potential.keywords) - {"a", "h"}:
            return None
        kw, potential = potential.keywords, potential.func
    if potential is p1d.double_well:
        a, h = float(kw.get("a", 1.0)), float(kw.get("h", 1.0))
        return 1, a * a, h, a ** 4
    return None


# -- the sweep ---------------------------------------------------------------

def _block_chains(m: int, block_rows: int) -> int:
    """Chains per Pallas block of the reference: ``(br, 128)`` blocks over
    the population padded to whole (8, 128) tiles."""
    rows = -(-m // _TILE) * _TILE // _LANES
    return min(block_rows, rows) * _LANES


def _plain_sweep(x, beta, sigma, seed, t0, n_steps, potential, block_chains):
    """The sweep in plain torch ops, pair by pair (the reference's
    ``_sweep_kernel`` body with ``make_draw(hw_prng=False)``)."""
    idx = torch.arange(x.shape[0], dtype=torch.int64, device=x.device)
    pid = idx // block_chains
    lane = (_mul32(idx - pid * block_chains, _GOLDEN)
            + _mul32(pid, 1000003)) & _MASK
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=x.device)
    acc = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    t_end = t0 + n_steps
    p0 = t0 >> 1
    n_pairs = ((t_end - 1) >> 1) - p0 + 1 if n_steps > 0 else 0
    for p in range(p0, p0 + n_pairs):
        h = (lane + _hash32(seed + p)) & _MASK
        u1, u2, u3, u4 = (_uniform_from_bits(_draw_bits(h, k))
                          for k in range(4))
        r = torch.sqrt(-2.0 * torch.log(u1))
        theta = (2.0 * torch.pi) * u2
        for live, z, u in ((t0 <= 2 * p < t_end, r * torch.cos(theta), u3),
                           (2 * p + 1 < t_end, r * torch.sin(theta), u4)):
            if not live:
                continue
            xn = x + sigma * z
            accept = torch.log(u) < beta * (potential(x) - potential(xn))
            x = torch.where(accept, xn, x)
            acc = acc + accept.to(torch.int32)
    return x, potential(x), acc


#: threads per SM at which the kernel's dependent hash and transcendental
#: chains overlap well enough that a wider group's extra work no longer
#: pays: three warps for each of an SM's four schedulers (timed on an H100
#: at 10^3 to 10^6 chains)
_FILL_THREADS_PER_SM = 384


def group_lanes(m: int, sm_count: int) -> int:
    """T, the lanes of a warp that serve one chain in the CUDA kernel: the
    smallest power of two in 1..32 with ``m * T`` threads filling a card of
    ``sm_count`` SMs (``_FILL_THREADS_PER_SM`` each).  Few chains get wide
    groups, which buy parallelism with extra work per step; 10^6 chains
    fill the card alone and get T = 1.  T changes no bit of the result."""
    lanes = 1
    while lanes < 32 and m * lanes < sm_count * _FILL_THREADS_PER_SM:
        lanes *= 2
    return lanes


def _cuda_sweep(x, beta, sigma, seed, t0, n_steps, potential, block_chains,
                lanes=None):
    """Check the arguments and launch the kernel, with ``lanes`` lanes per
    chain (default: :func:`group_lanes` for this card)."""
    pot = kernel_potential(potential)
    if pot is None:
        raise ValueError(
            f"the CUDA sweep kernel has no potential {potential!r} (it knows "
            f"particle1d.harmonic and particle1d.double_well); use "
            f"Metropolis(fused='off') for the generic path")
    for name, t in (("x", x), ("beta", beta), ("sigma", sigma)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dim() != 1 or beta.shape != x.shape or sigma.numel() != 1:
        raise ValueError(
            f"expected x, beta of shape (M,) and a scalar sigma, got "
            f"{tuple(x.shape)}, {tuple(beta.shape)}, {tuple(sigma.shape)}")
    if not (x.is_contiguous() and beta.is_contiguous()):
        raise ValueError("x and beta must be contiguous")
    if not 0 <= t0 <= 2 ** 31 - 1 - n_steps:
        raise ValueError(f"t0={t0}, n_steps={n_steps} overflow int32")
    x_out = torch.empty_like(x)
    e_out = torch.empty_like(x)
    acc = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    if x.numel() == 0:
        return x_out, e_out, acc
    kind, a2, h, a4 = pot
    if lanes is None:
        lanes = group_lanes(x.numel(), torch.cuda.get_device_properties(
            x.device).multi_processor_count)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        SWEEP_KERNEL.launch(
            x.data_ptr(), beta.data_ptr(), sigma.data_ptr(), x_out.data_ptr(),
            e_out.data_ptr(), acc.data_ptr(), x.numel(), block_chains,
            seed, t0, n_steps, lanes, kind, a2, h, a4, stream)
    return x_out, e_out, acc


def fused_gaussian_sweep(x, beta, sigma, seed, t0, n_steps, *, potential,
                         interpret=False, block_rows=2048):
    """Run ``n_steps`` Metropolis steps of a Gaussian displacement move over
    all chains in one call.

    Args:
      x: (M,) float32 positions.
      beta: (M,) float32 inverse temperatures.
      sigma: scalar proposal width (float or 0-d float32 tensor).
      seed: int base seed of the counter-hash stream.
      t0: int absolute step offset: pair p of steps (2p, 2p+1) is seeded
        from ``seed + p``, so results do not depend on how a run is cut into
        segments.
      n_steps: int number of steps.
      potential: elementwise U(x).  The CUDA kernel knows
        :func:`~montecarlo_tpu_torch.models.particle1d.harmonic` and
        :func:`~montecarlo_tpu_torch.models.particle1d.double_well`.
      interpret: run the plain torch version on any device.
      block_rows: rows of 128 chains per block of the reference's Pallas
        grid; the block index is folded into the stream, so this must match
        the reference's to reproduce its bits.

    Returns:
      ``(x', e', accepted)``: e' = U(x'), accepted an (M,) int32 count.

    CPU tensors and ``interpret=True`` take the plain version; CUDA tensors
    launch the kernel, or raise when it cannot take them.
    """
    seed, t0, n_steps = int(seed) & _MASK, int(t0), int(n_steps)
    if n_steps < 0:
        raise ValueError(f"n_steps must be >= 0, got {n_steps}")
    block_chains = _block_chains(x.shape[0], block_rows)
    if interpret or x.device.type == "cpu":
        return _plain_sweep(x, beta, sigma, seed, t0, n_steps, potential,
                            block_chains)
    if x.device.type != "cuda":
        raise ValueError(f"no sweep kernel for device {x.device}")
    if not torch.is_tensor(sigma):
        sigma = torch.tensor(float(sigma), dtype=torch.float32,
                             device=x.device)
    return _cuda_sweep(x, beta, sigma, seed, t0, n_steps, potential,
                       block_chains)


def sharded_gaussian_sweep(mesh, axis, x, beta, sigma, seed, t0, n_steps, *,
                           potential, interpret=False):
    """Multi-device fused sweep (the reference's ``shard_map`` wrapper):
    this rank runs :func:`fused_gaussian_sweep` on its local chains ``x``,
    ``beta`` with its index on ``mesh`` folded into the seed
    (:func:`_shard_seed`), so ranks draw independent streams; sigma, seed,
    t0 and n_steps are the same on every rank.  On a CUDA tensor it
    launches the kernel, or raises.

    Reproducible for a fixed rank count; the stream is block-indexed, so
    results depend on it."""
    return fused_gaussian_sweep(x, beta, sigma, _mesh_seed(mesh, axis, seed),
                                t0, n_steps, potential=potential,
                                interpret=interpret)
