"""Fused sweeps for 2-D Lennard-Jones move pools.

Port of ``montecarlo_tpu/ops/lj_sweep.py``.  Two entry points, each with
two bodies:

- :func:`fused_lj_sweep` — a pool of one displacement move
  (``models/lennard_jones.lj_displacement_move``): uniform particle pick,
  2-D Box–Muller displacement, ΔE from two O(N) truncated-shifted LJ rows
  under the minimum image, accept ``log u < -beta dE``, wrap into the box,
  incremental energy.
- :func:`fused_lj_mixed_sweep` — the displacement + species-swap pool: each
  step draws one move kind per block of the reference's chain grid, and a
  swap exchanges the labels of one A and one B particle picked by
  Gumbel-max over two (B, N) uniform planes.

CUDA tensors launch the hand-written kernels in ``csrc/lj_sweep.cu`` (one
block of :func:`block_warps` warps per chain, the chain's particles in
shared memory for the whole segment) or raise; CPU tensors and
``interpret=True`` take the plain torch versions below.  Both draw from
the reference's counter-hash stream with the reference's block geometry,
so the plain versions reproduce its
interpret-mode results on the CPU (equal accept counts, positions within
float32 ulps of log/cos/sin), and the kernels reproduce the plain versions
bit for bit on the card.

Two choices follow the reference kernel rather than the model: the pair
energy is ``s2 * reciprocal(max(r2, 1e-12))`` (the model divides), and the
row sums are taken in the CUDA kernel's thread order (:func:`_lane_sum`):
a partial sum per thread t of the chain's block over slots ``t, t + 32 W,
...``, a 5-level butterfly in each of the W warps, then the W warp sums in
turn.  W depends on N alone (:func:`block_warps`), so the order does not
depend on the number of chains or on the card.  The reference sums in XLA's
order, so energies differ from it by float32 ulps of the row sums.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ._cuda import CudaKernel
from .fused_sweep import (_GOLDEN, _MASK, _draw_bits, _hash32, _mul32,
                          _uniform_from_bits)

__all__ = ["fused_lj_sweep", "fused_lj_mixed_sweep", "block_warps",
           "MAX_PARTICLES", "LJ_KERNEL", "LJ_MIXED_KERNEL"]

_LANES = 128
_WARP = 32
_STEP_PRIME = 1000003
_SWAP_TAG = 0x5CA1AB1E
_ACCEPT_TAG = 0x0ACCE97
_KIND_TAG = 0x7AB1E5
_MAX_WARPS = 16
#: most particles a chain's block holds in shared memory: x, y and the
#: species or diameter as float32 in the 227 KB a Hopper block may opt into,
#: less the 3 KB of the LJ block's scratch (row sums, arg-max, a batch of
#: draws).  The polydisperse kernel has no scratch and shares the limit.
MAX_PARTICLES = (232448 - 3072) // 12

_ARGS = [ctypes.c_void_p] * 5          # pos, species, beta, energy, scalars
_TAIL = [ctypes.c_int64, ctypes.c_uint32, ctypes.c_int32, ctypes.c_int32,
         ctypes.c_void_p]          # block_chains, seed, t0, n_steps, stream
_SHAPE = [ctypes.c_int64, ctypes.c_int]                 # m, n
LJ_KERNEL = CudaKernel(
    "lj_sweep.cu", "mc_lj_sweep",
    _ARGS + [ctypes.c_void_p] * 3 + _SHAPE + [ctypes.c_int] + _TAIL)
LJ_MIXED_KERNEL = CudaKernel(
    "lj_sweep.cu", "mc_lj_mixed_sweep",
    _ARGS + [ctypes.c_void_p] * 5 + _SHAPE + [ctypes.c_int] + _TAIL)


def block_warps(n: int) -> int:
    """W, the warps of the block that serves one chain of ``n`` particles
    in the LJ kernels, a power of two: one slot a thread up to 8 warps
    (N <= 256), then up to four slots a thread (8 warps to N 1024, 16 to
    N 2048), then 16 warps (timed on an H100: a step is bound by its
    latency, which more threads shorten, until one SM's issue rate
    bounds it).  It depends on N alone, because the row sums' order
    (:func:`_lane_sum`) follows it: the plain version and the kernel read
    it here."""
    def pow2_warps(slots_per_warp):
        warps = 1
        while warps < _MAX_WARPS and warps * slots_per_warp < n:
            warps *= 2
        return warps

    return max(pow2_warps(128), min(8, pow2_warps(32)))


# -- the scalar table ----------------------------------------------------------

def _lj_scalars(params, box, sigma, w_disp=1.0):
    """The reference kernel's 16-float table (numpy float32): sigma, box,
    1/box, the (eps, sig^2, rc^2, shift) species constants for AA, AB, BB,
    w_disp.  The shift comes from ``rcut`` alone, as the reference's does."""
    eps = np.asarray(params.eps, np.float32)
    sig = np.asarray(params.sig, np.float32)
    rc = float(params.rcut)

    def shift(e, s):
        ic6 = (1.0 / rc) ** 6
        return 4.0 * e * (ic6 * ic6 - ic6)

    box_f = np.float32(box)
    consts = np.asarray(
        [eps[0, 0], eps[0, 1], eps[1, 1],
         sig[0, 0] ** 2, sig[0, 1] ** 2, sig[1, 1] ** 2,
         (rc * sig[0, 0]) ** 2, (rc * sig[0, 1]) ** 2, (rc * sig[1, 1]) ** 2,
         shift(eps[0, 0], sig[0, 0]), shift(eps[0, 1], sig[0, 1]),
         shift(eps[1, 1], sig[1, 1])], np.float32)
    return np.concatenate([
        np.asarray([sigma, box_f, np.float32(1.0) / box_f], np.float32),
        consts, np.asarray([w_disp], np.float32)])


@functools.lru_cache(maxsize=16)
def _table_on(device, build, params, box, w_disp):
    """The table ``build(params, box, 0.0, w_disp)`` without sigma, on
    ``device``: built once per (device, build, params, box, w_disp), so a
    run copies it to the card once."""
    return torch.as_tensor(build(params, box, 0.0, w_disp), device=device)


def _table(params, box, sigma, w_disp, device, build=_lj_scalars):
    """The full table on ``device`` with ``sigma`` (a float or a 0-d
    tensor) in slot 0, made with device ops only."""
    const = _table_on(device, build, params, float(box), float(w_disp))
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=device)
    return torch.cat([sigma.reshape(1), const[1:]])


# -- the plain versions ----------------------------------------------------------

def _lane_sum(u, warps=1):
    """Row sums of ``u`` (M, N) in the CUDA kernels' order for a block of
    ``warps`` warps: per thread t < 32 W the sum of slots t, t + 32 W, ...
    in turn (the padding adds 0.0, which is exact); in each warp lane l +=
    lane l + o for o = 16, 8, 4, 2, 1; then the W warp sums in turn."""
    m, n = u.shape
    threads = warps * _WARP
    groups = max(1, -(-n // threads))
    if groups * threads != n:
        u = torch.nn.functional.pad(u, (0, groups * threads - n))
    u = u.view(m, groups, warps, _WARP)
    p = u[:, 0]
    for g in range(1, groups):
        p = p + u[:, g]
    w = _WARP
    while w > 1:
        w //= 2
        p = p[..., :w] + p[..., w:2 * w]
    total = p[:, 0, 0]
    for k in range(1, warps):
        total = total + p[:, k, 0]
    return total


def _row_energy(tab, x, y, spc, xi, yi, s_i, excl):
    """(M,) interaction energy of a virtual particle at (xi, yi) with label
    ``s_i`` (each (M, 1)) against every chain's particles, slots ``excl``
    left out: the reference's ``row_energy`` term by term."""
    box, inv_box = tab[1], tab[2]
    dx = x - xi
    dy = y - yi
    dx = dx - box * torch.round(dx * inv_box)
    dy = dy - box * torch.round(dy * inv_box)
    r2 = dx * dx + dy * dy
    same = spc == s_i
    is_a = s_i == 0.0

    def sel(k):          # the AA, AB, BB entries at table slots k, k+1, k+2
        return torch.where(same, torch.where(is_a, tab[k], tab[k + 2]),
                           tab[k + 1])

    eps, s2, rc2, shift = sel(3), sel(6), sel(9), sel(12)
    inv = s2 * torch.reciprocal(torch.clamp(r2, min=1e-12))
    i6 = inv * inv * inv
    u = 4.0 * eps * (i6 * i6 - i6) - shift
    u = torch.where((r2 < rc2) & ~excl, u, 0.0)
    return _lane_sum(u, block_warps(u.shape[1]))


def _uniform(lane, seeds, draw):
    """(M,) uniforms of draw ``draw`` for lanes with hash bases
    ``lane * GOLDEN`` (precomputed) and per-chain step seeds."""
    return _uniform_from_bits(_draw_bits((lane + seeds) & _MASK, draw))


def _disp_step(tab, x, y, spc, e, beta, seeds, lanes, col, row=_row_energy):
    """One displacement attempt on every chain (the reference's ``_kernel``
    body; ``row`` is the row energy of the table's potential, taking the
    per-particle labels or diameters ``spc``).  Returns (x, y, e,
    accepted)."""
    n = x.shape[1]
    u_pick, u1, u2, u_acc = (_uniform(lanes[c], seeds, 0) for c in range(4))
    i_sel = torch.clamp((u_pick * n).to(torch.int64), max=n - 1)[:, None]
    onehot = col == i_sel
    xi, yi, s_i = (a.gather(1, i_sel) for a in (x, y, spc))
    r = tab[0] * torch.sqrt(-2.0 * torch.log(u1))
    theta = (2.0 * math.pi) * u2
    xn = xi + (r * torch.cos(theta))[:, None]
    yn = yi + (r * torch.sin(theta))[:, None]
    e_old = row(tab, x, y, spc, xi, yi, s_i, onehot)
    e_new = row(tab, x, y, spc, xn, yn, s_i, onehot)
    d_e = e_new - e_old
    accept = torch.log(u_acc) < -beta * d_e
    upd = onehot & accept[:, None]
    box, inv_box = tab[1], tab[2]
    x = torch.where(upd, xn - box * torch.floor(xn * inv_box), x)
    y = torch.where(upd, yn - box * torch.floor(yn * inv_box), y)
    return x, y, e + torch.where(accept, d_e, 0.0), accept


def _pick_masked(col, mask, u):
    """One-hot of the Gumbel-max pick among ``mask`` slots: the largest
    uniform, the lowest index on ties; all False for an empty mask."""
    score = torch.where(mask, u, -1.0)
    top = score.max(dim=1, keepdim=True).values
    idx = torch.where((score == top) & mask, col, col.shape[1])
    return col == idx.min(dim=1, keepdim=True).values


def _swap_step(tab, x, y, spc, e, beta, seeds, lane0, plane, col):
    """One species-swap attempt on every chain (the reference's
    ``swap_branch``).  Returns (spc, e, accepted)."""
    h = (plane + (seeds ^ _SWAP_TAG)[:, None]) & _MASK
    ua = _uniform_from_bits(_draw_bits(h, 0))
    ub = _uniform_from_bits(_draw_bits(h, 1))
    u_acc = _uniform(lane0, seeds ^ _ACCEPT_TAG, 0)
    is_b = spc > 0.5
    oh_i = _pick_masked(col, ~is_b, ua)              # an A slot
    oh_j = _pick_masked(col, is_b, ub)               # a B slot
    oh_ij = oh_i | oh_j
    valid = oh_i.any(dim=1) & oh_j.any(dim=1)
    x_i, y_i, x_j, y_j = (torch.where(oh, a, 0.0).sum(dim=1, keepdim=True)
                          for oh in (oh_i, oh_j) for a in (x, y))
    zero = torch.zeros_like(x_i)
    one = torch.ones_like(x_i)
    e_old = (_row_energy(tab, x, y, spc, x_i, y_i, zero, oh_ij)
             + _row_energy(tab, x, y, spc, x_j, y_j, one, oh_ij))
    e_new = (_row_energy(tab, x, y, spc, x_i, y_i, one, oh_ij)
             + _row_energy(tab, x, y, spc, x_j, y_j, zero, oh_ij))
    d_e = e_new - e_old
    accept = valid & (torch.log(u_acc) < -beta * d_e)
    upd = accept[:, None]
    spc = torch.where(upd & oh_i, 1.0, torch.where(upd & oh_j, 0.0, spc))
    return spc, e + torch.where(accept, d_e, 0.0), accept


def _block_is_disp(step_seed: int, w_disp) -> bool:
    """The block-shared kind draw of a step: displacement or swap."""
    bits = _hash32(step_seed ^ _KIND_TAG) & 0x7FFFFFFF
    return bool(np.float32(bits) * np.float32(2.0 ** -31) < w_disp)


def _grid(m, bc, device):
    """(pid, row) of each chain in the reference's grid of ``bc``-chain
    blocks, as int64 tensors."""
    chain = torch.arange(m, dtype=torch.int64, device=device)
    pid = chain // bc
    return pid, chain - pid * bc


def _run_steps(x, y, attr, e, pid, bc, seed, t0, n_steps, w_disp, disp,
               swap=None):
    """The step loop of the plain versions.  ``disp(x, y, attr, e, seeds)
    -> (x, y, e, accepted)`` and ``swap(x, y, attr, e, seeds) -> (attr, e,
    accepted)`` make one attempt on every chain (``attr``: the labels or
    diameters; ``seeds``: the chains' step seeds).  Each step draws one kind
    per block, as the reference does (every step a displacement when
    ``swap`` is None); where the blocks of a step differ, both branches run
    and each chain keeps its own block's.  Returns ``(x, y, attr, e,
    accepted, attempted)``, the counts (M, 2) int32: column 0 displacement,
    column 1 swap."""
    m = x.shape[0]
    dev = x.device
    pid_seed = _mul32(pid, _STEP_PRIME)
    n_blocks = -(-m // bc)
    counts = torch.zeros((2, m), dtype=torch.int32, device=dev)
    tot = np.zeros((n_blocks, 2), np.int64)    # attempts per block and kind
    for k in range(n_steps):
        base = _hash32((seed + t0 + k) & _MASK)
        seeds = (pid_seed + base) & _MASK
        kinds = [swap is None or _block_is_disp(
            (base + p * _STEP_PRIME) & _MASK, w_disp) for p in range(n_blocks)]
        tot[:, 0] += kinds
        tot[:, 1] += [not d for d in kinds]
        if all(kinds):
            x, y, e, acc = disp(x, y, attr, e, seeds)
            counts[0] += acc.to(torch.int32)
            continue
        if not any(kinds):
            attr, e, acc = swap(x, y, attr, e, seeds)
            counts[1] += acc.to(torch.int32)
            continue
        mine = torch.as_tensor(kinds, device=dev)[pid]
        xd, yd, ed, acc_d = disp(x, y, attr, e, seeds)
        attr_s, es, acc_s = swap(x, y, attr, e, seeds)
        x = torch.where(mine[:, None], xd, x)
        y = torch.where(mine[:, None], yd, y)
        attr = torch.where(mine[:, None], attr, attr_s)
        e = torch.where(mine, ed, es)
        counts[0] += (acc_d & mine).to(torch.int32)
        counts[1] += (acc_s & ~mine).to(torch.int32)
    attempts = torch.as_tensor(tot, dtype=torch.int32, device=dev)[pid]
    return x, y, attr, e, counts.T.contiguous(), attempts


def _plain_sweep(pos, species, beta, energy, tab, w_disp, seed, t0, n_steps,
                 bc, mixed):
    """Both reference kernels in plain torch ops, step by step."""
    m, n, _ = pos.shape
    dev = pos.device
    col = torch.arange(n, device=dev)[None, :]
    pid, rows = _grid(m, bc, dev)
    lanes = [_mul32(rows * _LANES + c, _GOLDEN) for c in range(4)]
    plane = _mul32(rows[:, None] * n + col, _GOLDEN) if mixed else None

    def disp(x, y, spc, e, seeds):
        return _disp_step(tab, x, y, spc, e, beta, seeds, lanes, col)

    def swap(x, y, spc, e, seeds):
        return _swap_step(tab, x, y, spc, e, beta, seeds, lanes[0], plane,
                          col)

    x, y, spc, e, acc, tot = _run_steps(
        pos[..., 0], pos[..., 1], species.to(torch.float32), energy, pid, bc,
        seed, t0, n_steps, w_disp, disp, swap if mixed else None)
    pos_out = torch.stack([x, y], dim=-1)
    if not mixed:
        return pos_out, e.clone(), acc[:, 0].contiguous()
    return pos_out, spc.to(species.dtype), e.clone(), acc, tot


# -- the CUDA kernels ------------------------------------------------------------

def _cuda_sweep(kernel, mixed, pos, species, beta, energy, tab, seed, t0,
                n_steps, bc, attr=("species", torch.int32), warps=None):
    """Check the arguments and launch ``kernel``; ``attr`` names the
    per-particle array (``species``, or the poly kernel's ``diam``) and its
    dtype; ``warps`` is the block's warp count for a kernel that takes one
    (the LJ kernels), None for one warp per chain (the poly kernel)."""
    for name, t, dtype in (("pos", pos, torch.float32),
                           (attr[0], species, attr[1]),
                           ("beta", beta, torch.float32),
                           ("energy", energy, torch.float32),
                           ("scalars", tab, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != pos.device:
            raise ValueError(f"{name} is on {t.device}, pos on {pos.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    m, n, _ = pos.shape
    if (species.shape != (m, n) or beta.shape != (m,)
            or energy.shape != (m,)):
        raise ValueError(
            f"expected {attr[0]} (M, N), beta and energy (M,) for pos "
            f"{tuple(pos.shape)}, got {tuple(species.shape)}, "
            f"{tuple(beta.shape)}, {tuple(energy.shape)}")
    if not 1 <= n <= MAX_PARTICLES:
        raise ValueError(
            f"{kernel.symbol} takes 1 to {MAX_PARTICLES} particles per chain "
            f"(one block's shared memory), got {n}")
    if not 0 <= t0 <= 2 ** 31 - 1 - n_steps:
        raise ValueError(f"t0={t0}, n_steps={n_steps} overflow int32")
    pos_out = torch.empty_like(pos)
    e_out = torch.empty_like(energy)
    acc = torch.empty((m, 2) if mixed else (m,), dtype=torch.int32,
                      device=pos.device)
    outs = [pos_out.data_ptr()]
    if mixed:
        spc_out = torch.empty_like(species)
        tot = torch.empty_like(acc)
        outs += [spc_out.data_ptr(), e_out.data_ptr(), acc.data_ptr(),
                 tot.data_ptr()]
    else:
        outs += [e_out.data_ptr(), acc.data_ptr()]
    if m > 0:
        with torch.cuda.device(pos.device):
            stream = torch.cuda.current_stream().cuda_stream
            kernel.launch(pos.data_ptr(), species.data_ptr(), beta.data_ptr(),
                          energy.data_ptr(), tab.data_ptr(), *outs, m, n,
                          *(() if warps is None else (warps,)), bc, seed, t0,
                          n_steps, stream)
    if mixed:
        return pos_out, spc_out, e_out, acc, tot
    return pos_out, e_out, acc


def _sweep(mixed, pos, species, beta, energy, box, sigma, w_disp, seed, t0,
           n_steps, params, interpret, block_chains):
    seed, t0, n_steps = int(seed) & _MASK, int(t0), int(n_steps)
    if n_steps < 0:
        raise ValueError(f"n_steps must be >= 0, got {n_steps}")
    if pos.dim() != 3 or pos.shape[-1] != 2:
        raise ValueError(f"pos must be (M, N, 2), got {tuple(pos.shape)}")
    m = pos.shape[0]
    bc = min(block_chains, max(8, m))
    tab = _table(params, box, sigma, w_disp, pos.device)
    if interpret or pos.device.type == "cpu":
        return _plain_sweep(pos, species, beta, energy, tab,
                            np.float32(w_disp), seed, t0, n_steps, bc, mixed)
    if pos.device.type != "cuda":
        raise ValueError(f"no LJ sweep kernel for device {pos.device}")
    kernel = LJ_MIXED_KERNEL if mixed else LJ_KERNEL
    return _cuda_sweep(kernel, mixed, pos, species, beta, energy, tab, seed,
                       t0, n_steps, bc, warps=block_warps(pos.shape[1]))


def fused_lj_sweep(pos, species, beta, energy, box, sigma, seed, t0, n_steps,
                   *, params, interpret=False, block_chains=256):
    """Run ``n_steps`` LJ displacement attempts per chain in one call.

    Args:
      pos: (M, N, 2) float32 positions.
      species: (M, N) int32 labels (0/1).
      beta: (M,) float32; energy: (M,) float32 cached totals.
      box: float periodic box edge, the same for every chain.
      sigma: proposal width (float or 0-d float32 tensor).
      seed, t0, n_steps: ints; step k is seeded from ``seed + t0 + k``, so
        results do not depend on how a run is cut into segments.
      params: :class:`~montecarlo_tpu_torch.models.lennard_jones.LJParams`.
      interpret: run the plain torch version on any device.
      block_chains: chains per block of the reference's Pallas grid; the
        block index is folded into the stream, so this must match the
        reference's to reproduce its bits.

    Returns:
      ``(pos', energy', accepted)``, accepted an (M,) int32 count.

    CPU tensors and ``interpret=True`` take the plain version; CUDA tensors
    launch the kernel, or raise when it cannot take them.
    """
    return _sweep(False, pos, species, beta, energy, box, sigma, 1.0, seed,
                  t0, n_steps, params, interpret, block_chains)


def fused_lj_mixed_sweep(pos, species, beta, energy, box, sigma, w_disp,
                         seed, t0, n_steps, *, params, interpret=False,
                         block_chains=256):
    """Run ``n_steps`` mixed displacement/swap attempts per chain in one
    call (the reference's ``fused_lj_mixed_sweep``).

    Args:
      w_disp: probability of drawing the displacement move
        (``weight_disp / (weight_disp + weight_swap)``).
      (others as :func:`fused_lj_sweep`)

    Returns:
      ``(pos', species', energy', accepted, attempted)`` with accepted and
      attempted (M, 2) int32: column 0 displacement, column 1 swap.
    """
    return _sweep(True, pos, species, beta, energy, box, sigma, w_disp, seed,
                  t0, n_steps, params, interpret, block_chains)
