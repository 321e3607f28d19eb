"""Plain reference of the ``ka2d`` configuration: the 2-D Kob-Andersen
mixture under a pool of one Gaussian particle displacement and one A-B
species swap, drawn from the reference's counter-hash stream, and its
O(N^2) truncated-and-shifted LJ energy.

The replay keeps the row kernel's documented arithmetic: the pair energy
``4 eps (i6^2 - i6) - shift`` with ``i6 = (s2 / max(r2, 1e-12))^3`` by an
exact reciprocal, the minimum image by ``round``, and each row's sum in the
order of a block of W warps (a thread's strided partial sums, a butterfly
in each warp, the warp sums in turn).  numpy float32 for the state
arithmetic, torch on the card for ``log``, ``cos`` and ``sin`` only.
Imports nothing of the program.  ``precision='bfloat16'`` rounds every
value of the state arithmetic to bfloat16: the control.
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from harness.stream import (GOLDEN, MASK, STEP_PRIME, bf16,  # noqa: E402
                          device_draws, draw_bits, hash32,
                          u32, uniform_from_bits)

_LANES = 128
_WARP = 32
_MAX_WARPS = 16
_SWAP_TAG = 0x5CA1AB1E
_ACCEPT_TAG = 0x0ACCE97
_KIND_TAG = 0x7AB1E5
_TWO_PI = np.float32(2.0 * math.pi)


def block_warps(n: int) -> int:
    """The warps whose order a row's sum follows, from N alone: one slot a
    thread up to 8 warps, then up to four slots a thread, then 16 warps."""
    def pow2(slots_per_warp):
        w = 1
        while w < _MAX_WARPS and w * slots_per_warp < n:
            w *= 2
        return w
    return max(pow2(128), min(8, pow2(32)))


def pair_table(eps, sig, rcut, box):
    """float32 constants: eps, sig^2, rc^2 and the shift at r_c for the
    AA, AB, BB pairs (index s_i + s_j), the box and its inverse."""
    eps = np.asarray(eps, np.float32)
    sig = np.asarray(sig, np.float32)
    rc = float(rcut)

    def shift(e, s):
        ic6 = (1.0 / rc) ** 6
        return 4.0 * e * (ic6 * ic6 - ic6)

    pairs = ((0, 0), (0, 1), (1, 1))
    box_f = np.float32(box)
    return dict(
        eps=np.asarray([eps[a, b] for a, b in pairs], np.float32),
        s2=np.asarray([sig[a, b] ** 2 for a, b in pairs], np.float32),
        rc2=np.asarray([(rc * sig[a, b]) ** 2 for a, b in pairs], np.float32),
        shift=np.asarray([shift(eps[a, b], sig[a, b]) for a, b in pairs],
                         np.float32),
        box=box_f, inv_box=np.float32(1.0) / box_f)


def lane_sum(u, warps, r=lambda a: a):
    """Sums over the last axis in a W-warp block's order: thread t's
    slots t, t + 32 W, ... in turn, a butterfly in each warp, the warp
    sums in turn (``cumsum`` adds in order)."""
    *lead, n = u.shape
    threads = warps * _WARP
    groups = max(1, -(-n // threads))
    if groups * threads != n:
        pad = np.zeros(tuple(lead) + (groups * threads - n,), u.dtype)
        u = np.concatenate([u, pad], axis=-1)
    u = u.reshape(tuple(lead) + (groups, warps, _WARP))
    if r is _exact:
        p = np.cumsum(u, axis=-3, dtype=np.float32)[..., -1, :, :]
    else:
        p = u[..., 0, :, :]
        for g in range(1, groups):
            p = r(p + u[..., g, :, :])
    w = _WARP
    while w > 1:
        w //= 2
        p = r(p[..., :w] + p[..., w:2 * w])
    if r is _exact:
        return np.cumsum(p[..., 0], axis=-1, dtype=np.float32)[..., -1]
    total = p[..., 0, 0]
    for k in range(1, warps):
        total = r(total + p[..., k, 0])
    return total


def _exact(a):
    return a


def label_tables(tab, isb, r=_exact):
    """Per label q of a query particle, the (S, N) pair constants eps,
    sigma^2, r_c^2 and shift against each chain's particles (the pair type
    is q + s_j)."""
    return [{k: np.where(isb, r(tab[k])[q + 1], r(tab[k])[q])
             for k in ("eps", "s2", "rc2", "shift")} for q in (0, 1)]


def rows(tab, x, y, consts, qx, qy, excl, warps, r=_exact):
    """(S, R) energies of R virtual particles at (qx, qy) (each (S, R))
    against each chain's particles (x, y: (S, N)), with the pair constants
    ``consts`` ((S, R, N) or broadcastable), slots where ``excl`` (S, N) is
    True left out."""
    box, inv_box = tab["box"], tab["inv_box"]
    dx = r(x[:, None, :] - qx[..., None])
    dy = r(y[:, None, :] - qy[..., None])
    dx = r(dx - r(box * np.round(r(dx * inv_box))))
    dy = r(dy - r(box * np.round(r(dy * inv_box))))
    r2 = r(r(dx * dx) + r(dy * dy))
    eps, s2, rc2, shift = (consts[k] for k in ("eps", "s2", "rc2", "shift"))
    with np.errstate(over="ignore", invalid="ignore"):
        inv = r(s2 * r(np.float32(1.0) / np.maximum(r2, np.float32(1e-12))))
        i6 = r(r(inv * inv) * inv)
        u = r(r(r(np.float32(4.0) * eps) * r(r(i6 * i6) - i6)) - shift)
    u = np.where((r2 < rc2) & ~excl[:, None, :], u, np.float32(0.0))
    return lane_sum(u, warps, r)


def _pick_consts(lt, labels):
    """(S, R, N) constants of queries with ``labels`` (S, R)."""
    q = labels[..., None] > 0.5
    return {k: np.where(q, lt[1][k][:, None, :], lt[0][k][:, None, :])
            for k in lt[0]}


def _uniforms(h):
    return uniform_from_bits(draw_bits(h, 0))


def step_kinds(seed, t0, n_steps, pids, w_disp):
    """(n_steps, len(pids)) bool: is step t0 + k a displacement in the
    blocks ``pids``, from the block-shared kind draw."""
    base = hash32(u32((int(seed) + int(t0) + np.arange(n_steps,
                                                       dtype=np.int64))
                      & MASK))
    step_seed = base[:, None] + u32(pids)[None, :] * STEP_PRIME
    bits = hash32(step_seed ^ np.uint32(_KIND_TAG)) & np.uint32(0x7FFFFFFF)
    u = bits.astype(np.float32) * np.float32(2.0 ** -31)
    return u < np.float32(w_disp)


def replay(pos0, spc0, e0, beta, chains, m, tab, sigma, w_disp, seed, t0,
           n_steps, device, precision="float32", block_chains=256):
    """Steps ``t0 .. t0 + n_steps - 1`` of the chains ``chains`` (indices
    into a population of ``m``) from positions ``pos0`` (S, N, 2), labels
    ``spc0`` (S, N) and cached energies ``e0`` (S,).  Returns ``(pos, spc,
    e, accepted, attempted)``, the counts (S, 2): displacement, swap."""
    r = bf16 if precision == "bfloat16" else _exact
    chains = np.asarray(chains, np.int64)
    s_n, n = spc0.shape
    warps = block_warps(n)
    bc = min(block_chains, max(8, m))
    pid = chains // bc
    row = u32(chains - pid * bc)
    pid_seed = u32(pid) * STEP_PRIME
    col = np.arange(n)[None, :]
    w = np.float32(w_disp)
    kinds = step_kinds(seed, t0, n_steps, pid, w)             # (K, S)
    base = hash32(u32((int(seed) + int(t0) + np.arange(n_steps,
                                                       dtype=np.int64))
                      & MASK))
    seeds = base[:, None] + pid_seed[None, :]                 # (K, S)
    lanes = [u32(row * np.uint32(_LANES) + np.uint32(c)) * GOLDEN
             for c in range(4)]
    u_pick, u1, u2, u_dacc = (_uniforms(lanes[c][None, :] + seeds)
                              for c in range(4))
    u_sacc = _uniforms(lanes[0][None, :] + (seeds ^ np.uint32(_ACCEPT_TAG)))
    theta = _TWO_PI * u2
    rad, cos_t, sin_t, logs = device_draws(u1, theta,
                                           np.stack([u_dacc, u_sacc]), device)
    rad = np.float32(sigma) * rad
    ddx, ddy = rad * cos_t, rad * sin_t
    pick = np.minimum((u_pick * np.float32(n)).astype(np.int64), n - 1)
    plane = u32(row[:, None] * np.uint32(n) + u32(col)) * GOLDEN  # (S, N)
    x = r(np.ascontiguousarray(pos0[..., 0], np.float32))
    y = r(np.ascontiguousarray(pos0[..., 1], np.float32))
    spc = np.asarray(spc0, np.float32).copy()
    e = r(np.asarray(e0, np.float32).copy())
    neg_beta = r(-np.asarray(beta, np.float32))
    box, inv_box = tab["box"], tab["inv_box"]
    acc = np.zeros((s_n, 2), np.int32)
    att = np.zeros((s_n, 2), np.int32)
    ar = np.arange(s_n)
    lt = label_tables(tab, spc > np.float32(0.5), r)
    for k in range(n_steps):
        disp = kinds[k]
        att[:, 0] += disp
        att[:, 1] += ~disp
        if disp.any():
            i = pick[k]
            xi, yi, si = x[ar, i], y[ar, i], spc[ar, i]
            xn, yn = r(xi + r(ddx[k])), r(yi + r(ddy[k]))
            q = rows(tab, x, y, _pick_consts(lt, si[:, None]),
                     np.stack([xi, xn], 1), np.stack([yi, yn], 1),
                     col == i[:, None], warps, r)
            d_e = r(q[:, 1] - q[:, 0])
            ok = disp & (logs[0][k] < r(neg_beta * d_e))
            xw = r(xn - r(box * np.floor(r(xn * inv_box))))
            yw = r(yn - r(box * np.floor(r(yn * inv_box))))
            x[ar[ok], i[ok]] = xw[ok]
            y[ar[ok], i[ok]] = yw[ok]
            e = np.where(ok, r(e + d_e), e)
            acc[:, 0] += ok
        if (~disp).any():
            h = plane + (seeds[k] ^ np.uint32(_SWAP_TAG))[:, None]
            ua = uniform_from_bits(draw_bits(h, 0))
            ub = uniform_from_bits(draw_bits(h, 1))
            is_b = spc > np.float32(0.5)
            ia, oka = _pick(ua, ~is_b)
            ib, okb = _pick(ub, is_b)
            valid = oka & okb
            ia, ib = np.where(valid, ia, 0), np.where(valid, ib, 0)
            excl = (col == ia[:, None]) | (col == ib[:, None])
            qx = np.stack([x[ar, ia], x[ar, ib]] * 2, 1)
            qy = np.stack([y[ar, ia], y[ar, ib]] * 2, 1)
            qs = np.tile(np.float32([0, 1, 1, 0]), (s_n, 1))
            q = rows(tab, x, y, _pick_consts(lt, qs), qx, qy, excl, warps,
                     r)
            d_e = r(r(q[:, 2] + q[:, 3]) - r(q[:, 0] + q[:, 1]))
            ok = ~disp & valid & (logs[1][k] < r(neg_beta * d_e))
            spc[ar[ok], ia[ok]] = 1.0
            spc[ar[ok], ib[ok]] = 0.0
            if ok.any():
                lt = label_tables(tab, spc > np.float32(0.5), r)
            e = np.where(ok, r(e + d_e), e)
            acc[:, 1] += ok
    pos = np.stack([x, y], axis=-1)
    return pos, spc, e, acc, att


def _pick(u, mask):
    """Gumbel-max pick among ``mask`` slots: the largest uniform, the
    lowest index on ties; ``(index, any)``."""
    score = np.where(mask, u, np.float32(-1.0))
    top = score.max(axis=1, keepdims=True)
    hit = (score == top) & mask
    return hit.argmax(axis=1), mask.any(axis=1)


def total_energy(pos, spc, box, eps, sig, rcut, device, dtype="float64",
                 chain_batch=8, row_batch=256):
    """(M,) O(N^2) energies of the truncated-and-shifted LJ mixture under
    the minimum image, in torch on ``device``, chains and rows in blocks:
    in float64, or for the control (``dtype='bfloat16'``) with the squared
    distances from float32 positions and every energy term and sum in
    bfloat16."""
    import torch
    low = dtype == "bfloat16"
    dt = torch.bfloat16 if low else torch.float64
    geo = torch.float32 if low else torch.float64
    pos = torch.as_tensor(pos)
    spc = torch.as_tensor(spc)
    m, n, _ = pos.shape
    eps_t = torch.tensor(eps, dtype=dt, device=device)
    sig_t = torch.tensor(sig, dtype=dt, device=device)
    b = torch.tensor(float(box), dtype=geo, device=device)
    rc = float(rcut)
    ic6 = (1.0 / rc) ** 6
    out = []
    for c0 in range(0, m, chain_batch):
        p = pos[c0:c0 + chain_batch].to(device=device, dtype=geo)
        s = spc[c0:c0 + chain_batch].to(device=device).long()
        tot = torch.zeros(p.shape[0], dtype=dt, device=device)
        for r0 in range(0, n, row_batch):
            d = p[:, r0:r0 + row_batch, None, :] - p[:, None, :, :]
            d = d - b * torch.round(d / b)
            r2 = (d * d).sum(-1).to(dt)
            si = s[:, r0:r0 + row_batch, None]
            sj = s[:, None, :]
            e_ = eps_t[si, sj]
            sg = sig_t[si, sj]
            inv6 = (sg * sg / r2.clamp(min=1e-12)) ** 3
            u = 4.0 * e_ * (inv6 * inv6 - inv6) - 4.0 * e_ * (ic6 * ic6 - ic6)
            u = torch.where(r2 < (rc * sg) ** 2, u, torch.zeros_like(u))
            ids = torch.arange(r0, min(n, r0 + row_batch), device=device)
            u = torch.where(ids[None, :, None] == torch.arange(
                n, device=device)[None, None, :], torch.zeros_like(u), u)
            tot = tot + u.sum(dim=(1, 2))
        out.append((0.5 * tot).double().cpu())
    return torch.cat(out).numpy()
