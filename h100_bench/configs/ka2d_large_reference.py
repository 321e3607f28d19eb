"""Plain reference of the ``ka2d_large`` configuration: the 2-D
Kob-Andersen mixture under the checkerboard cell-list Metropolis of one
Gaussian particle displacement and one A-B species swap, its draws from
``jax.random``'s threefry2x32 stream.

Written from the cell path's documented semantics (a segment's grid
shift and binning, the checkerboard colours, the occupant pick, the halo,
the 3 x 3 neighbourhood, the two substeps, the unbind, the draws'
derivation from the segment's key, the sum order), in numpy float32; torch
on the run's device for ``log``, ``log1p`` and ``sqrt`` only (on the card
the CUDA math library's ``logf``, ``log1pf`` and ``sqrtf``, which the
program's accept test and its normal draws call).  Imports nothing of the
program.
``precision='bfloat16'`` rounds every value of the state arithmetic to
bfloat16: the control.

**The stream** (``jax.random`` in its partitionable mode): a key is two
uint32 words, ``key(seed) = (0, seed)``; ``fold_in(k, d)`` and the
``j``-th key of ``split(k, n)`` are both the block ``threefry2x32(k, (0,
d))``; the ``j``-th value of a draw of shape ``s`` takes the block at the
count ``(j >> 32, j & 0xffffffff)``, ``j`` the row-major index into ``s``;
its bits are the xor of the block's two words.  A uniform in ``[lo, hi)``
is ``max(lo, fma(f, hi - lo, lo))`` with ``f`` the float32 of 23 bits
under the exponent of 1, less 1; a normal is ``sqrt(2) erf_inv(u)`` with
``u`` uniform in ``[nextafter(-1, 0), 1)`` and XLA's float32 ``erf_inv``
(``w = -log1p(-u^2)``, a degree-8 polynomial of fused multiply-adds in ``w
- 2.5`` below 5, else in ``sqrt(w) - 3``); ``randint(k, 0, n)`` splits
``k`` in two and takes ``((hi % n) * (2^16 % n)^2 + lo % n) % n`` of a word
of bits from each.

**A segment** (``t0``: its first micro-step; ``c``: a chain's global id):
``base = fold_in(key(seed), t0)``; substep ``i``'s (kind, colour) from
``kv = fold_in(fold_in(fold_in(base, 0x7C01), 0xC0110), i)``, the colour
``randint(kv, 0, 4)`` (parities (0, 0), (0, 1), (1, 0), (1, 1)), a
displacement where ``uniform(fold_in(kv, 1)) < w_disp``, else a swap; the
grid's origin ``uniform(fold_in(fold_in(fold_in(base, 0x5A1F7), 0x0F5E7),
c), (2,))``; substep ``i``'s three keys ``split(fold_in(fold_in(base, c),
i), 3)``: the pick's (or the first swapper's) uniforms over ``(h, h,
cap)``, the displacement's normals over ``(h, h, 2)`` (or the second
swapper's uniforms), the accept test's uniforms over ``(h, h)``.  The
fractional positions ``s = (x / L + origin) mod 1`` are binned into
``nc x nc`` cells, ``int(s nc)`` on each axis, in the particles' order
within a cell (slot = rank); a cell holding more than ``cap`` leaves the
chain's segment a no-op with no attempts.  A substep of colour
``(px, py)`` works on the ``h x h`` cells ``(2a + px, 2b + py)``, each
picking one occupant (the largest uniform among its occupied slots, the
lowest slot on ties; a swap picks an A and a B that way).  A displacement
proposes ``s' = s + (sigma / L) z`` and rejects a proposal outside the
cell widened by ``d_cap / L`` on every side; both move the energy against
every other occupant of the 3 x 3 cells around the active one, and accept
where ``log u < -beta dE``.  Energies are summed as the path states: the
float32 terms accumulated in float64, rounded once; so are a chain's
accepted ``dE`` of a substep.  After the substeps each particle's position
is ``((s - origin) mod 1) L``.  A period's substeps are ``floor(want)``
with ``want = float32(steps * sweepstep) * float32(z) + debt``, ``z = 1 /
(nc^2 / 4)`` a move, the float32 remainder carried as the next period's
``debt`` from 0 at the run's start.

**The pair energy** (the truncated-and-shifted LJ of the cell path, on
labels 0 = A, 1 = B): per pair type the float32 constants ``sigma^2``,
``r_c^2 = (r_c sigma)^2``, ``4 eps`` and the shift ``4 eps * float32(ic6^2
- ic6)`` with ``ic6 = (1 / r_c^2)^3`` in float64; ``u = 4 eps (i6 i6 - i6)
- shift`` with ``i6 = (inv inv) inv``, ``inv = sigma^2 / max(r^2,
1e-12)``, where ``r^2 < r_c^2``; ``r^2 = ((d_x - round d_x)^2 + (d_y -
round d_y)^2) L^2`` of the fractional differences ``d``.
"""

from __future__ import annotations

import itertools
import math
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from harness.stream import bf16  # noqa: E402

MASK = 0xFFFFFFFF
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA
_NORMAL_LO = np.float32(-0.99999994)        # float32 nextafter(-1, 0)
_SQRT2 = np.float32(1.41421354)
_ERF_INV_LT5 = np.float32([2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                           -4.39150654e-06, 0.00021858087, -0.00125372503,
                           -0.00417768164, 0.246640727, 1.50140941])
_ERF_INV_GE5 = np.float32([-0.000200214257, 0.000100950558, 0.00134934322,
                           -0.00367342844, 0.00573950773, -0.0076224613,
                           0.00943887047, 1.00167406, 2.83297682])
_VARIANT_TAGS = (0x7C01, 0xC0110)
_SHIFT_TAGS = (0x5A1F7, 0x0F5E7)
#: the colours' parities, in the order ``randint(kv, 0, 4)`` indexes them
PARITIES = tuple(itertools.product((0, 1), repeat=2))


# ---------------------------------------------------------------------------
# threefry2x32 and the draws
# ---------------------------------------------------------------------------

def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block of 20 rounds (Salmon et al., SC11; Random123)
    of keys ``(k0, k1)`` at counts ``(x0, x1)``, numpy uint32 arrays
    broadcast together; its two output words."""
    k0, k1, x0, x1 = (np.asarray(a, np.uint32) for a in (k0, k1, x0, x1))
    k0, k1, x0, x1 = np.broadcast_arrays(k0, k1, x0, x1)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(_PARITY))
    with np.errstate(over="ignore"):      # uint32 arithmetic wraps
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for r in range(20):
            rot = _ROTATIONS[r % 8]
            x0 = x0 + x1
            x1 = ((x1 << np.uint32(rot)) | (x1 >> np.uint32(32 - rot))) ^ x0
            if r % 4 == 3:
                s = r // 4 + 1
                x0 = x0 + ks[s % 3]
                x1 = x1 + ks[(s + 1) % 3] + np.uint32(s)
    return x0, x1


def key(seed):
    """``jax.random.key(seed)``'s two words, for a seed in [0, 2**32)."""
    return np.asarray([0, int(seed) & MASK], np.uint32)


def fold_in(k, data):
    """``fold_in`` of keys ``k`` (..., 2) with ``data`` (broadcast against
    ``k``'s batch, taken mod 2**32)."""
    k = np.asarray(k, np.uint32)
    d = np.asarray(np.asarray(data, np.int64) & MASK, np.uint32)
    w0, w1 = threefry2x32(k[..., 0], k[..., 1], np.uint32(0), d)
    return np.stack([w0, w1], axis=-1)


def split(k, n):
    """``split(k, n)``: keys (..., n, 2)."""
    k = np.asarray(k, np.uint32)[..., None, :]
    return fold_in(k, np.arange(n))


def bits(k, n):
    """32 bits at the counts 0 .. n - 1 of each key: (..., n) uint32."""
    k = np.asarray(k, np.uint32)[..., None, :]
    j = np.arange(n, dtype=np.uint64)
    w0, w1 = threefry2x32(k[..., 0], k[..., 1],
                          (j >> np.uint64(32)).astype(np.uint32),
                          (j & np.uint64(MASK)).astype(np.uint32))
    return w0 ^ w1


def fma32(a, b, c):
    """float32 ``a * b + c`` rounded once.  The product of two float32 is
    exact in float64 and the float64 sum ``s`` is rounded once; rounding
    ``s`` to float32 is then the one rounding, except where ``s`` landed on
    a float32 midpoint that the exact sum is not on: there ``s`` moves one
    float64 step towards the exact sum (its error by Knuth's two-sum)."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    s = p + c
    v = s - p
    err = (p - (s - v)) + (c - v)
    mid = (s.view(np.uint64) & np.uint64(0x1FFFFFFF)) == np.uint64(0x10000000)
    fix = mid & (err != 0)
    if np.any(fix):
        s = np.where(fix, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)),
                     s)
    return s.astype(np.float32)


def uniform(k, n, lo=0.0, hi=1.0):
    """``uniform(k, (n,), float32, lo, hi)``: (..., n) float32."""
    f = ((bits(k, n) >> np.uint32(9)) | np.uint32(0x3F800000)).view(
        np.float32) - np.float32(1.0)
    lo, hi = np.float32(lo), np.float32(hi)
    return np.maximum(lo, fma32(f, hi - lo, lo))




def _device(fn, a, device):
    """torch's ``fn`` (``'log'``, ``'log1p'``, ``'sqrt'``) of the float32
    array ``a`` on ``device``, back as numpy: on the card the CUDA math
    library's."""
    import torch
    t = torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)
    return getattr(torch, fn)(t).cpu().numpy()


def normal(k, n, device):
    """``normal(k, (n,), float32)``: (..., n) float32."""
    x = uniform(k, n, _NORMAL_LO, 1.0)
    w = -_device("log1p", x * -x, device)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5),
                 _device("sqrt", w, device) - np.float32(3.0))
    p = np.where(lt, _ERF_INV_LT5[0], _ERF_INV_GE5[0])
    for a, b in zip(_ERF_INV_LT5[1:], _ERF_INV_GE5[1:]):
        p = fma32(p, w, np.where(lt, a, b))
    return _SQRT2 * (p * x)


def randint(k, n_max):
    """``randint(k, (), 0, n_max)`` of each key: (...,) int64."""
    halves = split(k, 2)
    higher = bits(halves[..., 0, :], 1)[..., 0]
    lower = bits(halves[..., 1, :], 1)[..., 0]
    span = np.uint32(n_max)
    mult = np.uint32(65536) % span
    mult = (mult * mult) % span
    return (((higher % span) * mult + lower % span) % span).astype(np.int64)


# ---------------------------------------------------------------------------
# The plan, the substep counts and the variants
# ---------------------------------------------------------------------------

def plan(n, box, rcut_max, pos0, d_cap=0.45, cap_slack=2.0):
    """``(nc, cap)``: the largest even ``nc`` with ``box / nc >= rcut_max +
    2 d_cap``; ``cap`` the larger of ``cap_slack`` times the mean occupancy
    and two more than the most particles in one cell of the initial
    configuration ``pos0`` (at most 64 chains, the grid unshifted), rounded
    up to a multiple of 8, at least 8."""
    nc = int(box / (rcut_max + 2.0 * d_cap))
    nc -= nc % 2
    pos = np.asarray(pos0, np.float32)[:64]
    ci = np.clip((pos / np.float32(box) * np.float32(nc)).astype(np.int64),
                 0, nc - 1)
    cid = ci[..., 0] * nc + ci[..., 1] + nc * nc * np.arange(len(pos))[:, None]
    cap = max(n / nc ** 2 * cap_slack, np.bincount(cid.ravel()).max() + 2.0)
    return nc, max(8, int(math.ceil(cap / 8.0)) * 8)


def move_shares(weights):
    """The displacement's and the swap's shares of the pool, from the
    float32 weights over their float32 sum, in float64."""
    w = np.asarray(weights, np.float32)
    total = float(w.sum())
    return float(w[0]) / total, float(w[1]) / total


def substeps(periods, steps, sweepstep, nc, shares):
    """Substeps of each of ``periods`` segments of ``steps`` steps from the
    run's start, and the displacement's share of a substep."""
    a_att = nc * nc // 4
    z = (shares[0] + shares[1]) / a_att
    debt = np.float32(0.0)
    out = []
    for _ in range(periods):
        want = np.float32(steps * sweepstep) * np.float32(z) + debt
        out.append(int(np.floor(want)))
        debt = want - np.float32(out[-1])
    return out, (shares[0] / a_att) / z


def variants(base, n, w_disp):
    """(n, 2): each substep's kind (0 a displacement, 1 a swap) and
    colour."""
    kc = fold_in(fold_in(base, _VARIANT_TAGS[0]), _VARIANT_TAGS[1])
    kv = fold_in(kc[None], np.arange(n))
    colour = randint(kv, 4)
    u = uniform(fold_in(kv, 1), 1)[:, 0]
    return np.stack([(u >= np.float32(w_disp)).astype(np.int64), colour], 1)


# ---------------------------------------------------------------------------
# The pair energy
# ---------------------------------------------------------------------------

def pair_constants(eps, sig, rcut):
    """Per pair type ``t = a_i + a_j`` (0 AA, 1 AB, 2 BB) the float32
    ``sigma^2``, ``r_c^2``, ``4 eps`` and shift."""
    e = np.float32([eps[0][0], eps[0][1], eps[1][1]])
    s = np.float32([sig[0][0], sig[0][1], sig[1][1]])
    rs = np.float32(rcut) * s
    ic = 1.0 / (rcut * rcut)
    ic6 = ic * ic * ic
    four = np.float32(4.0) * e
    return dict(s2=s * s, rc2=rs * rs, four_eps=four,
                shift=four * np.float32(ic6 * ic6 - ic6))


def _exact(a):
    return a


def row_energies(r2, t, ok, tab, r=_exact):
    """(R,) float32: each row's sum over its K slots ((R, K) squared
    distances ``r2``, pair types ``t``, ``ok`` the slots that count) of
    the pair energy inside the cut-off, the terms accumulated in float64
    and rounded once."""
    ok = ok & (r2 < tab["rc2"][t])
    rows, cols = np.nonzero(ok)
    x, tt = r2[rows, cols], t[rows, cols]
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        inv = r(tab["s2"][tt] / np.maximum(x, np.float32(1e-12)))
        i6 = r(r(inv * inv) * inv)
        u = r(r(r(tab["four_eps"][tt]) * r(r(i6 * i6) - i6))
              - r(tab["shift"][tt]))
    out = np.bincount(rows, weights=u.astype(np.float64),
                      minlength=r2.shape[0])
    return r(out.astype(np.float32))


def dist2(p, crd, box2, r=_exact):
    """(..., K) squared minimum-image distances, real units, from the
    fractional probes ``p`` (..., 2) to the fractional slots ``crd``
    (..., K, 2)."""
    out = None
    for a in range(2):
        d = r(crd[..., a] - p[..., a, None])
        d = r(d - np.round(d))
        d = r(d * d)
        out = d if out is None else r(out + d)
    return r(out * box2)


# ---------------------------------------------------------------------------
# Binding and the segment
# ---------------------------------------------------------------------------

def fractions(pos, box, shift, r=_exact):
    """``(x / L + origin) mod 1``, 1 taken to 0."""
    s = r(np.remainder(r(r(pos / box[:, None, None]) + shift[:, None, :]),
                       np.float32(1.0)))
    return np.where(s >= np.float32(1.0), np.float32(0.0), s)


def bind(s, nc, cap):
    """Each particle's cell (x-major) and slot (its rank among the
    cell's particles in their order), and the chains that overflow."""
    ci = np.clip((s * np.float32(nc)).astype(np.int32), 0, nc - 1)
    cid = ci[..., 0].astype(np.int64) * nc + ci[..., 1]
    order = np.argsort(cid, axis=1, kind="stable")
    sorted_c = np.take_along_axis(cid, order, 1)
    n = cid.shape[1]
    start = np.zeros_like(sorted_c)
    new = np.ones_like(sorted_c, dtype=bool)
    new[:, 1:] = sorted_c[:, 1:] != sorted_c[:, :-1]
    start = np.maximum.accumulate(np.where(new, np.arange(n), 0), axis=1)
    rank_sorted = np.arange(n) - start
    rank = np.empty_like(rank_sorted)
    np.put_along_axis(rank, order, rank_sorted, 1)
    return cid, rank, np.any(rank >= cap, axis=1)


def neighbours(nc, parity):
    """(h*h, 9) flat indices of the 3 x 3 cells around each active cell of
    colour ``parity``, the centre at index 4."""
    h = nc // 2
    a = np.arange(h) * 2
    cx = (a + parity[0])[:, None, None]
    cy = (a + parity[1])[None, :, None]
    off = np.asarray(list(itertools.product((-1, 0, 1), repeat=2)))
    nb = ((cx + off[:, 0]) % nc) * nc + (cy + off[:, 1]) % nc
    return nb.reshape(h * h, 9), (cx[:, 0, 0], cy[0, :, 0])


def attempts(s, species, nc, cap, seq):
    """Each chain's (displacement, swap) attempts of a segment bound from
    fractions ``s`` (M, N, 2): an occupied active cell attempts one
    displacement, one holding an A and a B one swap; a chain that
    overflows attempts nothing."""
    cid, _, over = bind(s, nc, cap)
    m = s.shape[0]
    flat = cid + nc * nc * np.arange(m)[:, None]
    occ = np.bincount(flat.ravel(), minlength=m * nc * nc).reshape(m, nc, nc)
    nb_ = np.bincount(flat.ravel(), weights=np.asarray(species).ravel(),
                      minlength=m * nc * nc).reshape(m, nc, nc)
    out = np.zeros((m, 2), np.int64)
    for kind, colour in seq:
        px, py = PARITIES[colour]
        o = occ[:, px::2, py::2]
        if kind == 0:
            out[:, 0] += (o > 0).sum(axis=(1, 2))
        else:
            b = nb_[:, px::2, py::2]
            out[:, 1] += ((b > 0) & (o - b > 0)).sum(axis=(1, 2))
    out[over] = 0
    return out


def segment_keys(seed, t0):
    return fold_in(key(seed), t0)


def origins(base, chains):
    """(S, 2) the chains' grid origins."""
    ks = fold_in(fold_in(base, _SHIFT_TAGS[0]), _SHIFT_TAGS[1])
    return uniform(fold_in(ks[None], np.asarray(chains)), 2)


def segment(pos0, spc0, e0, beta, box, chains, tab, sigma, d_cap, nc, cap,
            seed, t0, n_sub, w_disp, device, precision="float32"):
    """One segment of ``n_sub`` substeps of the chains ``chains`` (global
    ids) from positions ``pos0`` (S, N, 2), labels ``spc0`` (S, N),
    energies ``e0``, ``beta`` and boxes ``box`` (S,).  Returns ``(pos,
    spc, e, accepted, attempted)``, the counts (S, 2): displacement,
    swap."""
    r = bf16 if precision == "bfloat16" else _exact
    s_n, n, _ = pos0.shape
    h = nc // 2
    box = np.asarray(box, np.float32)
    base = segment_keys(seed, t0)
    seq = variants(base, n_sub, w_disp)
    shift = origins(base, chains)
    ck = fold_in(base[None], np.asarray(chains))
    keys = fold_in(ck[:, None], np.arange(n_sub))            # (S, n, 2)
    keys = split(keys, 3)                                    # (S, n, 3, 2)
    s = fractions(r(np.asarray(pos0, np.float32)), box, shift, r)
    cid, rank, over = bind(s, nc, cap)
    # the cells' slots: fractions, labels, occupancy, particle index
    cells = nc * nc
    ar = np.arange(s_n)[:, None]
    slot = np.where(rank < cap, cid * cap + rank, cells * cap)
    crd = np.zeros((s_n, cells * cap + 1, 2), np.float32)
    lab = np.zeros((s_n, cells * cap + 1), np.int64)
    occ = np.zeros((s_n, cells * cap + 1), bool)
    idx = np.full((s_n, cells * cap + 1), n, np.int64)
    crd[ar, slot] = s
    lab[ar, slot] = np.asarray(spc0, np.int64)
    occ[ar, slot] = True
    idx[ar, slot] = np.arange(n)
    crd, lab, occ, idx = (a[:, :cells * cap].reshape((s_n, cells, cap)
                                                      + a.shape[2:])
                          for a in (crd, lab, occ, idx))
    e = r(np.asarray(e0, np.float32).copy())
    neg_beta = r(-np.asarray(beta, np.float32))[:, None]
    box2 = r(box * box)[:, None, None]
    step = r(np.float32(sigma) / box)[:, None, None]
    halo = r(np.float32(d_cap) / box)[:, None]
    width = np.float32(1.0 / nc)
    slots = np.arange(cap)
    acc = np.zeros((s_n, 2), np.int64)
    att = np.zeros((s_n, 2), np.int64)
    disp = seq[:, 0] == 0
    # every normal and every accept test's log at once, on the device
    z = np.zeros((s_n, n_sub, h * h, 2), np.float32)
    if disp.any():
        z[:, disp] = normal(keys[:, disp, 1], h * h * 2, device).reshape(
            s_n, -1, h * h, 2)
    log_u = _device("log", uniform(keys[:, :, 2], h * h), device)
    # an invalid swap's picks may read an energy of inf, and so may an
    # overlap in the control's bfloat16: inf - inf and inf * beta are
    # not attempted or not accepted, without a warning
    with np.errstate(over="ignore", invalid="ignore"):
        for i, (kind, colour) in enumerate(seq):
            parity = PARITIES[colour]
            nb, (ox, oy) = neighbours(nc, parity)
            act = nb[:, 4]
            o_a = occ[:, act]                                    # (S, hh, C)
            crd9 = crd[:, nb].reshape(s_n, h * h, 9 * cap, 2)
            lab9 = lab[:, nb].reshape(s_n, h * h, 9 * cap)
            occ9 = occ[:, nb].reshape(s_n, h * h, 9 * cap)
            rows = s_n * h * h

            def energy(r2, a, mask):
                t = (a[..., None] + lab9).reshape(rows, -1)
                return row_energies(r2, t, mask.reshape(rows, -1), tab,
                                    r).reshape(s_n, h * h)

            def geometry(p):
                return dist2(p, crd9, box2, r).reshape(rows, -1)

            def pick(u, mask):
                k = np.argmax(np.where(mask, u, np.float32(-1.0)), axis=-1)
                return (slots == k[..., None]) & mask, k

            if kind == 0:
                u_pick = uniform(keys[:, i, 0], h * h * cap).reshape(
                    s_n, h * h, cap)
                sel, k = pick(u_pick, o_a)
                has = o_a.any(-1)
                pi = np.take_along_axis(crd[:, act], k[..., None, None],
                                        2)[:, :, 0]              # (S, hh, 2)
                ai = np.take_along_axis(lab[:, act], k[..., None], 2)[..., 0]
                pn = r(pi + r(step * z[:, i]))
                origin = np.stack(np.broadcast_arrays(
                    (ox.astype(np.float32) / np.float32(nc))[:, None],
                    (oy.astype(np.float32) / np.float32(nc))[None, :]),
                    -1).reshape(h * h, 2)
                lo = r(origin[None] - halo[..., None])
                hi = r(r(origin + width)[None] + halo[..., None])
                inbox = np.all((pn >= lo) & (pn < hi), axis=-1)
                mask = occ9.copy()
                mask[..., 4 * cap:5 * cap] &= ~sel
                d_e = r(energy(geometry(pn), ai, mask)
                        - energy(geometry(pi), ai, mask))
                ok = has & inbox & (log_u[:, i] < r(neg_beta * d_e))
                upd = (sel & ok[..., None])
                cur = crd[:, act]
                crd[:, act] = np.where(upd[..., None], pn[:, :, None, :], cur)
                tries = has
            else:
                u_i = uniform(keys[:, i, 0], h * h * cap).reshape(
                    s_n, h * h, cap)
                u_j = uniform(keys[:, i, 1], h * h * cap).reshape(
                    s_n, h * h, cap)
                lab_a = lab[:, act]
                sel_i, k_i = pick(u_i, o_a & (lab_a == 0))
                sel_j, k_j = pick(u_j, o_a & (lab_a == 1))
                tries = sel_i.any(-1) & sel_j.any(-1)
                crd_a = crd[:, act]
                p_i = np.take_along_axis(crd_a, k_i[..., None, None],
                                         2)[:, :, 0]
                p_j = np.take_along_axis(crd_a, k_j[..., None, None],
                                         2)[:, :, 0]
                a_i = np.take_along_axis(lab_a, k_i[..., None], 2)[..., 0]
                a_j = np.take_along_axis(lab_a, k_j[..., None], 2)[..., 0]
                mask = occ9.copy()
                mask[..., 4 * cap:5 * cap] &= ~(sel_i | sel_j)
                r2_i, r2_j = geometry(p_i), geometry(p_j)
                old = r(energy(r2_i, a_i, mask) + energy(r2_j, a_j, mask))
                new = r(energy(r2_i, a_j, mask) + energy(r2_j, a_i, mask))
                d_e = r(new - old)
                ok = tries & (log_u[:, i] < r(neg_beta * d_e))
                lab[:, act] = np.where(sel_i & ok[..., None], a_j[..., None],
                                       np.where(sel_j & ok[..., None],
                                                a_i[..., None], lab_a))
            gained = np.where(ok, d_e, np.float32(0.0)).astype(np.float64)
            e = r(e + r(gained.sum(axis=1).astype(np.float32)))
            att[:, kind] += tries.sum(axis=1)
            acc[:, kind] += ok.sum(axis=1)
    # the particles back in their order, in real units
    s_out = np.zeros((s_n, n + 1, 2), np.float32)
    spc = np.zeros((s_n, n + 1), np.float32)
    s_out[ar, idx.reshape(s_n, -1)] = crd.reshape(s_n, -1, 2)
    spc[ar, idx.reshape(s_n, -1)] = lab.reshape(s_n, -1)
    frac = r(np.remainder(r(s_out[:, :n] - shift[:, None, :]),
                          np.float32(1.0)))
    frac = np.where(frac >= np.float32(1.0), np.float32(0.0), frac)
    pos = r(frac * box[:, None, None])
    spc = spc[:, :n]
    # an overflowing chain's segment does nothing
    pos = np.where(over[:, None, None], pos0, pos)
    spc = np.where(over[:, None], np.asarray(spc0, np.float32), spc)
    e = np.where(over, np.asarray(e0, np.float32), e)
    acc[over] = 0
    att[over] = 0
    return pos, spc, e, acc, att
