"""The threefry2x32 block function of ``jax.random``, over batches of keys.

The JAX package draws every random number of its generic Metropolis path,
its PGMC estimator and its models' ``init_chains`` from ``jax.random``'s
default stream: threefry2x32 (``jax/_src/prng.py``: ``threefry_2x32``,
``_threefry2x32_lowering``) in its partitionable mode.  In the reference
XLA fuses the block function into whatever consumes it; there is no Pallas
kernel.  Here :func:`threefry` evaluates it for a batch of keys, elementwise
over the keys and their counts, and finishes the draw in the same pass, so
a draw is one call.  It has two bodies:

- the hand-written CUDA kernel ``csrc/threefry.cu`` (:data:`THREEFRY_KERNEL`),
  launched for CUDA tensors;
- a plain version, taken for CPU tensors: the rounds on the host in numpy
  uint32 arrays, which wrap as the block function does (torch has no
  unsigned 32-bit arithmetic to speak of), and each draw's float finish in
  torch on the keys' device.  The tests hold it against ``jax.random``,
  and ``chip_smoke.py`` holds the kernel against it.

A call evaluates ``B * n`` blocks: key ``b`` (a row of ``keys``) at the
counts ``0 .. n-1``, each count split into its high and low words as
``iota_2x32_shape`` splits the row-major flat index, or, with ``data``,
at the one count ``(0, data)`` of ``fold_in`` (``data`` a number for every
key or one a key).  ``mode`` says what is
made of the block's two output words:

- ``"words"``: both, ``(B, n, 2)`` uint32 (``split``, ``fold_in``);
- ``"bits"``: their xor, ``(B, n)`` uint32 (``random_bits`` at 32 bits);
- ``"uniform"``: float32 in ``[lo, hi)`` by the mantissa trick of
  ``jax.random._uniform``, ``max(lo, fma(f, hi - lo, lo))`` (XLA fuses
  the scale and shift into one multiply-add);
- ``"normal"``: float32, ``sqrt(2) * erf_inv(u)`` with ``u`` uniform in
  ``[nextafter(-1, 0), 1)`` and XLA's float32 ``erf_inv`` polynomial (as
  ``jax.random._normal_real``);
- ``"randint"``: int32 in ``[ilo, ihi)`` (numbers, or one a key),
  ``jax.random._randint``'s two-key multiply-and-modulo (the key split in
  two, one word of bits from each half);
- ``"split_uniform"``: ``k, kthr = split(key)`` and float32 uniforms in
  ``[lo, hi)`` from ``kthr``, returned as the pair ``(k (B, 2) uint32,
  values (B, n))``: one step of a loop that draws from a key it splits
  anew each iteration (the soft-potential event chains' thresholds), one
  launch.

Numbers (a fold_in's data, randint's bounds) reach the kernel as its
arguments, so a draw on the card is one launch and no copy.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ._cuda import CudaKernel

__all__ = ["threefry", "draw", "MODES", "THREEFRY_KERNEL",
           "LAUNCHES_BY_MODE"]

MODES = ("words", "bits", "uniform", "normal", "randint", "split_uniform")

THREEFRY_KERNEL = CudaKernel(
    "threefry.cu", "mc_threefry",
    [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
     ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float,
     ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
     ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])

#: the kernel's launches by mode (their sum is ``THREEFRY_KERNEL.launches``)
LAUNCHES_BY_MODE = dict.fromkeys(MODES, 0)

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

#: XLA's float32 ErfInv (the chlo decomposition): a degree-8 polynomial in
#: w - 2.5 for w = -log1p(-x^2) < 5, else in sqrt(w) - 3
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
_SQRT2 = 1.4142135381698608          # float32(sqrt(2))
_NORMAL_LO = -0.99999994039535522    # float32 nextafter(-1, 0)


def block(k0, k1, x0, x1):
    """Threefry2x32 of keys ``(k0, k1)`` at counts ``(x0, x1)``: numpy
    uint32 arrays, broadcast together; returns the two output words, as
    ``_threefry2x32_lowering`` computes them (20 rounds of add, rotate and
    xor, five key injections).

    uint32 arithmetic wraps as the block function's does, so no step needs
    a mask, and each round updates the words in place: on the host a small
    draw's time is the ops' count, which this keeps near the block's own
    ~115."""
    k0, k1, x0, x1 = np.broadcast_arrays(k0, k1, x0, x1)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(_PARITY))
    x0 = x0 + k0
    x1 = x1 + k1
    high = np.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            np.right_shift(x1, 32 - r, out=high)
            x1 <<= r
            x1 |= high
            x1 ^= x0
        x0 += ks[(i + 1) % 3]
        x1 += ks[(i + 2) % 3]
        x1 += np.uint32(i + 1)
    return x0, x1


def _f32(v: float, device):
    return torch.tensor(v, dtype=torch.float32, device=device)

def _fma32(a, b, c):
    """float32 ``a * b + c`` rounded once, as a fused multiply-add.  The
    product of two float32 is exact in float64, so the float64 sum ``s`` is
    rounded once, and rounding it to float32 gives the fused result unless
    ``s`` fell exactly on a float32 rounding midpoint (its 29 bits below
    float32 precision ``1 << 28``) that the exact sum is not on.  There
    (one sum in ~5e8) Knuth's two-sum gives the sum's error, and ``s`` is
    moved one float64 ulp toward it.  Results in float32's subnormal range
    are not handled; none arise here."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    mid = (s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000
    if bool(mid.any()):
        bb = s - p
        err = (p - (s - bb)) + (c - bb)
        toward = torch.where(err > 0, torch.inf, -torch.inf).double()
        s = torch.where(mid & (err != 0), torch.nextafter(s, toward), s)
    return s.float()


def _power_of_two(v: float) -> bool:
    m, _ = math.frexp(v)
    return m == 0.5


def _uniform_bits(bits, lo: float, hi: float, device):
    """float32 in [lo, hi) on ``device`` from numpy uint32 ``bits``, as
    ``jax.random._uniform`` compiles on XLA: 23 random mantissa bits under
    the exponent of 1, minus 1, scaled and shifted in one fused
    multiply-add, and clamped below at ``lo``."""
    one = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    f = torch.from_numpy(one).to(device) - 1.0
    lo_t, hi_t = _f32(lo, device), _f32(hi, device)
    span = hi_t - lo_t
    if _power_of_two(float(span)):
        # f * span is exact: the add is the fused multiply-add's one rounding
        return torch.maximum(lo_t, f * span + lo_t)
    return torch.maximum(lo_t, _fma32(f, span, lo_t))


def erf_inv(x):
    """XLA's float32 ``erf_inv`` (not ``torch.erfinv``, another
    approximation): the same polynomial, its Horner steps fused
    multiply-adds as XLA compiles them."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma32(p, w, torch.where(lt, a, b))
    return p * x


def _column(v, b: int, dtype):
    """A number or a per-key tensor as a (B, 1) numpy array of ``dtype``
    (int64 values taken mod 2**32 for uint32)."""
    v = v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
    v = np.broadcast_to(v.astype(np.int64).reshape(-1, 1), (b, 1))
    return (v & _MASK).astype(dtype) if dtype == np.uint32 else v


def _counts(n: int):
    """The iota counts ``0 .. n-1`` as their (high, low) uint32 words."""
    j = np.arange(n, dtype=np.uint64)[None]
    return ((j >> np.uint64(32)).astype(np.uint32),
            (j & np.uint64(_MASK)).astype(np.uint32))


def _plain(keys, n, mode, data, lo, hi, ilo, ihi):
    """The plain twin: the block function's rounds on the host in numpy
    uint32, each draw's float finish in torch on the keys' device."""
    dev = keys.device
    k = keys.cpu().numpy()
    b = k.shape[0]
    k0, k1 = k[:, 0:1], k[:, 1:2]
    if data is not None:
        x0, x1 = np.zeros((1, 1), np.uint32), _column(data, b, np.uint32)
    else:
        x0, x1 = _counts(n)
    out = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    if mode == "randint":
        # split(key) into two keys (counts 0 and 1), then a word of bits
        # from each at every count: two evaluations over both halves
        s0, s1 = block(k0, k1, np.zeros((1, 2), np.uint32),
                       np.arange(2, dtype=np.uint32)[None])     # (B, 2)
        h0, h1 = block(s0[..., None], s1[..., None], x0[:, None],
                       x1[:, None])                             # (B, 2, n)
        bits = h0 ^ h1
        higher, lower = bits[:, 0], bits[:, 1]
        lo_i, hi_i = _column(ilo, b, np.int64), _column(ihi, b, np.int64)
        span = np.where(hi_i <= lo_i, 1, (hi_i - lo_i) & _MASK).astype(
            np.uint32)
        # 2**16 % span squared, in uint32 (it wraps to 0 above 2**16)
        mult = np.uint32(65536) % span
        mult = (mult * mult) % span
        off = ((higher % span) * mult + lower % span) % span
        return out((lo_i.astype(np.uint32) + off).view(np.int32))
    if mode == "split_uniform":
        # split(key): the next key at count 0, the draw's key at count 1
        w0, w1 = block(k0, k1, np.zeros((1, 2), np.uint32),
                       np.arange(2, dtype=np.uint32)[None])     # (B, 2)
        nxt = out(np.stack([w0[:, 0], w1[:, 0]], axis=-1))
        v0, v1 = block(w0[:, 1:2], w1[:, 1:2], x0, x1)
        return nxt, _uniform_bits(v0 ^ v1, lo, hi, dev)
    w0, w1 = block(k0, k1, x0, x1)
    if mode == "words":
        return out(np.stack([w0, w1], axis=-1))
    bits = w0 ^ w1
    if mode == "bits":
        return out(bits)
    if mode == "uniform":
        return _uniform_bits(bits, lo, hi, dev)
    return _SQRT2 * erf_inv(_uniform_bits(bits, _NORMAL_LO, 1.0, dev))


_MODE_ID = {m: i for i, m in enumerate(MODES)}
_OUT_DTYPE = {"words": torch.uint32, "bits": torch.uint32,
              "uniform": torch.float32, "normal": torch.float32,
              "randint": torch.int32, "split_uniform": torch.float32}


def _on(t, keys):
    """A per-key tensor argument, checked and contiguous, or None for a
    number."""
    if not torch.is_tensor(t):
        return None
    if t.device != keys.device:
        raise ValueError(f"a tensor on {t.device} with keys on "
                         f"{keys.device}")
    return t if t.is_contiguous() else t.contiguous()


#: the kernel's C entry point, resolved at the first launch
_FN = None


def _cuda(keys, n, mode, data, lo, hi, ilo, ihi):
    global _FN
    b = keys.shape[0]
    dev = keys.device
    shape = (b, n, 2) if mode == "words" else (b, n)
    out = torch.empty(shape, dtype=_OUT_DTYPE[mode], device=dev)
    nxt = (torch.empty((b, 2), dtype=torch.uint32, device=dev)
           if mode == "split_uniform" else None)
    if out.numel() == 0:
        return out if nxt is None else (nxt, out)
    if keys.stride(1) != 1:
        keys = keys.contiguous()
    data_t, ilo_t, ihi_t = (_on(t, keys) for t in (data, ilo, ihi))
    # a number of data as the kernel's argument (-1: iota counts)
    fold = -1 if data is None or data_t is not None else int(data) & _MASK
    ptr = lambda t: None if t is None else t.data_ptr()
    scalar = lambda v, t: 0 if t is not None else int(v)
    if _FN is None:
        _FN = THREEFRY_KERNEL.build()
    index = dev.index
    args = (keys.data_ptr(), keys.stride(0), b, n, ptr(data_t), fold,
            _MODE_ID[mode], lo, hi, ptr(ilo_t), ptr(ihi_t),
            scalar(ilo, ilo_t), scalar(ihi, ihi_t), out.data_ptr(),
            ptr(nxt))
    if index == torch.cuda.current_device():
        # the launch is a few microseconds: no device guard where the keys
        # are on the current device, and the raw stream handle
        err = _FN(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(dev):
            err = _FN(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"mc_threefry launch failed: cudaError {err}")
    THREEFRY_KERNEL.launches += 1
    LAUNCHES_BY_MODE[mode] += 1
    return out if nxt is None else (nxt, out)


def _per_key(t, b: int, dtype, what: str):
    if not torch.is_tensor(t):
        return int(t)
    if t.is_floating_point() or t.numel() not in (1, b):
        raise ValueError(f"{what} must be an int or an integer tensor of one "
                         f"value or one a key ({b}), got {tuple(t.shape)} "
                         f"{t.dtype}")
    return t.reshape(-1).expand(b).to(dtype)


def threefry(keys, n: int = 1, mode: str = "words", *, data=None,
             lo: float = 0.0, hi: float = 1.0, ilo=0, ihi=1,
             interpret: bool = False):
    """Evaluate the block function for ``keys`` (a ``(B, 2)`` uint32
    tensor, its rows strided or not) at ``n`` iota counts each, or with
    ``data`` (an int, or an integer tensor of one value a key; then ``n``
    is 1) at the counts ``(0, data mod 2**32)``, and finish the draw by
    ``mode`` (see the module's docstring): ``lo``/``hi`` are the float32
    bounds of ``"uniform"`` and ``"split_uniform"``, ``ilo``/``ihi`` the
    int32 bounds of ``"randint"`` (ints, or integer tensors of one value a
    key).  Returns ``(B, n)`` values, ``(B, n, 2)`` for ``"words"``, and
    for ``"split_uniform"`` the pair ``(next keys (B, 2), values (B, n))``.

    CPU tensors and ``interpret=True`` take the plain version; CUDA
    tensors launch the kernel."""
    if mode not in _MODE_ID:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if keys.dtype != torch.uint32 or keys.dim() != 2 or keys.shape[1] != 2:
        raise TypeError(f"keys must be a (B, 2) uint32 tensor, got "
                        f"{tuple(keys.shape)} {keys.dtype}")
    # rows of keys may be strided (a split's keys, unbound), words not
    b = keys.shape[0]
    if data is not None:
        if n != 1:
            raise ValueError("a fold_in (data given) makes one block a key")
        if mode == "split_uniform":
            raise ValueError("split_uniform takes no fold_in data")
        data = _per_key(data, b, torch.int64, "data")
    if mode == "randint":
        ilo = _per_key(ilo, b, torch.int32, "ilo")
        ihi = _per_key(ihi, b, torch.int32, "ihi")
    else:
        ilo = ihi = 0
    return draw(keys, n, mode, data, lo, hi, ilo, ihi, interpret)


def draw(keys, n, mode, data=None, lo=0.0, hi=1.0, ilo=0, ihi=1,
         interpret=False):
    """:func:`threefry` without its checks, for callers that made them
    (``utils/prng.py``, a few microseconds of host time a draw): ``keys``
    a (B, 2) uint32 tensor, ``mode`` one of :data:`MODES`, ``data`` None,
    an int or an int64 tensor of B values, ``ilo``/``ihi`` ints or int32
    tensors of B values."""
    if interpret or keys.device.type == "cpu":
        return _plain(keys, n, mode, data, lo, hi, ilo, ihi)
    if keys.device.type != "cuda":
        raise ValueError(f"no threefry kernel for device {keys.device}")
    return _cuda(keys, n, mode, data, float(lo), float(hi), ilo, ihi)
