"""``jax.random``'s counter-based stream in torch, over batches of keys.

The JAX package gives every chain its own threefry2x32 key and draws each
number of its generic path, its PGMC estimator and its models' initial
chains from it (``montecarlo_tpu/core/metropolis.py:10-14``).  This module
reproduces those draws bit for bit, on any device, from the same keys:

- a key is a tensor of shape ``(..., 2)`` holding the two uint32 words of
  ``jax.random.key_data`` (dtype ``torch.uint32``); leading dimensions are
  a batch of keys;
- every function takes a batch of keys and returns
  ``keys.shape[:-1] + shape`` values, which equals ``jax.vmap`` of the
  per-key call, the way the reference calls these functions per chain;
- each function follows ``jax/_src/random.py`` and ``jax/_src/prng.py`` of
  JAX 0.9 in the partitionable mode (``jax_threefry_partitionable``, on by
  default there): ``key`` (``threefry_seed``), ``fold_in``
  (``threefry_fold_in``), ``split`` (``_threefry_split_foldlike``),
  ``random_bits`` (``_threefry_random_bits_partitionable``), ``uniform``
  (``_uniform``), ``normal`` (``_normal_real``), ``randint``
  (``_randint``), ``bernoulli`` (``_bernoulli``, mode ``'low'``),
  ``gumbel`` (``_gumbel``, mode ``'low'``) and ``categorical`` (with
  replacement).

Each public draw is one ``mc.prng`` span
(:func:`~montecarlo_tpu_torch.utils.observability.span`) and one of the
run's ``prng_draws``.  The block function and each draw's finish run in
one call of
:func:`~montecarlo_tpu_torch.ops.threefry.threefry`: the CUDA kernel on
the card, its plain version on the CPU.  ``uniform``, ``random_bits``,
``randint``, ``bernoulli``, ``split`` and ``fold_in`` equal ``jax.random``
bit for bit; ``normal`` within a few float32 ulps (``log1p`` differs from
XLA's at the last bit), so ``gumbel``, and with it ``categorical``, may
differ from the reference only where two of its sums tie to an ulp.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..ops.threefry import draw
from .device import resolve_device
from .observability import count, span

__all__ = ["key", "key_data", "fold_in", "split", "random_bits", "uniform",
           "split_uniform", "normal", "randint", "bernoulli", "gumbel",
           "categorical"]

_MASK = 0xFFFFFFFF
_TINY32 = 1.1754943508222875e-38     # float32 tiny, gumbel's minval


def key(seed: int, device=None) -> torch.Tensor:
    """The key of ``seed``, as ``jax.random.key(seed)`` without x64: a
    ``(2,)`` uint32 tensor ``(0, seed mod 2**32)`` on ``device`` (the card,
    ``cuda``, when None).  Seeds 0 to 2**32 - 1 are taken as they are (42
    gives ``(0, 42)``); the installed JAX wraps any other seed of int64
    range to its low 32 bits (2**32 gives the key of 0, -1 that of
    2**32 - 1) and raises ``OverflowError`` beyond int64, and so does this
    function."""
    seed = int(seed)
    if not -2 ** 63 <= seed < 2 ** 63:
        raise OverflowError(f"seed {seed} is outside int64, as jax.random."
                            f"key refuses it")
    return torch.tensor([0, seed & _MASK], dtype=torch.uint32,
                        device=resolve_device(device))


def _public(fn):
    """A public draw: one ``mc.prng`` span and one counted draw.  Draws
    call each other's undecorated bodies (``__wrapped__``), so a draw is
    one span."""
    @functools.wraps(fn)
    def drawn(*args, **kwargs):
        count("prng_draws")
        with span("mc.prng"):
            return fn(*args, **kwargs)
    return drawn


def key_data(keys) -> torch.Tensor:
    """The uint32 words of ``keys`` (``jax.random.key_data``): the keys
    themselves, checked."""
    _check(keys)
    return keys


def _check(keys):
    if not torch.is_tensor(keys) or keys.dtype != torch.uint32 \
            or keys.dim() < 1 or keys.shape[-1] != 2:
        raise TypeError(f"keys must be a (..., 2) uint32 tensor, got "
                        f"{getattr(keys, 'shape', keys)!r} "
                        f"{getattr(keys, 'dtype', '')}")


def _shape(shape):
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(s) for s in shape)


def _flat(keys):
    """``(B, 2)`` keys (their rows strided or not: a split's keys, unbound,
    go to the kernel as they are) and the batch shape."""
    _check(keys)
    batch = tuple(keys.shape[:-1])
    return keys.reshape(-1, 2), batch


@_public
def fold_in(keys, data) -> torch.Tensor:
    """``jax.random.fold_in`` of each key with ``data`` (an int, or an
    integer tensor broadcast against ``keys.shape[:-1]``, taken mod 2**32):
    the block function at the count ``(0, data)``.  Returns keys of the
    broadcast batch shape."""
    _check(keys)
    if not torch.is_tensor(data):
        if not isinstance(data, (int, np.integer)):
            raise TypeError(f"fold_in takes integer data, got {data!r}")
        kf, batch = _flat(keys)
        return draw(kf, 1, "words", data=int(data)).reshape(batch + (2,))
    if data.is_floating_point() or data.is_complex():
        raise TypeError(f"fold_in takes integer data, got {data.dtype}")
    # numpy's broadcast: torch.broadcast_shapes imports sympy on first use,
    # seconds of a process's first generic run
    batch = tuple(np.broadcast_shapes(tuple(keys.shape[:-1]),
                                      tuple(data.shape)))
    # one key for many data stays a stride-0 view: the kernel reads rows
    # with any stride, and no uint32 tensor is copied on the card
    kf = keys.expand(batch + (2,)).reshape(-1, 2)
    d = data.to(device=keys.device, dtype=torch.int64).expand(batch)
    return draw(kf, 1, "words", data=d.reshape(-1)).reshape(batch + (2,))


@_public
def split(keys, num=2) -> torch.Tensor:
    """``jax.random.split``: ``num`` keys (an int, or a shape) from each
    key, ``keys.shape[:-1] + shape + (2,)``; the new keys are the block's
    two words at the row-major counts of ``shape``."""
    shape = _shape(num)
    kf, batch = _flat(keys)
    out = draw(kf, math.prod(shape), "words")
    return out.reshape(batch + shape + (2,))


@_public
def random_bits(keys, shape=()) -> torch.Tensor:
    """32 random bits per value (``jax.random.bits`` at uint32): the xor
    of the block's two words at the row-major counts of ``shape``."""
    shape = _shape(shape)
    kf, batch = _flat(keys)
    return draw(kf, math.prod(shape), "bits").reshape(batch + shape)


@_public
def uniform(keys, shape=(), dtype=torch.float32, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in ``[minval, maxval)``; ``minval`` and
    ``maxval`` are numbers.  float32 takes 23 bits of one word of bits,
    float64 52 bits of the block's two words, as JAX's 64-bit draw does."""
    shape = _shape(shape)
    kf, batch = _flat(keys)
    n = math.prod(shape)
    if dtype == torch.float32:
        out = draw(kf, n, "uniform", lo=float(minval), hi=float(maxval))
        return out.reshape(batch + shape)
    if dtype != torch.float64:
        raise TypeError(f"uniform takes float32 or float64, not {dtype}")
    w = draw(kf, n, "words").to(torch.int64)
    bits = ((w[..., 0] << 20) | (w[..., 1] >> 12)) | 0x3FF0000000000000
    f = bits.view(torch.float64) - 1.0
    lo = torch.tensor(float(minval), dtype=torch.float64, device=f.device)
    hi = torch.tensor(float(maxval), dtype=torch.float64, device=f.device)
    return torch.maximum(lo, f * (hi - lo) + lo).reshape(batch + shape)


@_public
def split_uniform(keys, shape=(), minval: float = 0.0,
                  maxval: float = 1.0):
    """``k, kthr = split(keys)`` and ``uniform(kthr, shape, float32,
    minval, maxval)``, as the pair ``(k, values)``: one step of a loop
    that splits its key anew each iteration, one call (one launch on the
    card)."""
    shape = _shape(shape)
    kf, batch = _flat(keys)
    nxt, out = draw(kf, math.prod(shape), "split_uniform",
                    lo=float(minval), hi=float(maxval))
    return nxt.reshape(batch + (2,)), out.reshape(batch + shape)


@_public
def normal(keys, shape=(), dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) * erf_inv(u)`` with
    XLA's float32 ``erf_inv`` polynomial, ``u`` uniform in
    ``[nextafter(-1, 0), 1)``."""
    if dtype != torch.float32:
        raise TypeError(f"normal draws float32, not {dtype}")
    shape = _shape(shape)
    kf, batch = _flat(keys)
    return draw(kf, math.prod(shape), "normal").reshape(batch + shape)


@_public
def randint(keys, shape, minval, maxval,
            dtype=torch.int32) -> torch.Tensor:
    """``jax.random.randint`` in ``[minval, maxval)`` (an empty range gives
    ``minval``): each key split in two, one word of bits from each, and
    JAX's multiply-and-modulo.  ``minval`` and ``maxval`` are ints or
    integer tensors of shape ``keys.shape[:-1]`` (one range per key), in
    int32 range.  Every dtype is drawn at 32 bits and converted, as JAX
    draws an int8 or int16 (bounds within the dtype's range)."""
    shape = _shape(shape)
    kf, batch = _flat(keys)

    def bound(v):
        if not torch.is_tensor(v):
            return int(v)
        return v.to(device=keys.device, dtype=torch.int32).expand(
            batch).reshape(-1)

    out = draw(kf, math.prod(shape), "randint", ilo=bound(minval),
               ihi=bound(maxval))
    return out.reshape(batch + shape).to(dtype)


@_public
def bernoulli(keys, p=0.5, shape=()) -> torch.Tensor:
    """``jax.random.bernoulli``: ``uniform(keys, shape) < p``, ``p`` a
    number or a float tensor broadcast against ``keys.shape[:-1] +
    shape``, drawn in ``p``'s dtype."""
    dtype = p.dtype if torch.is_tensor(p) else torch.float32
    return uniform.__wrapped__(keys, shape, dtype) < p


@_public
def gumbel(keys, shape=(), dtype=torch.float32) -> torch.Tensor:
    """``jax.random.gumbel`` (mode ``'low'``): ``-log(-log(u))`` with
    ``u`` uniform in ``[tiny, 1)``."""
    if dtype != torch.float32:
        raise TypeError(f"gumbel draws float32, not {dtype}")
    return -torch.log(-torch.log(uniform.__wrapped__(keys, shape, dtype,
                                               minval=_TINY32)))


@_public
def categorical(keys, logits) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis of ``logits``, shared
    by every key (``jax.vmap(categorical, (0, None))``): the argmax of
    Gumbel noise of ``logits.shape`` plus the logits, an int64 index per
    key, ``keys.shape[:-1] + logits.shape[:-1]``."""
    logits = torch.as_tensor(logits, device=keys.device)
    g = gumbel.__wrapped__(keys, tuple(logits.shape), torch.float32)
    return torch.argmax(g + logits, dim=-1)
