"""Plain reference of the ``harmonic1d`` configuration: Metropolis steps
of a 1-D particle in U(x) = x**2 with a symmetric Gaussian displacement,
drawn from the reference's counter-hash stream.

numpy float32 for the state arithmetic, torch on the card for ``log``,
``cos`` and ``sin`` only (the CUDA math library's functions, which the
kernel calls).  Imports nothing of the program.  ``precision='bfloat16'``
rounds every value of the state arithmetic to bfloat16: the control.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from harness.stream import (GOLDEN, MASK, bf16, device_draws,  # noqa: E402
                          draw_bits, hash32, u32, uniform_from_bits)

_LANES = 128
_TILE = 8 * _LANES
_TWO_PI = np.float32(6.283185307179586)


def block_chains(m: int, block_rows: int = 2048) -> int:
    """Chains per block of the stream's grid: (rows, 128) blocks over the
    population padded to whole (8, 128) tiles."""
    rows = -(-m // _TILE) * _TILE // _LANES
    return min(block_rows, rows) * _LANES


def potential(x):
    return x * x


def replay(x0, beta, chains, m, sigma, seed, t0, n_steps, device,
           precision="float32"):
    """Steps ``t0 .. t0 + n_steps - 1`` of the chains ``chains`` (indices
    into a population of ``m``) from positions ``x0``.  Returns ``(x, e,
    accepted)``."""
    r = bf16 if precision == "bfloat16" else (lambda a: a)
    chains = np.asarray(chains, np.int64)
    bc = block_chains(m)
    pid = chains // bc
    lane = (u32(chains - pid * bc) * GOLDEN + u32(pid) * np.uint32(1000003))
    t_end = t0 + n_steps
    p0 = t0 >> 1
    n_pairs = ((t_end - 1) >> 1) - p0 + 1 if n_steps > 0 else 0
    pairs = np.arange(p0, p0 + n_pairs, dtype=np.int64)
    pair_hash = hash32(u32((int(seed) + pairs) & MASK))
    h = lane[None, :] + pair_hash[:, None]                 # (pairs, S)
    u = [uniform_from_bits(draw_bits(h, k)) for k in range(4)]
    theta = _TWO_PI * u[1]
    rad, cos_t, sin_t, logs = device_draws(u[0], theta,
                                           np.stack([u[2], u[3]]), device)
    sig = np.float32(sigma)
    steps = np.empty((2 * n_pairs, len(chains)), np.float32)
    steps[0::2] = sig * (rad * cos_t)
    steps[1::2] = sig * (rad * sin_t)
    log_u = np.empty_like(steps)
    log_u[0::2] = logs[0]
    log_u[1::2] = logs[1]
    lo = t0 - 2 * p0                       # an odd start skips a half pair
    steps, log_u = r(steps[lo:lo + n_steps]), log_u[lo:lo + n_steps]
    x = r(np.asarray(x0, np.float32).copy())
    beta = r(np.asarray(beta, np.float32))
    e = r(potential(x))
    acc = np.zeros(len(chains), np.int32)
    for k in range(n_steps):
        xn = r(x + steps[k])
        en = r(potential(xn))
        ok = log_u[k] < r(beta * r(e - en))
        x = np.where(ok, xn, x)
        e = np.where(ok, en, e)
        acc += ok
    return x, e, acc


def mean_energy(x, precision="float32"):
    """The mean of U over all chains, in float64 (bfloat16 for the
    control)."""
    if precision == "bfloat16":
        xb = bf16(np.asarray(x, np.float32))
        return float(bf16(np.float32(np.mean(bf16(potential(xb)),
                                             dtype=np.float32))))
    x = np.asarray(x, np.float64)
    return float(np.mean(potential(x)))


def acceptance(counters, precision="float32"):
    """``callback_acceptance``'s value: the mean over chains and moves of
    accepted / attempted, moves never attempted left out."""
    c = np.asarray(counters, np.float64)
    acc, tot = c[..., 0], c[..., 1]
    valid = tot > 0
    v = float(np.sum(np.where(valid, acc / np.maximum(tot, 1.0), 0.0))
              / max(1, int(valid.sum())))
    return float(bf16(np.float32(v))) if precision == "bfloat16" else v
