"""The reference's counter-hash stream and float32 helpers in numpy.

The port's row kernels draw from this stream (a Murmur3-style finalizer
over a lane counter, the step seed and the draw index); the plain
references here recompute it from the seed alone.  numpy's uint32
arithmetic wraps modulo 2**32, which is the stream's arithmetic.
"""

from __future__ import annotations

import numpy as np

MASK = 0xFFFFFFFF
GOLDEN = np.uint32(0x9E3779B9)
DRAW_TAG = 0x3243F6A9
STEP_PRIME = np.uint32(1000003)


def u32(a):
    return np.asarray(a, dtype=np.uint32)


def hash32(s):
    s = u32(s)
    with np.errstate(over="ignore"):
        s = s * np.uint32(0x85EBCA6B)
        s = s ^ (s >> np.uint32(13))
        s = s * np.uint32(0xC2B2AE35)
    return s ^ (s >> np.uint32(16))


def draw_bits(h, draw: int):
    """Bits of draw ``draw`` for lanes whose hash base is ``h``."""
    h = hash32(u32(h) ^ np.uint32((draw * DRAW_TAG) & MASK))
    return hash32(h + np.uint32(draw))


def uniform_from_bits(bits):
    """uint32 bits -> float32 uniform in (0, 1] (the mantissa trick)."""
    f = ((u32(bits) >> np.uint32(9)) | np.uint32(0x3F800000)).view(
        np.float32)
    return np.float32(2.0) - f


def bf16(a):
    """Round float32 values to bfloat16 precision (nearest, ties to even),
    kept as float32: the control's arithmetic."""
    a = np.asarray(a, dtype=np.float32)
    u = a.view(np.uint32)
    r = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return r.view(np.float32)


def device_draws(u1, theta, log_args, device):
    """Box-Muller's radius ``sqrt(-2 log u1)``, ``cos`` and ``sin`` of
    ``theta`` and the ``log`` of ``log_args`` (float32 numpy arrays),
    computed by torch on ``device``: on the card these are the CUDA math
    library's ``logf``, ``sqrtf``, ``cosf`` and ``sinf``, which the row
    kernels call, so the draws match theirs bit for bit."""
    import torch

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=device)
    th = t(theta)
    out = (torch.sqrt(-2.0 * torch.log(t(u1))), torch.cos(th),
           torch.sin(th), torch.log(t(log_args)))
    return tuple(o.cpu().numpy() for o in out)
