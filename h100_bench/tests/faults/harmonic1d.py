"""The ``harmonic1d`` configuration's timed path broken underneath: kernel
#1's wrapper returning its input state, or its positions altered, and the
energy callback's mean taken over half of the chains."""

import torch

import montecarlo_tpu_torch.ops.fused_sweep as fs
from montecarlo_tpu_torch.models import particle1d as p1d

from bench_helpers import half_mean


def _unchanged_gaussian(real):
    def sweep(x, beta, sigma, seed, t0, n_steps, **kw):
        _, _, acc = real(x, beta, sigma, seed, t0, n_steps, **kw)
        return x.clone(), kw["potential"](x), torch.zeros_like(acc)
    return sweep


def _altered_gaussian(real):
    def sweep(*a, **kw):
        x, e, acc = real(*a, **kw)
        return x + 1e-6, e, acc
    return sweep


FAULTS = {
    "unchanged": (fs, "fused_gaussian_sweep", _unchanged_gaussian),
    "half_batch": (p1d, "callback_energy", half_mean),
    "altered": (fs, "fused_gaussian_sweep", _altered_gaussian),
}
