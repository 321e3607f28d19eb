"""The ``ka2d`` configuration's timed path broken underneath: kernel #3's
wrapper returning its input state, or its energies altered, and the
energy callback's mean taken over half of the chains."""

import torch

import montecarlo_tpu_torch.ops.lj_sweep as ls
from montecarlo_tpu_torch.models import lennard_jones as lj

from bench_helpers import half_mean


def _unchanged_lj(real):
    def sweep(pos, species, beta, energy, *a, **kw):
        _, _, _, acc, tot = real(pos, species, beta, energy, *a, **kw)
        return (pos.clone(), species.clone(), energy.clone(),
                torch.zeros_like(acc), tot)
    return sweep


def _altered_lj(real):
    def sweep(*a, **kw):
        pos, species, energy, acc, tot = real(*a, **kw)
        return pos, species, energy + 1e-3, acc, tot
    return sweep


FAULTS = {
    "unchanged": (ls, "fused_lj_mixed_sweep", _unchanged_lj),
    "half_batch": (lj, "callback_energy_per_particle", half_mean),
    "altered": (ls, "fused_lj_mixed_sweep", _altered_lj),
}
