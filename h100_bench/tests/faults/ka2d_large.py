"""The ``ka2d_large`` configuration's timed path broken underneath: the
cell path's segment returning its input state, the energy callback's mean
taken over half of the chains, and the bind permuting the occupants
within each cell, so that every pick lands on another particle."""

import torch

import montecarlo_tpu_torch.ops.cell_mc as cm
from montecarlo_tpu_torch.models import lennard_jones as lj

from bench_helpers import half_mean


def _unchanged_segment(real):
    def segment(grid, pe, rc2, pos, attr, beta, energy, *a, **kw):
        _, _, _, box, att, acc, invalid = real(grid, pe, rc2, pos, attr,
                                               beta, energy, *a, **kw)
        return (pos.clone(), attr.to(torch.float32), energy.clone(), box,
                torch.zeros_like(att), torch.zeros_like(acc), invalid)
    return segment


def _permuted_bind(real):
    def bind(grid, s, attr):
        cells = real(grid, s, attr)
        occ = cells["occ"]
        k = occ.sum(-1, keepdim=True)
        slot = torch.arange(occ.shape[-1], device=occ.device)
        # the occupied slots 0 .. k - 1 of each cell rotated by one
        src = torch.where(slot < k, (slot + 1) % k.clamp(min=1), slot)
        out = {name: torch.gather(cells[name], -1, src)
               for name in ("attr", "occ", "idx")}
        out["crd"] = torch.gather(cells["crd"], -1, src.unsqueeze(1).expand(
            cells["crd"].shape))
        return dict(cells, **out)
    return bind


FAULTS = {
    "unchanged": (cm, "cell_mc_segment", _unchanged_segment),
    "half_batch": (lj, "callback_energy_per_particle", half_mean),
    "altered": (cm, "bind_cells", _permuted_bind),
}
