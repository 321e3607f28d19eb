"""The 2-D LJ energy kernel's dispatch and constants, on the CPU.

``lennard_jones._lj_energies`` launches the CUDA kernel of
``ops/lj_energy.py`` only for 2-D float32 states on the card; every other
state takes the plain chain-batched path (``_energies``), bit for bit as
before, and so does the polydisperse energy; the kernel's launch count
stays put.  The kernel's pair constants are checked
here against ``_pair_energy``: rebuilt from them in torch, each pair term
equals the plain one bit for bit.  The kernel itself runs in
``tests/test_torch_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from montecarlo_tpu_torch.models import lennard_jones as lj
from montecarlo_tpu_torch.models import polydisperse as poly
from montecarlo_tpu_torch.ops import lj_energy
from montecarlo_tpu_torch.ops._cuda import KERNELS
from montecarlo_tpu_torch.ops.lj_energy import (LJ_ENERGY_KERNEL,
                                                lj_total_energy)


def _lj(dim=2, dtype=torch.float32):
    st = lj.init_chains(7, 40, rho=1.2, beta=2.0, frac_b=0.35, seed=3,
                        device="cpu", dim=dim)
    return dataclasses.replace(st, pos=st.pos.to(dtype),
                               box=st.box.to(dtype))


def _chain_batched(total, state, params, row_batch, chains):
    return torch.cat([
        total(type(state)(*(getattr(state, f.name)[s:s + chains]
                            for f in dataclasses.fields(state))),
              params, row_batch)
        for s in range(0, state.pos.shape[0], chains)])


@pytest.mark.parametrize("case", ["lj2d", "lj2d_float64", "lj3d", "poly"])
@pytest.mark.parametrize("row_batch,chains", [(None, 7), (8, 3)])
def test_energies_off_the_card_take_the_plain_path(case, row_batch, chains):
    if case == "poly":
        st = poly.init_chains(7, 40, rho=0.9, beta=2.0, seed=3, device="cpu")
        params, total = poly.PolyParams(), poly.total_energy
        run = lambda b: poly._energies(st, params, row_batch, b)
    else:
        st = _lj(dim=3 if case == "lj3d" else 2,
                 dtype=torch.float64 if case == "lj2d_float64"
                 else torch.float32)
        params, total = lj.LJParams(), lj.total_energy
        run = lambda b: lj._lj_energies(st, params, row_batch, b)
    before = LJ_ENERGY_KERNEL.launches
    per_chain = (row_batch or 40) * 40
    got = run(chains * per_chain)
    want = _chain_batched(total, st, params, row_batch, chains)
    assert got.dtype == st.pos.dtype and torch.equal(got, want)
    assert LJ_ENERGY_KERNEL.launches == before


def test_refresh_and_init_on_the_cpu_launch_nothing():
    before = LJ_ENERGY_KERNEL.launches
    st = _lj()
    stale = dataclasses.replace(st, energy=torch.zeros_like(st.energy))
    fresh = lj.make_system().refresh(stale)
    assert torch.equal(fresh.energy, st.energy)
    assert torch.equal(st.energy, lj.total_energy(st, lj.LJParams()))
    assert LJ_ENERGY_KERNEL.launches == before


def test_kernel_takes_cuda_tensors_only():
    st = _lj()
    p = lj.LJParams()
    with pytest.raises(ValueError, match="no LJ energy kernel"):
        lj_total_energy(st.pos, st.species, st.box, p)
    for bad, err in (((st.pos.double(), st.species, st.box), TypeError),
                     ((st.pos, st.species.long(), st.box), TypeError),
                     ((st.pos, st.species, st.box.double()), TypeError)):
        with pytest.raises(err):
            lj_total_energy(*bad, p)
    assert LJ_ENERGY_KERNEL in KERNELS        # counted into sim.counters


@pytest.mark.parametrize("n,rows", [(1, 32), (2, 32), (20, 32), (32, 32),
                                    (33, 64), (127, 128), (128, 128),
                                    (1024, 128), (32768, 128)])
def test_block_rows_depend_on_n_alone(n, rows):
    assert lj_energy.block_rows(n) == rows


@pytest.mark.parametrize("params", [
    lj.LJParams(),
    lj.LJParams(eps=((1.0, 0.7), (0.7, 2.1)), sig=((1.1, 0.95), (0.95, 0.7)),
                rcut=2.2)])
def test_pair_table_rebuilds_the_plain_pair_terms(params):
    """Each pair term from the kernel's constants, in the kernel's order of
    operations, equals ``_pair_energy``'s bit for bit."""
    tab = lj_energy._pair_table(params)
    rng = np.random.default_rng(11)
    r2 = torch.as_tensor(rng.uniform(0.3, 7.0, 4096), dtype=torch.float32)
    r2[:3] = torch.tensor([0.0, 1e-13, 6.25])
    for k, (a, b) in enumerate(((0, 0), (0, 1), (1, 1))):
        s_i = torch.full_like(r2, a, dtype=torch.int32)
        s_j = torch.full_like(r2, b, dtype=torch.int32)
        eps, sig = params.coeffs(s_i, s_j)
        want = lj._pair_energy(r2, eps, sig, params.rcut)
        f = lambda v: torch.tensor(v, dtype=torch.float32)
        inv = f(tab.s2[k]) / torch.clamp(r2, min=1e-12)
        i6 = inv * inv * inv
        u = f(tab.e4[k]) * (i6 * i6 - i6) - f(tab.sh[k])
        got = torch.where(r2 < f(tab.rc2[k]), u, 0.0)
        assert torch.equal(got, want), (a, b)
