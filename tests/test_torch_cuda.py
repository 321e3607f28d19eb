"""The hand-written CUDA kernels against their plain torch versions, on the
card.  Marked ``cuda``; each test skips when ``torch.cuda.is_available()``
is false.  Run on a machine with an NVIDIA Hopper GPU and nvcc (and, where
the machine has no JAX, without the repository's conftest):

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

Tolerance: the Gaussian sweep atol 1e-5 on x and e and equal accept counts;
the LJ and polydisperse sweeps and every threefry mode bit for bit; the LJ
energy kernel within 1e-5 relative of the float64 energy (float32 pair
terms, summed in another order), and bit for bit from call to call; the
cell path's substep kernel bit for bit against its twin (the same float32
terms, float64 sums rounded once); the
keyed samplers' card runs against the CPU's within 1e-5, counters equal.
Each kernel and its plain version use the same CUDA math functions and,
for the particle rows, the same summation order.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import montecarlo_tpu_torch as tmc
from montecarlo_tpu_torch.models import lennard_jones as lj
from montecarlo_tpu_torch.models import particle1d as p1d
from montecarlo_tpu_torch.models import polydisperse as poly
from montecarlo_tpu_torch.ops.fused_sweep import (SWEEP_KERNEL,
                                                  fused_gaussian_sweep)
from montecarlo_tpu_torch.ops.lj_sweep import (LJ_KERNEL, LJ_MIXED_KERNEL,
                                               MAX_PARTICLES,
                                               fused_lj_mixed_sweep,
                                               fused_lj_sweep)
from montecarlo_tpu_torch.ops import cell_mc
from montecarlo_tpu_torch.ops.cell_mc import CELL_SUBSTEP_KERNEL
from montecarlo_tpu_torch.ops.lj_energy import (COLUMN_TILE, LJ_ENERGY_KERNEL,
                                                lj_total_energy)
from montecarlo_tpu_torch.ops.poly_sweep import (POLY_KERNEL,
                                                 fused_poly_mixed_sweep,
                                                 poly_block_warps)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _inputs(m, device):
    rng = np.random.default_rng(m)
    x = torch.as_tensor(rng.uniform(-2, 2, m).astype(np.float32),
                        device=device)
    beta = torch.as_tensor(rng.uniform(0.5, 3, m).astype(np.float32),
                           device=device)
    return x, beta


@pytest.mark.parametrize("block_rows", [2048, 8])
@pytest.mark.parametrize("pot", [
    p1d.harmonic, functools.partial(p1d.double_well, a=1.5, h=0.7)])
def test_kernel_matches_plain(cuda, pot, block_rows):
    m = 10 ** 4 + 37
    x, beta = _inputs(m, cuda)
    before = SWEEP_KERNEL.launches
    xk, ek, ak = fused_gaussian_sweep(x, beta, 0.5, 9, 5, 301, potential=pot,
                                      block_rows=block_rows)
    assert SWEEP_KERNEL.launches == before + 1
    xp, ep, ap = fused_gaussian_sweep(x, beta, 0.5, 9, 5, 301, potential=pot,
                                      block_rows=block_rows, interpret=True)
    assert SWEEP_KERNEL.launches == before + 1
    assert xk.is_cuda and ak.dtype == torch.int32
    assert torch.equal(ak, ap)
    torch.testing.assert_close(xk, xp, rtol=0, atol=1e-5)
    torch.testing.assert_close(ek, ep, rtol=0, atol=1e-5)
    torch.testing.assert_close(ek, pot(xk), rtol=0, atol=1e-6)


@pytest.mark.parametrize("m", [10, 1000 + 3, 10 ** 5])
@pytest.mark.parametrize("pot", [p1d.harmonic, p1d.double_well])
def test_every_lane_group_width_gives_the_same_bits(cuda, pot, m):
    """T lanes per chain, T = 1..32, for segments that start mid-pair, are
    shorter than a round, or end mid-round, with M no multiple of 32 / T."""
    from montecarlo_tpu_torch.ops import fused_sweep as fs
    x, beta = _inputs(m, cuda)
    sigma = torch.tensor(0.5, device=cuda)
    bc = fs._block_chains(m, 2048)
    for t0, n in ((5, 1), (4, 2), (5, 7), (4, 64), (5, 301)):
        want = fs._cuda_sweep(x, beta, sigma, 9, t0, n, pot, bc, lanes=1)
        for lanes in (2, 4, 8, 16, 32):
            got = fs._cuda_sweep(x, beta, sigma, 9, t0, n, pot, bc,
                                 lanes=lanes)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), (
                lanes, t0, n)
    with pytest.raises(RuntimeError):
        fs._cuda_sweep(x, beta, sigma, 9, 0, 4, pot, bc, lanes=3)


def test_entry_points_default_to_the_card(cuda, tmp_path):
    chains = p1d.init_chains(64, beta=2.0, seed=1)
    assert chains.x.is_cuda and chains.beta.is_cuda and chains.e.is_cuda
    assert _lj(2, 16, None).pos.is_cuda
    assert _poly(2, 16, None).pos.is_cuda
    sim = tmc.Simulation(p1d.make_system(), chains, [
        dict(algorithm=tmc.Metropolis, pool=(p1d.displacement_move(0.5),),
             seed=3)], 100, path=str(tmp_path))
    assert sim.device.type == "cuda"


def test_kernel_raises_instead_of_falling_back(cuda):
    x, beta = _inputs(1000, cuda)
    with pytest.raises(ValueError):
        fused_gaussian_sweep(x, beta, 0.5, 1, 0, 10, potential=lambda v: v * v)
    with pytest.raises(TypeError):
        fused_gaussian_sweep(x.double(), beta, 0.5, 1, 0, 10,
                             potential=p1d.harmonic)
    with pytest.raises(ValueError):
        fused_gaussian_sweep(x[::2], beta[::2], 0.5, 1, 0, 10,
                             potential=p1d.harmonic)


def test_simulation_runs_through_kernel(cuda, tmp_path):
    chains = p1d.init_chains(4096, beta=2.0, seed=1, device=cuda)
    sched = np.arange(1000, 20001, 1000)
    sim = tmc.Simulation(p1d.make_system(), chains, [
        dict(algorithm=tmc.Metropolis, pool=(p1d.displacement_move(0.5),),
             seed=3),
        dict(algorithm=tmc.StoreCallbacks,
             callbacks=(p1d.callback_energy, tmc.callback_acceptance),
             scheduler=sched),
        dict(algorithm=tmc.StoreTrajectories, fmt=tmc.BIN(), scheduler=sched),
    ], 20000, path=str(tmp_path))
    assert sim.device_algos[0].supports_fused
    before = SWEEP_KERNEL.launches
    sim.run()
    assert SWEEP_KERNEL.launches - before == len(sched)
    assert sim.device_state["sys"].x.is_cuda
    e = np.loadtxt(tmp_path / "energy.dat")
    assert abs(e[len(e) // 2:, 1].mean() - 0.25) < 0.01


def _lj(m, n, device, frac_b=0.2, seed=0):
    return lj.init_chains(m, n, 0.7, 1.0, frac_b=frac_b, seed=seed,
                          device=device)


def _lj_sweep(st, n_steps, mixed, t0=5, **kw):
    args = (st.pos, st.species, st.beta, st.energy, float(st.box[0]), 0.1)
    if mixed:
        return fused_lj_mixed_sweep(*args, 0.8, 9, t0, n_steps,
                                    params=lj.LJParams(), **kw)
    return fused_lj_sweep(*args, 9, t0, n_steps, params=lj.LJParams(), **kw)


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("m,n,block_chains,frac_b", [
    (64, 256, 256, 0.2), (20, 100, 8, 0.2), (300, 64, 256, 0.2),
    (8, 40, 256, 0.0)])
def test_lj_kernel_matches_plain(cuda, mixed, m, n, block_chains, frac_b):
    st = _lj(m, n, cuda, frac_b)
    kernel = LJ_MIXED_KERNEL if mixed else LJ_KERNEL
    before = kernel.launches
    got = _lj_sweep(st, 201, mixed, block_chains=block_chains)
    assert kernel.launches == before + 1
    want = _lj_sweep(st, 201, mixed, block_chains=block_chains,
                     interpret=True)
    assert kernel.launches == before + 1
    assert all(g.is_cuda for g in got)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    energy = got[2] if mixed else got[1]
    full = lj.total_energy(dataclasses.replace(
        st, pos=got[0], species=got[1] if mixed else st.species),
        lj.LJParams())
    torch.testing.assert_close(energy, full, rtol=3e-4, atol=5e-2)


@pytest.mark.parametrize("mixed", [False, True])
def test_lj_kernel_at_the_most_particles_a_block_holds(cuda, mixed):
    """N = MAX_PARTICLES fills the block's shared memory to the byte."""
    st = _lj(2, MAX_PARTICLES, cuda)
    got = _lj_sweep(st, 33, mixed)
    want = _lj_sweep(st, 33, mixed, interpret=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("mixed", [False, True])
def test_lj_kernel_is_segmentation_invariant(cuda, mixed):
    st = _lj(40, 128, cuda)
    one = _lj_sweep(st, 150, mixed)
    cur, t, acc = st, 5, torch.zeros_like(one[-1] if mixed else one[2])
    for k in (70, 1, 0, 79):
        out = _lj_sweep(cur, k, mixed, t0=t)
        if mixed:
            pos, spc, e, a, _ = out
        else:
            (pos, e, a), spc = out, cur.species
        cur = dataclasses.replace(cur, pos=pos, species=spc, energy=e)
        acc, t = acc + a, t + k
    assert torch.equal(cur.pos, one[0]) and torch.equal(acc, one[3 if mixed
                                                              else 2])
    assert torch.equal(cur.energy, one[2 if mixed else 1])


@pytest.mark.parametrize("mixed", [False, True])
def test_lj_kernel_raises_instead_of_falling_back(cuda, mixed):
    st = _lj(16, 32, cuda)
    bad = (dataclasses.replace(st, pos=st.pos.double()),
           dataclasses.replace(st, species=st.species.long()),
           dataclasses.replace(st, pos=st.pos.transpose(0, 1)
                               .contiguous().transpose(0, 1)),
           dataclasses.replace(st, beta=st.beta.cpu()))
    for b, err in zip(bad, (TypeError, TypeError, ValueError, ValueError)):
        with pytest.raises(err):
            _lj_sweep(b, 10, mixed)
    with pytest.raises(ValueError):
        _lj_sweep(st, 10, mixed, t0=2 ** 31 - 5)
    n = MAX_PARTICLES + 1
    big = lj.LJState(pos=torch.zeros((1, n, 2), device=cuda),
                     species=torch.zeros((1, n), dtype=torch.int32,
                                         device=cuda),
                     beta=st.beta[:1], energy=st.energy[:1], box=st.box[:1])
    with pytest.raises(ValueError):
        _lj_sweep(big, 1, mixed)


@pytest.mark.parametrize("mixed", [False, True])
def test_simulation_runs_through_lj_kernels(cuda, mixed, tmp_path):
    pool = ((lj.lj_displacement_move(0.1, weight=0.8),
             lj.lj_swap_move(weight=0.2)) if mixed
            else (lj.lj_displacement_move(0.1),))
    sched = np.arange(2, 21, 2)
    sim = tmc.Simulation(lj.make_system(), _lj(32, 64, cuda), [
        dict(algorithm=tmc.Metropolis, pool=pool, sweepstep=64, seed=3),
        dict(algorithm=tmc.StoreCallbacks,
             callbacks=(lj.callback_energy_per_particle,
                        tmc.callback_acceptance), scheduler=sched),
        dict(algorithm=tmc.StoreLastFrames, scheduler=[20]),
    ], 20, path=str(tmp_path))
    assert sim.device_algos[0].supports_fused
    kernel = LJ_MIXED_KERNEL if mixed else LJ_KERNEL
    before = kernel.launches
    sim.run()
    assert kernel.launches - before == len(sched)
    assert sim.device_state["sys"].pos.is_cuda
    acc = np.loadtxt(tmp_path / "acceptance.dat")
    assert 0.05 < acc[-1, 1] < 0.98
    assert (tmp_path / "trajectories" / "32" / "lastframe.dat").exists()


# -- the 2-D LJ energy kernel (the cache refresh) ------------------------------------

def _lj_dense(m, n, device, seed):
    """Chains of the ka2d cell's mixture at rho 1.2, A65 B35, moved off the
    lattice by one mixed sweep of the particles."""
    st = lj.init_chains(m, n, 1.2, 1 / 0.45, frac_b=0.35, seed=seed,
                        device=device)
    pos, spc, e, _, _ = fused_lj_mixed_sweep(
        st.pos, st.species, st.beta, st.energy, float(st.box[0]), 0.08, 0.8,
        seed, 0, n, params=lj.LJParams())
    return dataclasses.replace(st, pos=pos, species=spc, energy=e)


def _energy64(st):
    wide = dataclasses.replace(st, pos=st.pos.double(), box=st.box.double())
    return lj.total_energy(wide, lj.LJParams(), row_batch=256)


@pytest.mark.parametrize("m,n", [(64, 1024), (1, 2), (3, 20), (2, 1000),
                                 (4, 4648), (2, COLUMN_TILE + 1)])
def test_lj_energy_kernel_matches_float64(cuda, m, n):
    """Within 1e-5 relative per particle of the float64 O(N^2) energy; two
    calls give the same bits, and a chain's energy is the same in any
    batch.  N 4648 and COLUMN_TILE + 1 take two passes over the columns."""
    st = _lj_dense(m, n, cuda, seed=m + n)
    before = LJ_ENERGY_KERNEL.launches
    got = lj._lj_energies(st, lj.LJParams(), None, 2 ** 24)
    assert LJ_ENERGY_KERNEL.launches == before + 1
    assert got.is_cuda and got.dtype == torch.float32 and got.shape == (m,)
    want = _energy64(st)
    gap = torch.abs(got.double() - want) / n
    assert torch.all(gap <= 1e-5 * torch.abs(want) / n), (gap, want / n)
    again = lj_total_energy(st.pos, st.species, st.box, lj.LJParams())
    assert torch.equal(again, got)
    one = lj_total_energy(st.pos[-1:], st.species[-1:], st.box[-1:],
                          lj.LJParams())
    assert torch.equal(one, got[-1:])


def test_lj_energy_kernel_raises_instead_of_falling_back(cuda):
    st = _lj(4, 32, cuda)
    p = lj.LJParams()
    with pytest.raises(TypeError):
        lj._lj_energies(dataclasses.replace(st, species=st.species.long()),
                        p, None, 2 ** 24)
    with pytest.raises(ValueError):
        lj_total_energy(st.pos, st.species, st.box.cpu(), p)


def test_simulation_refreshes_through_the_lj_energy_kernel(cuda, tmp_path):
    """One kernel call a refresh, in ``sim.counters`` and ``summary.log``;
    the refreshed cache within 1e-5 relative of the float64 energy."""
    system = lj.make_system()
    calls = []

    def refresh(state):
        calls.append(state.pos.shape)
        return system.refresh(state)

    pool = (lj.lj_displacement_move(0.1, weight=0.8),
            lj.lj_swap_move(weight=0.2))
    sched = np.arange(2, 21, 2)
    sim = tmc.Simulation(dataclasses.replace(system, refresh=refresh),
                         _lj(32, 64, cuda), [
        dict(algorithm=tmc.Metropolis, pool=pool, sweepstep=64, seed=3),
        dict(algorithm=tmc.StoreCallbacks,
             callbacks=(lj.callback_energy_per_particle,), scheduler=sched),
    ], 20, path=str(tmp_path))
    sim.run()
    assert len(calls) == len(sched)
    assert sim.counters.launches["mc_lj_energy"] == len(calls)
    assert f"mc_lj_energy {len(calls)}" in (
        tmp_path / "summary.log").read_text()
    final = sim.device_state["sys"]
    want = _energy64(final)
    assert torch.all(torch.abs(final.energy.double() - want)
                     <= 1e-5 * torch.abs(want))


# -- the cell path's substep kernel -------------------------------------------

def _cell_case(name, device, m=3, seed=5):
    """``(grid, P, chains, vol)``: LJ chains of the ka2d mixture bound to
    cells on ``device``; the last chain (but at the ``large`` size) holds
    no B, so its swaps have nothing to pick.  ``dense``: 3 x N 2048 at rho
    1.2, cap 32; ``sparse``: rho 0.05, most cells empty; ``cap40``: a
    capacity above a warp's 32 slots; ``overflow``: a capacity of 8 at a
    mean occupancy of ~14, every chain's bind overflowed; ``npt``: the halo
    fixed at d_cap / box_min; ``large``: the ka2d_large cell's 32 x N 32768
    (nc 48, cap 32)."""
    n, rho = {"sparse": (256, 0.05), "large": (32768, 1.2)}.get(
        name, (2048, 1.2))
    m = 32 if name == "large" else m
    st = lj.init_chains(m, n, rho=rho, beta=1.0 / 0.45, frac_b=0.35,
                        seed=seed, device=device)
    species = st.species.clone()
    if name != "large":
        species[-1] = 0
    _, _, rcut = lj.cell_closures(lj.LJParams())
    grid = cell_mc.plan_grid(n, float(st.box[0]), rcut)
    if name in ("cap40", "overflow"):
        grid = cell_mc.CellGrid(grid.nc, 40 if name == "cap40" else 8,
                                grid.box, grid.d_cap, grid.rcut)
    ids = torch.arange(m, device=device)
    s = torch.remainder(st.pos / st.box[:, None, None] + cell_mc.KeyDraws(
        seed, 77, ids).shift(m, 2, device)[:, None, :], 1.0)
    cells = cell_mc.bind_cells(grid, s, species.float())
    assert bool(cells["overflow"].all()) == (name == "overflow")
    vol = (n, 1.0) if name == "npt" else None
    return grid, cell_mc._pack(cells), st, vol


@pytest.mark.parametrize("case", ["dense", "sparse", "cap40", "overflow",
                                  "npt", "ties", "large"])
@pytest.mark.parametrize("kind,color", [(k, c) for k in (0, 1)
                                        for c in range(4)])
def test_cell_substep_kernel_matches_twin(cuda, case, kind, color):
    """One displacement or swap substep of every colour from the same cells
    and draws: the kernel's cells, chain energies, attempts and accepts
    equal the twin's on the card bit for bit, one launch counted (``ties``:
    the pick uniforms rounded to quarters, so most picks are ties)."""
    grid, P, st, vol = _cell_case("dense" if case == "ties" else case, cuda)
    m, h = P.shape[0], grid.nc // 2
    pe, rc2, _ = lj.cell_closures(lj.LJParams())
    sigma = torch.tensor(0.08, device=cuda)
    draws = cell_mc.KeyDraws(11, 5, torch.arange(m, device=cuda)).substep(
        3, kind, m, h, grid.cap, 2, "gaussian", cuda)
    if case == "ties":
        draws = tuple(torch.floor(d * 4) / 4 if k < 1 + kind else d
                      for k, d in enumerate(draws))
    variants, _ = cell_mc._make_substep(grid, pe, rc2,
                                        "species" if kind else None, vol)
    P_twin = P.clone()
    d_e, n_att, n_acc = variants[kind][color](P_twin, st.box, sigma,
                                              st.beta, *draws)
    e = st.energy.clone()
    att = torch.zeros((m, 3), dtype=torch.int32, device=cuda)
    acc = torch.zeros_like(att)
    args = cell_mc._kernel_args(grid, sigma, st.box, st.beta, vol)
    before = CELL_SUBSTEP_KERNEL.launches
    cell_mc._kernel_substeps(grid, P, lj.LJParams(), e, att, acc)(
        kind, color, args, *draws)
    torch.cuda.synchronize()
    assert CELL_SUBSTEP_KERNEL.launches == before + 1
    assert torch.equal(P, P_twin)
    assert torch.equal(e, st.energy + d_e)
    assert torch.equal(att[:, kind], n_att)
    assert torch.equal(acc[:, kind], n_acc)
    assert int(att[:, 1 - kind].abs().sum() + acc[:, 2].abs().sum()) == 0
    if case != "sparse":
        assert int(n_acc.sum()) > 0
    if kind == 1 and case != "large":
        assert int(n_att[-1]) == 0


def test_cell_substep_kernel_raises_instead_of_falling_back(cuda):
    grid, P, st, _ = _cell_case("dense", cuda)
    m, h = P.shape[0], grid.nc // 2
    att = torch.zeros((m, 3), dtype=torch.int32, device=cuda)
    draws = cell_mc.KeyDraws(1, 0, torch.arange(m, device=cuda)).substep(
        0, 0, m, h, grid.cap, 2, "gaussian", cuda)
    args = cell_mc._kernel_args(grid, torch.tensor(0.08, device=cuda),
                                st.box, st.beta, None)
    with pytest.raises(ValueError):
        cell_mc._kernel_substeps(grid, P.double(), lj.LJParams(),
                                 st.energy.clone(), att, att.clone())
    launch = cell_mc._kernel_substeps(grid, P, lj.LJParams(),
                                      st.energy.clone(), att, att.clone())
    before = CELL_SUBSTEP_KERNEL.launches
    with pytest.raises(ValueError):
        launch(0, 0, args, draws[0].cpu(), *draws[1:])
    with pytest.raises(ValueError):
        launch(1, 0, args, *draws)      # a swap's draws are (M, h, h, C)
    assert CELL_SUBSTEP_KERNEL.launches == before


@pytest.mark.parametrize("pool", ["species", "one_move", "npt"])
def test_cell_segments_through_the_kernel_equal_the_twin(cuda, pool):
    """Three ``cell_mc_segment`` calls in a row on 2-D LJ (8 x N 4096), the
    kernel's path against the twin's on the card: every output bit for bit,
    and one kernel launch a displacement or swap substep."""
    st = lj.init_chains(8, 4096, rho=1.2, beta=1.0 / 0.45, frac_b=0.35,
                        seed=7, device=cuda)
    m, n = st.pos.shape[:2]
    pe, rc2, rcut = lj.cell_closures(lj.LJParams())
    vol = (n, 2.0) if pool == "npt" else None
    grid = cell_mc.plan_grid(n, float(st.box[0]), rcut,
                             box_margin=0.15 if vol else 0.0)
    w_disp, w_swap = {"species": (0.8, 0.2), "one_move": (1.0, 0.0),
                      "npt": (0.75, 0.2)}[pool]
    swap_mode = None if pool == "one_move" else "species"
    ids = torch.arange(m, device=cuda)

    def run(kernel_params):
        model = cell_mc.CellModel(pe, rc2, rcut, swap_mode=swap_mode,
                                  kernel_params=kernel_params)
        pos, attr, e, box = st.pos, st.species.float(), st.energy, st.box
        for k in range(3):
            pos, attr, e, box, att, acc, inv = cell_mc.cell_mc_segment(
                grid, model, cell_mc.KeyDraws(9, 1000 * k, ids), pos, attr,
                st.beta, e, 0.08, 40, w_disp=w_disp, w_swap=w_swap, box=box,
                vol=vol, dlnv=0.01)
        return pos, attr, e, box, att, acc, inv

    want = run(None)
    before = CELL_SUBSTEP_KERNEL.launches
    got = run(lj.LJParams())
    torch.cuda.synchronize()
    kinds = np.concatenate([cell_mc.KeyDraws(9, 1000 * k, ids).variants(
        40, 4, w_disp, w_swap, swap_mode is not None, vol is not None)[:, 0]
        for k in range(3)])
    assert CELL_SUBSTEP_KERNEL.launches - before == int(np.sum(kinds < 2))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(want[4][:, 0].min()) > 0
    if pool == "npt":
        assert int(np.sum(kinds == 2)) > 0


@pytest.mark.parametrize("npt", [False, True])
def test_simulation_cell_path_launches_the_substep_kernel(cuda, tmp_path,
                                                          npt):
    """``Metropolis(fused='cell')`` on 2-D LJ: one ``mc_cell_substep`` a
    displacement or swap substep in ``sim.counters``; a volume substep
    (one attempt a chain) launches none."""
    pool = (lj.lj_displacement_move(0.08, weight=0.75),
            lj.lj_swap_move(weight=0.2))
    if npt:
        pool += (lj.lj_volume_move(0.002, 2.0, weight=0.05),)
    sim = tmc.Simulation(lj.make_system(), lj.init_chains(
        4, 1024, rho=1.0, beta=1.0 / 0.45, frac_b=0.35, seed=6,
        device=cuda), [
        dict(algorithm=tmc.Metropolis, pool=pool, seed=3, sweepstep=256,
             fused="cell")], 8, path=str(tmp_path))
    sim.run()
    assert sim.device_algos[0]._use_cell
    vol_substeps = 0
    if npt:
        counters = sim.device_state["metropolis"]["counters"]
        vol_substeps = int(counters[0, 2, 1])
        assert vol_substeps > 0
    assert sim.counters.launches["mc_cell_substep"] == \
        sim.counters.cell_substeps - vol_substeps


def _poly(m, n, device, seed=0):
    return poly.init_chains(m, n, rho=0.9, beta=2.0, seed=seed,
                            device=device)


def _poly_sweep(st, n_steps, t0=5, **kw):
    return fused_poly_mixed_sweep(st.pos, st.diam, st.beta, st.energy,
                                  float(st.box[0]), 0.1, 0.8, 9, t0, n_steps,
                                  params=poly.PolyParams(), **kw)


@pytest.mark.parametrize("m,n,block_chains", [
    (64, 256, 256), (64, 1024, 256), (300, 128, 256), (20, 128, 8),
    (32, 2, 256), (16, 64, 256), (20, 100, 8), (4, 4648, 256)])
def test_poly_kernel_matches_plain(cuda, m, n, block_chains):
    """One warp (N 2) to sixteen (N 4648, N no multiple of 512)."""
    st = _poly(m, n, cuda)
    before = POLY_KERNEL.launches
    got = _poly_sweep(st, 201, block_chains=block_chains)
    assert POLY_KERNEL.launches == before + 1
    want = _poly_sweep(st, 201, block_chains=block_chains, interpret=True)
    assert POLY_KERNEL.launches == before + 1
    assert all(g.is_cuda for g in got)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    pos, dia, energy, acc, tot = got
    full = poly.total_energy(dataclasses.replace(st, pos=pos, diam=dia))
    torch.testing.assert_close(energy, full, rtol=3e-3, atol=8e-2)
    assert torch.equal(dia.sort(1).values, st.diam.sort(1).values)
    assert int(acc[:, 1].sum()) > 0 and torch.all(tot.sum(1) == 201)


def test_poly_kernel_at_the_most_particles_a_block_holds(cuda):
    """N = MAX_PARTICLES fills the block's shared memory to the byte."""
    assert poly_block_warps(MAX_PARTICLES) == 16
    st = _poly(2, MAX_PARTICLES, cuda)
    got = _poly_sweep(st, 33)
    want = _poly_sweep(st, 33, interpret=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_poly_kernel_is_segmentation_invariant(cuda):
    st = _poly(40, 128, cuda)
    one = _poly_sweep(st, 150)
    cur, t = st, 5
    acc, tot = torch.zeros_like(one[3]), torch.zeros_like(one[4])
    for k in (70, 1, 0, 79):
        pos, dia, e, a, n = _poly_sweep(cur, k, t0=t)
        cur = dataclasses.replace(cur, pos=pos, diam=dia, energy=e)
        acc, tot, t = acc + a, tot + n, t + k
    for got, want in zip((cur.pos, cur.diam, cur.energy, acc, tot), one):
        assert torch.equal(got, want)


def test_poly_kernel_raises_instead_of_falling_back(cuda):
    st = _poly(16, 32, cuda)
    bad = (dataclasses.replace(st, pos=st.pos.double()),
           dataclasses.replace(st, diam=st.diam.double()),
           dataclasses.replace(st, pos=st.pos.transpose(0, 1)
                               .contiguous().transpose(0, 1)),
           dataclasses.replace(st, beta=st.beta.cpu()))
    for b, err in zip(bad, (TypeError, TypeError, ValueError, ValueError)):
        with pytest.raises(err):
            _poly_sweep(b, 10)
    with pytest.raises(ValueError):
        _poly_sweep(st, 10, t0=2 ** 31 - 5)
    one = dataclasses.replace(st, pos=st.pos[:, :1].contiguous(),
                              diam=st.diam[:, :1].contiguous())
    with pytest.raises(ValueError, match="N >= 2"):
        _poly_sweep(one, 1)
    n = MAX_PARTICLES + 1
    big = poly.PolyState(pos=torch.zeros((1, n, 2), device=cuda),
                         diam=torch.ones((1, n), device=cuda),
                         beta=st.beta[:1], energy=st.energy[:1],
                         box=st.box[:1])
    with pytest.raises(ValueError):
        _poly_sweep(big, 1)


def test_simulation_runs_through_poly_kernel(cuda, tmp_path):
    pool = (poly.displacement_move(0.1, weight=0.8),
            poly.swap_move(weight=0.2))
    sched = np.arange(2, 21, 2)
    chains = _poly(32, 64, cuda)
    sim = tmc.Simulation(poly.make_system(), chains, [
        dict(algorithm=tmc.Metropolis, pool=pool, sweepstep=64, seed=3),
        dict(algorithm=tmc.StoreCallbacks,
             callbacks=(poly.callback_energy_per_particle,
                        tmc.callback_acceptance), scheduler=sched),
        dict(algorithm=tmc.StoreLastFrames, scheduler=[20]),
    ], 20, path=str(tmp_path))
    assert sim.device_algos[0].supports_fused
    before = POLY_KERNEL.launches
    sim.run()
    assert POLY_KERNEL.launches - before == len(sched)
    final = sim.device_state["sys"]
    assert final.pos.is_cuda
    assert torch.equal(final.diam.sort(1).values, chains.diam.sort(1).values)
    acc = np.loadtxt(tmp_path / "acceptance.dat")
    assert 0.05 < acc[-1, 1] < 0.98
    assert (tmp_path / "trajectories" / "32" / "lastframe.dat").exists()


# -- PGMC, the hybrid stepper and resume on the card -----------------------------

def _to(tree, device):
    from montecarlo_tpu_torch.utils.tree import tree_map
    return tree_map(lambda x: x.to(device), tree)


@pytest.mark.parametrize("name", ["gaussian", "mala", "lj"])
def test_per_chain_gradients_on_cuda_equal_cpu(cuda, name):
    """pgmc_estimate (per-chain logq gradients, j, grad_j, g) on the card
    against the CPU on the same inputs, to float32 ulps of the math
    functions (rtol 1e-5)."""
    from montecarlo_tpu_torch import policy_guided as pg
    from montecarlo_tpu_torch.utils.tree import ravel
    rng = np.random.default_rng(21)
    m = 256
    if name == "lj":
        st = lj.init_chains(m, 64, 0.7, 1.0, frac_b=0.2, seed=3, device="cpu")
        action = {"i": torch.as_tensor(rng.integers(0, 64, m)),
                  "delta": torch.as_tensor(0.1 * rng.normal(size=(m, 2)),
                                           dtype=torch.float32)}
        mv = lj.lj_displacement_move(0.1)
    else:
        x = torch.as_tensor(rng.uniform(-1.5, 1.5, m), dtype=torch.float32)
        st = p1d.Particle1DState(x=x, beta=torch.full((m,), 2.0), e=x * x)
        action = torch.as_tensor(0.5 * rng.normal(size=m),
                                 dtype=torch.float32)
        mv = (p1d.mala_move(0.2) if name == "mala"
              else p1d.displacement_move(0.5))
    flat, unravel = ravel(mv.params)
    want = pg.pgmc_estimate(mv.move, flat, unravel, st, action)
    flat_c, unravel_c = ravel(_to(mv.params, cuda))
    got = pg.pgmc_estimate(mv.move, flat_c, unravel_c, _to(st, cuda),
                           _to(action, cuda))
    assert got.grad_j.is_cuda and got.g.shape == (m, 1, 1)
    for f in ("j", "grad_j", "grad_logq_forward", "g"):
        torch.testing.assert_close(getattr(got, f).cpu(), getattr(want, f),
                                   rtol=1e-5, atol=1e-6)
    assert torch.equal(got.n.cpu(), want.n)


def _particle_pgmc(device, path, sweeps=40, extra=(), model=lj):
    from montecarlo_tpu_torch import policy_guided as pg
    if model is lj:
        pool = (lj.lj_displacement_move(0.1, weight=0.8),
                lj.lj_swap_move(weight=0.2))
        chains = _lj(32, 64, device)
    else:
        pool = (poly.displacement_move(0.1, weight=0.8),
                poly.swap_move(weight=0.2))
        chains = _poly(32, 64, device)
    sched = np.arange(10, sweeps + 1, 10)
    return tmc.Simulation(model.make_system(), chains, [
        dict(algorithm=tmc.Metropolis, pool=pool, sweepstep=64, seed=3),
        dict(algorithm=pg.PolicyGradientEstimator,
             dependencies=(tmc.Metropolis,),
             optimisers=(pg.VPG(0.05), pg.Static()), q_batch_size=2,
             scheduler=np.arange(4, sweeps + 1, 4)),
        dict(algorithm=pg.PolicyGradientUpdate,
             dependencies=(pg.PolicyGradientEstimator,),
             scheduler=np.arange(8, sweeps + 1, 8)),
        dict(algorithm=tmc.StoreCallbacks,
             callbacks=(model.callback_energy_per_particle,
                        tmc.callback_acceptance), scheduler=sched),
        dict(algorithm=tmc.StoreParameters, dependencies=(tmc.Metropolis,),
             scheduler=sched),
        *extra,
    ], sweeps, path=str(path))


def _hybrid_pgmc_launches_once_per_segment(cuda, tmp_path, model, kernel):
    from montecarlo_tpu_torch.core.simulation import _select_advance
    sim = _particle_pgmc(cuda, tmp_path, model=model)
    assert "hybrid" in _select_advance(sim).__qualname__
    sync = {int(t) for s in sim.schedulers[1:] for t in s}
    before = kernel.launches
    sim.run()
    assert kernel.launches - before == len(sync)
    sigma = sim.device_state["params"][0]["sigma"]
    assert sigma.is_cuda and float(sigma) != np.float32(0.1)
    last = (tmp_path / "parameters" / "1" / "parameters.dat").read_text()
    assert last.splitlines()[-1] == f"40 [{float(sigma)!r}]"
    cnt = sim.device_state["metropolis"]["counters"]
    assert torch.all(cnt[..., 1].sum(1) == 40 * 64)
    return sim


def test_hybrid_lj_pgmc_launches_once_per_segment(cuda, tmp_path):
    _hybrid_pgmc_launches_once_per_segment(cuda, tmp_path, lj,
                                           LJ_MIXED_KERNEL)


def test_hybrid_poly_pgmc_launches_once_per_segment(cuda, tmp_path):
    """The poly pool (N 64: a block of two warps) under PGMC."""
    sim = _hybrid_pgmc_launches_once_per_segment(cuda, tmp_path, poly,
                                                 POLY_KERNEL)
    final = sim.device_state["sys"]
    full = poly.total_energy(final)
    torch.testing.assert_close(final.energy, full, rtol=3e-3, atol=8e-2)


def test_resume_on_cuda_is_bitwise_exact(cuda, tmp_path):
    from montecarlo_tpu_torch import checkpoint
    from montecarlo_tpu_torch.utils.tree import tree_leaves
    ref = _particle_pgmc(cuda, tmp_path / "ref")
    ref.run()
    a = _particle_pgmc(cuda, tmp_path / "a", extra=(dict(
        algorithm=tmc.StoreBackups, scheduler=np.asarray([20])),))
    a.run()
    b = _particle_pgmc(cuda, tmp_path / "b")
    checkpoint.resume_state(b, str(tmp_path / "a" / "checkpoints" /
                                   "ckpt_t20.npz"))
    keys = b.device_state["pge"]["keys"]
    assert b.t == 20 and keys.is_cuda and keys.dtype == torch.uint32
    b.run()
    for x, y in zip(tree_leaves(ref.device_state),
                    tree_leaves(b.device_state)):
        if torch.is_tensor(x):
            assert x.is_cuda and torch.equal(x, y)
        else:
            assert x == y


# -- the chain mesh: the sharded entry points on the card ----------------------------

def _sharded_call(name, mesh, device, seed=9):
    """One sharded entry point's call on ``mesh`` and its kernel."""
    from montecarlo_tpu_torch.ops import fused_sweep as fs
    from montecarlo_tpu_torch.ops import lj_sweep as ls
    from montecarlo_tpu_torch.ops import poly_sweep as ps
    if name == "gaussian":
        x, beta = _inputs(4096, device)
        return SWEEP_KERNEL, lambda mesh, s: (
            fs.sharded_gaussian_sweep(mesh, "chains", x, beta, 0.5, s, 7,
                                      101, potential=p1d.harmonic)
            if mesh is not None else fs.fused_gaussian_sweep(
                x, beta, 0.5, s, 7, 101, potential=p1d.harmonic))
    if name == "poly":
        st = _poly(8, 256, device)
        args = (st.pos, st.diam, st.beta, st.energy, float(st.box[0]), 0.1,
                0.8)
        kw = dict(params=poly.PolyParams())
        return POLY_KERNEL, lambda mesh, s: (
            ps.sharded_poly_mixed_sweep(mesh, "chains", *args, s, 5, 300,
                                        **kw)
            if mesh is not None else fused_poly_mixed_sweep(*args, s, 5, 300,
                                                            **kw))
    mixed = name == "lj_mixed"
    st = _lj(8, 256, device)
    args = (st.pos, st.species, st.beta, st.energy, float(st.box[0]), 0.1) \
        + ((0.8,) if mixed else ())
    kw = dict(params=lj.LJParams())
    sharded = ls.sharded_lj_mixed_sweep if mixed else ls.sharded_lj_sweep
    plain = fused_lj_mixed_sweep if mixed else fused_lj_sweep
    return (LJ_MIXED_KERNEL if mixed else LJ_KERNEL), lambda mesh, s: (
        sharded(mesh, "chains", *args, s, 5, 300, **kw)
        if mesh is not None else plain(*args, s, 5, 300, **kw))


@pytest.mark.parametrize("name", ["gaussian", "lj", "lj_mixed", "poly"])
def test_sharded_entry_points_launch_their_kernels(cuda, name):
    """On a CUDA tensor each sharded entry point launches its kernel once,
    with the rank folded into the seed: rank r's call equals the unsharded
    kernel's with ``_shard_seed(r, seed)``, and the ranks differ."""
    from montecarlo_tpu_torch.ops.fused_sweep import _shard_seed
    from montecarlo_tpu_torch.parallel import Mesh
    kernel, call = _sharded_call(name, None, cuda)
    outs = []
    for r in range(2):
        mesh = Mesh(rank=r, size=2, device=cuda)
        before = kernel.launches
        out = call(mesh, 9)
        assert kernel.launches == before + 1
        want = call(None, _shard_seed(r, 9))
        assert all(torch.equal(a, b) for a, b in zip(out, want))
        outs.append(out[0])
    assert outs[0].is_cuda and not torch.equal(outs[0], outs[1])


def test_emulated_two_rank_run_on_the_card(cuda, tmp_path):
    """Two ranks emulated in one process run config 2's recorders on the
    card: each rank launches the kernel, its chains equal the sharded
    kernel's one segment from its slice, and rank 0 writes the files."""
    from montecarlo_tpu_torch.ops import fused_sweep as fs
    from montecarlo_tpu_torch.parallel import run_emulated
    chains = p1d.init_chains(2048, beta=2.0, seed=5, device=cuda)
    steps = 400

    def run(mesh):
        sim = tmc.Simulation(p1d.make_system(), chains, [
            dict(algorithm=tmc.Metropolis, pool=(p1d.displacement_move(0.5),),
                 seed=3),
            dict(algorithm=tmc.StoreCallbacks,
                 callbacks=(p1d.callback_energy, tmc.callback_acceptance),
                 scheduler=np.arange(100, steps + 1, 100))],
            steps, path=str(tmp_path), mesh=mesh)
        sim.run()
        lo = mesh.rank * 1024
        x, _, _ = fs.sharded_gaussian_sweep(
            mesh, "chains", chains.x[lo:lo + 1024].contiguous(),
            chains.beta[lo:lo + 1024].contiguous(), 0.5, 3, 0, steps,
            potential=p1d.harmonic)
        return sim.device_state["sys"].x, x

    before = SWEEP_KERNEL.launches
    for got, want in run_emulated(run, 2, cuda):
        assert got.is_cuda and torch.equal(got, want)
    assert SWEEP_KERNEL.launches - before == 2 * (4 + 1)
    e = np.loadtxt(tmp_path / "energy.dat")
    assert e.shape == (5, 2)


# -- the threefry kernel (utils/prng.py's draws) ------------------------------

@pytest.mark.parametrize("mode, kw", [
    ("words", {}), ("bits", {}), ("uniform", dict(lo=-2.0, hi=3.0)),
    ("uniform", {}), ("normal", {}), ("randint", dict(ilo=-3, ihi=1000))])
@pytest.mark.parametrize("b, n", [(1, 1), (10 ** 4 + 7, 1), (37, 1001)])
def test_threefry_kernel_matches_plain(cuda, mode, kw, b, n):
    """Every mode bit for bit against the plain twin on the card, with the
    keys' rows strided (a split's keys, unbound) and contiguous."""
    from montecarlo_tpu_torch.ops.threefry import THREEFRY_KERNEL, threefry
    from montecarlo_tpu_torch.utils import prng
    keys = prng.split(prng.key(7, cuda), (b, 3))[:, 1]
    assert keys.stride(0) == 6
    for k in (keys, keys.contiguous()):
        before = THREEFRY_KERNEL.launches
        got = threefry(k, n, mode, **kw)
        assert THREEFRY_KERNEL.launches == before + 1
        want = threefry(k, n, mode, interpret=True, **kw)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("b, n", [(1, 1), (64, 64), (512, 64), (37, 1001)])
def test_threefry_split_uniform_matches_plain(cuda, b, n):
    """The split_uniform mode (the soft-potential event loop's step):
    successor keys and values bit for bit against the plain twin, one
    launch counted under its mode."""
    from montecarlo_tpu_torch.ops.threefry import (LAUNCHES_BY_MODE,
                                                   THREEFRY_KERNEL, threefry)
    from montecarlo_tpu_torch.utils import prng
    keys = prng.split(prng.key(11, cuda), (b, 3))[:, 2]
    before = (THREEFRY_KERNEL.launches, LAUNCHES_BY_MODE["split_uniform"])
    nk, u = threefry(keys, n, "split_uniform", lo=1.1754943508222875e-38)
    assert (THREEFRY_KERNEL.launches, LAUNCHES_BY_MODE["split_uniform"]) \
        == (before[0] + 1, before[1] + 1)
    pk, pu = threefry(keys, n, "split_uniform", lo=1.1754943508222875e-38,
                      interpret=True)
    torch.cuda.synchronize()
    assert torch.equal(nk, pk) and torch.equal(u, pu)


@pytest.mark.parametrize("name", ["checkerboard", "wolff", "wang_landau",
                                  "ecmc_lj", "tempering", "cell"])
def test_keyed_samplers_on_the_card_equal_the_cpu(cuda, tmp_path, name):
    """One seed's run of a keyed sampler on the card and on the CPU:
    counters and discrete states equal, the rest within 1e-5."""
    from montecarlo_tpu_torch.models import ising2d
    from montecarlo_tpu_torch.utils.tree import tree_leaves_with_path

    def build(dev):
        if name in ("checkerboard", "wolff", "wang_landau"):
            chains = ising2d.init_chains(8, 6, 0.44, seed=3, device=dev)
            algo = {"checkerboard": dict(
                        algorithm=ising2d.CheckerboardMetropolis, sweeps=2),
                    "wolff": dict(algorithm=ising2d.WolffCluster,
                                  clusters=2),
                    "wang_landau": dict(algorithm=tmc.WangLandau,
                                        model=ising2d.wl_model(6),
                                        moves_per_step=36)}[name]
            return ising2d.make_system(), chains, [dict(algo, seed=5)]
        if name == "ecmc_lj":
            return lj.make_system(), lj.init_chains(
                3, 20, 0.7, 1.0, frac_b=0.2, seed=5, device=dev), [
                dict(algorithm=tmc.EventChain, model=lj.ecmc_model(1.5),
                     events_per_step=2, seed=11)]
        if name == "tempering":
            return p1d.make_system(), p1d.init_chains(
                16, beta=tmc.tile_ladder([0.5, 1.0, 2.0, 4.0], 4,
                                         device=dev), seed=3, device=dev), [
                dict(algorithm=tmc.Metropolis,
                     pool=(p1d.displacement_move(0.8),), seed=2,
                     fused="off"),
                dict(algorithm=tmc.ReplicaExchange, n_temps=4, seed=5)]
        return lj.make_system(), lj.init_chains(
            4, 256, rho=1.0, beta=1.0, frac_b=0.2, seed=6, device=dev), [
            dict(algorithm=tmc.Metropolis,
                 pool=(lj.lj_displacement_move(0.1, weight=0.8),
                       lj.lj_swap_move(weight=0.2)),
                 seed=3, sweepstep=64, fused="cell")]

    states = []
    for dev in (cuda, torch.device("cpu")):
        sim = tmc.Simulation(*build(dev), 4, path=str(tmp_path / dev.type))
        sim.run()
        states.append([(p, x.cpu()) for p, x in
                       tree_leaves_with_path(sim.device_state)
                       if torch.is_tensor(x)])
    for (path, a), (_, b) in zip(*states):
        if a.is_floating_point():
            assert float((a.double() - b.double()).abs().max()) <= \
                1e-5 + 1e-5 * float(b.double().abs().max()), path
        else:
            assert torch.equal(a, b), path


def test_threefry_folds_and_per_key_bounds_match_plain(cuda):
    from montecarlo_tpu_torch.ops.threefry import threefry
    from montecarlo_tpu_torch.utils import prng
    keys = prng.split(prng.key(3, cuda), 5000)
    data = torch.arange(5000, device=cuda) * 7919
    hi = torch.arange(5000, device=cuda, dtype=torch.int32) % 300 + 1
    for kw in (dict(data=12345), dict(data=data)):
        assert torch.equal(threefry(keys, 1, "words", **kw),
                           threefry(keys, 1, "words", interpret=True, **kw))
    assert torch.equal(threefry(keys, 4, "randint", ilo=0, ihi=hi),
                       threefry(keys, 4, "randint", ilo=0, ihi=hi,
                                interpret=True))


def test_generic_path_on_the_card_equals_the_cpu(cuda, tmp_path):
    """One seed's generic run (a two-move pool: the categorical pick too)
    on the card and on the CPU: initial chains and counters equal, states
    within 1e-5."""
    pool = lambda: (p1d.displacement_move(0.4), p1d.mala_move(0.1))
    runs = []
    for dev in (cuda, torch.device("cpu")):
        chains = p1d.init_chains(500, beta=2.0, seed=11, device=dev)
        sim = tmc.Simulation(p1d.make_system(), chains, [
            dict(algorithm=tmc.Metropolis, pool=pool(), seed=5,
                 fused="off")], 100, path=str(tmp_path / dev.type))
        sim.run()
        runs.append((chains.x.cpu(), sim.device_state))
    (x0a, a), (x0b, b) = runs
    assert torch.equal(x0a, x0b)
    assert torch.equal(a["metropolis"]["counters"].cpu(),
                       b["metropolis"]["counters"])
    assert float((a["sys"].x.cpu() - b["sys"].x).abs().max()) <= 1e-5
