"""The hand-written CUDA kernels against their plain torch versions, on the
card.  Marked ``cuda``; each test skips when ``torch.cuda.is_available()``
is false.  Run on a machine with an NVIDIA Hopper GPU and nvcc (and, where
the machine has no JAX, without the repository's conftest):

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

Tolerance: the Gaussian sweep atol 1e-5 on x and e and equal accept counts;
the LJ and polydisperse sweeps bit for bit.  Each kernel and its plain
version use the same CUDA math functions and, for the particle rows, the
same summation order.
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
from montecarlo_tpu_torch.ops.poly_sweep import (POLY_KERNEL,
                                                 fused_poly_mixed_sweep)

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


def _poly(m, n, device, seed=0):
    return poly.init_chains(m, n, rho=0.9, beta=2.0, seed=seed,
                            device=device)


def _poly_sweep(st, n_steps, t0=5, **kw):
    return fused_poly_mixed_sweep(st.pos, st.diam, st.beta, st.energy,
                                  float(st.box[0]), 0.1, 0.8, 9, t0, n_steps,
                                  params=poly.PolyParams(), **kw)


@pytest.mark.parametrize("m,n,block_chains", [
    (64, 256, 256), (64, 1024, 256), (300, 128, 256), (20, 128, 8),
    (32, 2, 256)])
def test_poly_kernel_matches_plain(cuda, m, n, block_chains):
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


def _lj_pgmc(device, path, sweeps=40, extra=()):
    from montecarlo_tpu_torch import policy_guided as pg
    pool = (lj.lj_displacement_move(0.1, weight=0.8),
            lj.lj_swap_move(weight=0.2))
    sched = np.arange(10, sweeps + 1, 10)
    return tmc.Simulation(lj.make_system(), _lj(32, 64, device), [
        dict(algorithm=tmc.Metropolis, pool=pool, sweepstep=64, seed=3),
        dict(algorithm=pg.PolicyGradientEstimator,
             dependencies=(tmc.Metropolis,),
             optimisers=(pg.VPG(0.05), pg.Static()), q_batch_size=2,
             scheduler=np.arange(4, sweeps + 1, 4)),
        dict(algorithm=pg.PolicyGradientUpdate,
             dependencies=(pg.PolicyGradientEstimator,),
             scheduler=np.arange(8, sweeps + 1, 8)),
        dict(algorithm=tmc.StoreCallbacks,
             callbacks=(lj.callback_energy_per_particle,
                        tmc.callback_acceptance), scheduler=sched),
        dict(algorithm=tmc.StoreParameters, dependencies=(tmc.Metropolis,),
             scheduler=sched),
        *extra,
    ], sweeps, path=str(path))


def test_hybrid_lj_pgmc_launches_once_per_segment(cuda, tmp_path):
    from montecarlo_tpu_torch.core.simulation import _select_advance
    sim = _lj_pgmc(cuda, tmp_path)
    assert "hybrid" in _select_advance(sim).__qualname__
    sync = {int(t) for s in sim.schedulers[1:] for t in s}
    before = LJ_MIXED_KERNEL.launches
    sim.run()
    assert LJ_MIXED_KERNEL.launches - before == len(sync)
    sigma = sim.device_state["params"][0]["sigma"]
    assert sigma.is_cuda and float(sigma) != np.float32(0.1)
    last = (tmp_path / "parameters" / "1" / "parameters.dat").read_text()
    assert last.splitlines()[-1] == f"40 [{float(sigma)!r}]"
    cnt = sim.device_state["metropolis"]["counters"]
    assert torch.all(cnt[..., 1].sum(1) == 40 * 64)


def test_resume_on_cuda_is_bitwise_exact(cuda, tmp_path):
    from montecarlo_tpu_torch import checkpoint
    from montecarlo_tpu_torch.utils.tree import tree_leaves
    ref = _lj_pgmc(cuda, tmp_path / "ref")
    ref.run()
    a = _lj_pgmc(cuda, tmp_path / "a", extra=(dict(
        algorithm=tmc.StoreBackups, scheduler=np.asarray([20])),))
    a.run()
    b = _lj_pgmc(cuda, tmp_path / "b")
    checkpoint.resume_state(b, str(tmp_path / "a" / "checkpoints" /
                                   "ckpt_t20.npz"))
    gen = b.device_state["pge"]["generator"]
    assert b.t == 20 and gen.device.type == "cuda"
    b.run()
    for x, y in zip(tree_leaves(ref.device_state),
                    tree_leaves(b.device_state)):
        if isinstance(x, torch.Generator):
            assert torch.equal(x.get_state(), y.get_state())
        elif torch.is_tensor(x):
            assert x.is_cuda and torch.equal(x, y)
        else:
            assert x == y
