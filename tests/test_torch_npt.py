"""The NPT ensemble on the generic path: the port's volume moves and NPT
observables against the JAX package's, in 2-D and 3-D.

Held to the reference on the same chains (carried over by ``interop``) and
the same ln-V steps: each volume move's ``apply`` (new positions, box and
energy within rtol 1e-5, ``dlogp`` within rtol 1e-5 or atol 1e-3 where it
is a difference of large terms; hard disks and spheres: -inf exactly where
the rescale overlaps), the virial pressure and the pressure and density
callbacks (rtol 1e-5).  Then the reference's NPT gates
(``tests/test_npt.py``, ``test_npt_eos.py``) by statistics on the port's
stream: the ideal-gas identity <V> = (N + 1) / (beta P) in 2-D and 3-D
(exact, the reference's 6 % band), the hard-disk dilute limit, the LJ and
poly bookkeeping under many rescales, and the NVT/NPT equation-of-state
loop, reduced (see :func:`test_npt_density_matches_nvt_pressure`).
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlo_tpu as mc
import montecarlo_tpu_torch as tmc
from montecarlo_tpu.models import hard_disks as ref_hd
from montecarlo_tpu.models import lennard_jones as ref_lj
from montecarlo_tpu.models import polydisperse as ref_poly
from montecarlo_tpu_torch import interop
from montecarlo_tpu_torch.models import hard_disks as hd
from montecarlo_tpu_torch.models import lennard_jones as lj
from montecarlo_tpu_torch.models import polydisperse as poly

IDEAL = lj.LJParams(eps=((0.0, 0.0), (0.0, 0.0)))
REF_IDEAL = ref_lj.LJParams(eps=((0.0, 0.0), (0.0, 0.0)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test runner runs several files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _chains(family, dim, m=4, n=64):
    """(reference chains, port chains) of one family, carried over."""
    if family == "lj":
        ref = ref_lj.init_chains(m, n, rho=0.7, beta=1.2, frac_b=0.25,
                                 seed=5, dim=dim)
    elif family == "poly":
        ref = ref_poly.init_chains(m, n, rho=0.9, beta=1.5, seed=6, dim=dim)
    else:
        ref = ref_hd.init_chains(m, n, eta=0.5 if dim == 2 else 0.3, seed=7,
                                 dim=dim)
    return ref, interop.chains_from_reference(ref, device="cpu")


def _moves(family, pressure):
    if family == "lj":
        return (ref_lj.lj_volume_move(0.1, pressure),
                lj.lj_volume_move(0.1, pressure))
    if family == "poly":
        return (ref_poly.volume_move(0.1, pressure),
                poly.volume_move(0.1, pressure))
    return ref_hd.volume_move(0.1, pressure), hd.volume_move(0.1, pressure)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("family", ["lj", "poly", "hd"])
def test_volume_move_apply_matches_reference(family, dim):
    """One ln-V step per chain, from the same state: expansions, small
    compressions and (hard cores) one compression that makes an overlap."""
    ref, st = _chains(family, dim)
    ref_move, move = _moves(family, 2.0)
    delta = np.array([0.04, -0.02, 0.003, -0.3], np.float32)
    want_st, want_dlogp = jax.vmap(ref_move.move.apply)(ref,
                                                        jnp.asarray(delta))
    got_st, got_dlogp = move.move.apply(st, torch.as_tensor(delta))
    for f in dataclasses.fields(got_st):
        np.testing.assert_allclose(getattr(got_st, f.name).numpy(),
                                   np.asarray(getattr(want_st, f.name)),
                                   rtol=1e-5, atol=1e-6, err_msg=f.name)
    want_dlogp = np.asarray(want_dlogp)
    got_dlogp = got_dlogp.numpy()
    np.testing.assert_array_equal(np.isinf(got_dlogp), np.isinf(want_dlogp))
    finite = np.isfinite(want_dlogp)
    np.testing.assert_allclose(got_dlogp[finite], want_dlogp[finite],
                               rtol=1e-5, atol=1e-3)
    if family == "hd":
        # the last chain's compression overlaps; the expansions never do
        assert np.isneginf(got_dlogp[3]) and finite[:3].all()
    # the proposal is symmetric in ln V: the inverse step undoes it, and the
    # density of a step is 1 / (2 dlnv) per chain
    d = torch.as_tensor(delta)
    assert torch.equal(move.move.invert(d, got_st), -d)
    np.testing.assert_allclose(
        move.move.policy.log_density(
            {"dlnv": torch.tensor(0.1)}, torch.as_tensor(delta), st).numpy(),
        np.full(4, -np.log(0.2), np.float32), rtol=1e-6)


@pytest.mark.parametrize("dim,row_batch", [(2, None), (2, 16), (3, None)])
def test_virial_pressure_matches_reference(dim, row_batch):
    ref, st = _chains("lj", dim)
    want = np.asarray(jax.vmap(lambda s: ref_lj.virial_pressure(
        s, ref_lj.LJParams(), row_batch=row_batch))(ref))
    got = lj.virial_pressure(st, lj.LJParams(), row_batch=row_batch)
    assert got.shape == (4,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("dim", [2, 3])
def test_callbacks_match_reference(dim):
    """The pressure callback (LJ) and the density callbacks (LJ, poly) on
    chains whose boxes differ."""
    for family, ref_mod, mod in (("lj", ref_lj, lj), ("poly", ref_poly,
                                                      poly)):
        ref, st = _chains(family, dim)
        scale = np.array([1.0, 1.05, 0.97, 1.2], np.float32)
        ref = dataclasses.replace(ref, box=ref.box * scale,
                                  pos=ref.pos * scale[:, None, None])
        st = interop.chains_from_reference(ref, device="cpu")
        view = tmc.SimView(sys=st, params=(), t=0, state={})
        ref_view = mc.SimView(sys=ref, params=(), t=0, state={})
        assert float(mod.callback_density(view)) == pytest.approx(
            float(ref_mod.callback_density(ref_view)), rel=1e-6)
        if family == "lj":
            assert float(lj.callback_pressure(view)) == pytest.approx(
                float(ref_lj.callback_pressure(ref_view)), rel=1e-5)


def _run(system, chains, pool, steps, path, sweepstep=1, seed=7,
         recorders=(), fused="auto"):
    sim = tmc.Simulation(system, chains, [
        dict(algorithm=tmc.Metropolis, pool=pool, seed=seed,
             sweepstep=sweepstep, fused=fused)] + list(recorders), steps,
        path=str(path))
    sim.run()
    return sim


@pytest.mark.parametrize("dim", [2, 3])
def test_ideal_gas_mean_volume(tmp_path, dim):
    """<V> = (N + 1) / (beta P) exactly in any dimension (the reference's
    ``test_ideal_gas_mean_volume`` and ``test_3d_ideal_gas_npt_exact``,
    2,000 steps where they take 4,000: the chains start at V = 32, within a
    standard deviation of the mean 34)."""
    n, beta, pressure, steps = 16, 1.0, 0.5, 2000
    chains = lj.init_chains(128, n, rho=0.5, beta=beta, seed=3,
                            params=IDEAL, device="cpu", dim=dim)
    pool = (lj.lj_volume_move(dlnv=0.3, pressure=pressure, params=IDEAL),)
    sim = _run(lj.make_system(IDEAL), chains, pool, steps, tmp_path,
               recorders=[dict(algorithm=tmc.StoreCallbacks,
                               callbacks=(lj.callback_density,),
                               scheduler=tmc.build_schedule(steps, 500,
                                                            10))])
    v = sim.device_state["sys"].box.double().numpy() ** dim
    # sd(V) = sqrt(N + 1) / (beta P) ~ 8.2: se(mean) over 128 chains ~ 2 %
    np.testing.assert_allclose(v.mean(), (n + 1) / (beta * pressure),
                               rtol=0.06)
    d = np.loadtxt(os.path.join(sim.path, "density.dat"))
    assert d[d[:, 0] >= 500, 1].std() > 0      # the density fluctuates


def test_hard_disk_npt_dilute_ideal_gas_limit(tmp_path):
    """Hard-core NPT on the generic path: at near-zero packing the hard
    core is irrelevant and <V> = (N + 1) / (beta P) (the reference's test,
    300 steps where it takes 1,200: ~150 volume attempts a chain, where the
    box reaches its mean in ~50)."""
    n, m, steps, beta_p = 64, 64, 300, 0.005
    chains = hd.init_chains(m, n, eta=0.05, seed=3, device="cpu")
    pool = (hd.displacement_move(0.8, weight=0.5),
            hd.volume_move(dlnv=0.25, beta_pressure=beta_p, weight=0.5))
    sim = _run(hd.make_system(), chains, pool, steps, tmp_path, sweepstep=2)
    st = sim.device_state["sys"]
    v = st.box.double().numpy() ** 2
    want = (n + 1) / beta_p
    se = float(v.std(ddof=1) / np.sqrt(len(v)))
    assert abs(float(v.mean()) - want) < 4 * se + 0.05 * want, (
        v.mean(), want, se)
    assert bool(hd.overlap_free(st).all())


@pytest.mark.parametrize("family", ["lj", "poly"])
def test_npt_geometry_bookkeeping(tmp_path, family):
    """The cache equals a recompute after many rescales and displacements
    (and swaps), the box responds to the pressure, positions stay in the
    box, every move is accepted at a sane rate (the reference's
    ``test_lj_npt_geometry_bookkeeping`` and
    ``test_poly_npt_swap_protocol``)."""
    if family == "lj":
        p, mod = lj.LJParams(), lj
        chains = lj.init_chains(16, 32, rho=0.7, beta=1.0, frac_b=0.25,
                                seed=5, params=p, device="cpu")
        pool = (lj.lj_displacement_move(0.1, weight=0.9, params=p),
                lj.lj_volume_move(dlnv=0.05, pressure=2.0, weight=0.1,
                                  params=p))
    else:
        p, mod = poly.PolyParams(), poly
        chains = poly.init_chains(16, 32, rho=1.0, beta=1.0, seed=13,
                                  params=p, device="cpu")
        pool = (poly.displacement_move(0.12, weight=0.7, params=p),
                poly.swap_move(weight=0.2, params=p),
                poly.volume_move(dlnv=0.04, pressure=4.0, weight=0.1,
                                 params=p))
    sim = _run(mod.make_system(p), chains, pool, 400, tmp_path, seed=11,
               recorders=[dict(algorithm=tmc.StoreCallbacks,
                               callbacks=(mod.callback_density,),
                               scheduler=np.arange(20, 401, 20))])
    st = sim.device_state["sys"]
    np.testing.assert_allclose(st.energy.numpy(),
                               mod.total_energy(st, p).numpy(), rtol=2e-3,
                               atol=5e-2)
    assert not np.allclose(st.box.numpy(), float(chains.box[0]), rtol=1e-4)
    assert bool((st.pos >= 0).all())
    assert bool((st.pos <= st.box[:, None, None]).all())
    cnt = sim.device_state["metropolis"]["counters"].sum(0).numpy()
    rates = cnt[:, 0] / cnt[:, 1]
    assert np.all((rates > 0.01) & (rates < 0.999)), rates
    d = np.loadtxt(os.path.join(sim.path, "density.dat"))
    assert np.all(np.isfinite(d[:, 1]))


def test_npt_density_matches_nvt_pressure(tmp_path):
    """The equation-of-state loop of the reference's ``test_npt_eos.py``:
    the NVT virial pressure at rho 0.6 (single-species LJ, T 1), then NPT
    at that pressure must come back to rho 0.6 within 5 %.  Reduced from
    the reference's 64 chains, 800 NVT and 1,600 NPT steps of 8 moves to
    32 chains, 160 and 250 steps (the NPT run starts at the density it
    must return to); the averages are over each run's later records."""
    n, rho, beta, m = 48, 0.6, 1.0, 32
    p = lj.LJParams()
    pressure = functools.partial(lj.callback_pressure, params=p)
    pressure.__name__ = "callback_pressure"
    chains = lj.init_chains(m, n, rho=rho, beta=beta, seed=9, params=p,
                            device="cpu")
    nvt = _run(lj.make_system(p), chains,
               (lj.lj_displacement_move(0.25, params=p),), 160,
               tmp_path / "nvt", sweepstep=8, seed=3, fused="off",
               recorders=[dict(algorithm=tmc.StoreCallbacks,
                               callbacks=(pressure,),
                               scheduler=np.arange(10, 161, 10))])
    d = np.loadtxt(os.path.join(nvt.path, "pressure.dat"))
    p_target = float(d[d[:, 0] > 50, 1].mean())
    assert np.isfinite(p_target) and p_target > 0
    chains = lj.init_chains(m, n, rho=rho, beta=beta, seed=21, params=p,
                            device="cpu")
    pool = (lj.lj_displacement_move(0.25, weight=0.95, params=p),
            lj.lj_volume_move(dlnv=0.04, pressure=p_target, weight=0.05,
                              params=p))
    npt = _run(lj.make_system(p), chains, pool, 250, tmp_path / "npt",
               sweepstep=8, seed=5,
               recorders=[dict(algorithm=tmc.StoreCallbacks,
                               callbacks=(lj.callback_density,),
                               scheduler=np.arange(10, 251, 10))])
    d = np.loadtxt(os.path.join(npt.path, "density.dat"))
    rho_mean = float(d[d[:, 0] > 100, 1].mean())
    assert rho_mean == pytest.approx(rho, rel=0.05), (rho_mean, p_target)
