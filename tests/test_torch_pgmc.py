"""PGMC end to end in the port, held to the JAX package on the CPU.

The estimator folds the JAX package's per-chain threefry keys, so at one
fixed state both packages draw the same proposals: the summed objective,
its gradient and the Fisher sums agree to float32 sum order (rtol 1e-5;
16384 samples summed in another order).  The rest mirrors the JAX package's PGMC tests, scaled to the CPU:
config 5's adaptation through the hybrid stepper (``tests/test_pgmc_lj.py``),
the seven optimisers on the harmonic trap (``tests/test_pgmc.py``), MALA
(``tests/test_mala.py``), PGMC on a second sampler
(``tests/test_two_samplers.py``) and the misuse errors.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlo_tpu as mc
import montecarlo_tpu_torch as tmc
from montecarlo_tpu import policy_guided as ref_pg
from montecarlo_tpu.models import lennard_jones as ref_lj
from montecarlo_tpu.models import particle1d as ref_p1d
from montecarlo_tpu_torch import interop
from montecarlo_tpu_torch import policy_guided as pg
from montecarlo_tpu_torch.core.simulation import _select_advance
from montecarlo_tpu_torch.models import lennard_jones as lj
from montecarlo_tpu_torch.models import particle1d as p1d
from montecarlo_tpu_torch.utils.tree import tree_leaves

BETA = 2.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test runner runs several files at once, and
    the many small ops here slow down sharply when threads contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _last_param(path, k=1):
    lines = open(os.path.join(path, "parameters", str(k),
                              "parameters.dat")).read().strip().splitlines()
    return [(int(t), float(v.strip("[],")))
            for t, v in (ln.split(" ", 1) for ln in lines)]


# -- the estimator against the reference -----------------------------------------------

def _estimator_pair(name, tmp_path):
    """The same learnable move and state in both packages' Simulations."""
    m = 4096
    if name == "lj":
        ref_chains = ref_lj.init_chains(m, 32, 0.7, 1.0, frac_b=0.2, seed=5)
        mods = (ref_lj, lj)
        pools = [(mod.lj_displacement_move(0.1, weight=0.8),
                  mod.lj_swap_move(weight=0.2)) for mod in mods]
        opts = [(p.VPG(0.01), p.Static()) for p in (ref_pg, pg)]
    else:
        ref_chains = ref_p1d.init_chains(m, beta=BETA, seed=5)
        mods = (ref_p1d, p1d)
        pools = [(mod.displacement_move(0.8),) for mod in mods]
        opts = [(p.VPG(0.01),) for p in (ref_pg, pg)]
    sims = []
    for pkg, p, mod, pool, opt, chains in zip(
            (mc, tmc), (ref_pg, pg), mods, pools, opts,
            (ref_chains, interop.chains_from_reference(ref_chains,
                                                       device="cpu"))):
        sims.append(pkg.Simulation(mod.make_system(), chains, [
            dict(algorithm=pkg.Metropolis, pool=pool, seed=9, fused="off"),
            dict(algorithm=p.PolicyGradientEstimator,
                 dependencies=(pkg.Metropolis,), optimisers=opt,
                 q_batch_size=4),
        ], 1, path=str(tmp_path / pkg.__name__)))
    return sims


@pytest.mark.parametrize("name", ["gaussian", "lj"])
def test_estimator_agrees_with_reference_by_statistics(name, tmp_path):
    ref_sim, sim = _estimator_pair(name, tmp_path)
    ref_est, est = ref_sim.device_algos[1], sim.device_algos[1]
    ref_ds = ref_est.step(ref_sim.init_device_state(), jnp.asarray(1))
    ds = est.step(sim.init_device_state(), 1)
    want = ref_ds["pge"]["gd"][0]
    got = ds["pge"]["gd"][0]
    n = 4096 * 4
    assert int(got.n) == int(want.n) == n
    for field in ("j", "grad_j", "grad_logq_forward", "g"):
        g = getattr(got, field).double().numpy()
        w = np.asarray(getattr(want, field), np.float64)
        scale = np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=field)
    assert float(ds["pge"]["obj"][0]) == pytest.approx(float(got.j) / n)
    # off-policy: the chains did not move
    for a, b in zip(tree_leaves(ds["sys"]), tree_leaves(sim.chains0)):
        assert torch.equal(a, b)


def test_estimator_summary_matches_reference(tmp_path):
    ref_sim, sim = _estimator_pair("gaussian", tmp_path)
    blocks = []
    for s in (ref_sim, sim):
        s.run()
        text = open(os.path.join(s.path, "summary.log")).read()
        i = text.index("\tPolicyGradientEstimator")
        blocks.append(text[i:].split("\n\n")[0].splitlines())
    ref_lines, lines = blocks
    assert len(lines) == len(ref_lines)
    for a, b in zip(ref_lines, lines):
        if "AD backend" in a:
            assert b == "\t\tAD backend: torch.autograd"
        elif "Devices" in a:
            assert b == "\t\tDevices: 1"
        else:
            assert a == b


# -- config 5's adaptation, scaled (tests/test_pgmc_lj.py) ---------------------

@pytest.fixture(scope="module")
def lj_pgmc_run(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lj_pgmc"))
    # the reference's 8 chains x q 1 give 16 samples an update, too few
    # for the drift (~0.1 sigma0 over the run) to clear the noise on
    # another stream; 16 chains x q 8 give 256.  N 256 for the CPU.
    n, m, steps = 256, 16, 40
    params = lj.LJParams()
    chains = lj.init_chains(m, n, rho=1.2, beta=1.0 / 0.45, frac_b=0.2,
                            seed=42, params=params, device="cpu")
    pool = (lj.lj_displacement_move(sigma=0.05, weight=0.8, params=params),
            lj.lj_swap_move(weight=0.2, params=params))
    sim = tmc.Simulation(lj.make_system(params), chains, [
        dict(algorithm=tmc.Metropolis, pool=pool, seed=7, fused="interpret"),
        dict(algorithm=pg.PolicyGradientEstimator,
             dependencies=(tmc.Metropolis,),
             optimisers=(pg.VPG(0.02), pg.Static()), q_batch_size=8,
             scheduler=np.arange(4, steps + 1, 4)),
        dict(algorithm=pg.PolicyGradientUpdate,
             dependencies=(pg.PolicyGradientEstimator,),
             scheduler=np.arange(8, steps + 1, 8)),
        dict(algorithm=tmc.StoreCallbacks,
             callbacks=(lj.callback_energy_per_particle,),
             scheduler=np.arange(10, steps + 1, 10)),
        dict(algorithm=tmc.StoreParameters, dependencies=(tmc.Metropolis,),
             scheduler=np.arange(8, steps + 1, 8)),
    ], steps, path=path)
    advance = _select_advance(sim)
    sim.run()
    return sim, advance, params, path, steps


def test_lj_pgmc_takes_the_hybrid_stepper(lj_pgmc_run):
    assert "hybrid" in lj_pgmc_run[1].__qualname__


def test_lj_pgmc_sigma_adapts_upward(lj_pgmc_run):
    sim, _, _, path, steps = lj_pgmc_run
    rows = _last_param(path)
    assert len(rows) == steps // 8 + 1
    sigma0, sigma_end = rows[0][1], rows[-1][1]
    assert sigma0 == pytest.approx(0.05)
    assert sigma_end > sigma0 * 1.02
    # the updated sigma is what the sweep read: the device parameters
    sigma_dev = sim.device_state["params"][0]["sigma"]
    assert float(sigma_dev) == sigma_end
    assert sigma_dev.is_contiguous() and sigma_dev.dtype == torch.float32


def test_lj_pgmc_energy_cache_consistent(lj_pgmc_run):
    sim, _, params, _, _ = lj_pgmc_run
    st = sim.device_state["sys"]
    np.testing.assert_allclose(st.energy.numpy(),
                               lj.total_energy(st, params).numpy(), rtol=1e-5)


def test_lj_pgmc_counters_and_recorders(lj_pgmc_run):
    sim, _, _, path, steps = lj_pgmc_run
    cnt = sim.device_state["metropolis"]["counters"].numpy()
    np.testing.assert_array_equal(cnt[:, :, 1].sum(axis=1), steps)
    assert cnt[:, 0, 1].min() > 0 and cnt[:, 1, 1].min() > 0
    e = np.loadtxt(f"{path}/energy_per_particle.dat")
    assert e.shape[0] == steps // 10 + 1
    assert np.all(np.isfinite(e))


# -- the seven optimisers (tests/test_pgmc.py), scaled -------------------------

def test_displacement_optimisation(tmp_path):
    """Seven displacement moves sharing sigma0 = 0.2, one optimiser of each
    type: Static stays exactly sigma0, every other one drives sigma toward
    the optimum ~1.2 at beta = 2, and the energy keeps equipartition.  The
    reference runs 4e4 steps of 10 chains; here 2e3 steps of 256 chains
    (q 4, an update per estimate) with step sizes scaled to match."""
    steps, sigma0 = 2000, 0.2
    pool = tuple(p1d.displacement_move(sigma=sigma0, weight=w)
                 for w in [0.4] + [0.1] * 6)
    optimisers = (pg.Static(), pg.VPG(0.05), pg.BLPG(0.05),
                  pg.BLAPG(1e-4, 1e-6), pg.NPG(1.0, 1e-6),
                  pg.ANPG(1e-4, 1e-6), pg.BLANPG(1e-4, 1e-6))
    sampletimes = tmc.build_schedule(steps, steps // 4, 10)
    path = str(tmp_path / "pgmc")
    sim = tmc.Simulation(p1d.make_system(p1d.harmonic),
                         p1d.init_chains(256, beta=BETA, seed=42,
                                         device="cpu"), [
        dict(algorithm=tmc.Metropolis, pool=pool, seed=42),
        dict(algorithm=pg.PolicyGradientEstimator,
             dependencies=(tmc.Metropolis,), optimisers=optimisers,
             q_batch_size=4, scheduler=np.arange(2, steps + 1, 2)),
        dict(algorithm=pg.PolicyGradientUpdate,
             dependencies=(pg.PolicyGradientEstimator,),
             scheduler=np.arange(2, steps + 1, 2)),
        dict(algorithm=tmc.StoreCallbacks, callbacks=(p1d.callback_energy,),
             scheduler=sampletimes),
        dict(algorithm=tmc.StoreParameters, dependencies=(tmc.Metropolis,),
             scheduler=sampletimes),
    ], steps, path=path)
    sim.run()
    energies = np.loadtxt(os.path.join(path, "energy.dat"))[:, 1]
    assert abs(energies.mean() - 0.25) < 5e-2
    for k, opt in enumerate(optimisers):
        sigma_last = _last_param(path, k + 1)[-1][1]
        if isinstance(opt, pg.Static):
            assert sigma_last == np.float32(sigma0)
        else:
            assert abs(sigma_last - 1.2) < 0.25, (type(opt).__name__,
                                                  sigma_last)


# -- MALA (tests/test_mala.py) -------------------------------------------------

def _mala_run(tmp_path, pool, steps, burn, n_chains=256, seed=42):
    sched = tmc.build_schedule(steps, burn, 5)
    sim = tmc.Simulation(
        p1d.make_system(p1d.harmonic),
        p1d.init_chains(n_chains, beta=BETA, seed=seed, device="cpu"),
        [dict(algorithm=tmc.Metropolis, pool=pool, seed=seed + 1),
         dict(algorithm=tmc.StoreCallbacks,
              callbacks=(p1d.callback_energy, tmc.callback_acceptance),
              scheduler=sched),
         dict(algorithm=tmc.StoreTrajectories, scheduler=sched,
              fmt=tmc.BIN())],
        steps, path=str(tmp_path))
    assert "hybrid" not in _select_advance(sim).__qualname__
    sim.run()
    times, fields = tmc.load_chain_major_trajectories(str(tmp_path))
    xs = np.asarray(fields["frame"][times > burn]).ravel()
    acc = np.loadtxt(tmp_path / "acceptance.dat")[-1, 1]
    return xs, acc


@pytest.mark.parametrize("mixed", [False, True])
def test_mala_matches_harmonic_moments(tmp_path, mixed):
    pool = (p1d.mala_move(step=0.15),)
    if mixed:
        pool = (p1d.mala_move(step=0.15, weight=1.0),
                p1d.displacement_move(sigma=0.5, weight=1.0))
    xs, acc = _mala_run(tmp_path, pool, steps=3000, burn=500)
    assert abs(xs.mean()) < 0.01
    assert abs(xs.std() - 1.0 / np.sqrt(2 * BETA)) < 0.01
    if not mixed:
        assert acc > 0.8


def test_mala_small_step_acceptance_near_one(tmp_path):
    _, acc = _mala_run(tmp_path, (p1d.mala_move(step=0.005),), steps=500,
                       burn=100)
    assert acc > 0.97


def test_mala_move_matches_reference():
    """The move's kind, parameters and proposal density, against the JAX
    package's at one state."""
    ref, mv = ref_p1d.mala_move(0.2), p1d.mala_move(0.2)
    assert mv.move.kind == ref.move.kind == "mala_displacement_1d"
    assert mv.move.name == ref.move.name
    assert float(mv.params["step"]) == float(ref.params["step"])
    rng = np.random.default_rng(3)
    x, a = rng.normal(size=32), rng.normal(size=32)
    st = p1d.Particle1DState(x=torch.tensor(x, dtype=torch.float32),
                             beta=torch.full((32,), BETA),
                             e=torch.tensor(x * x, dtype=torch.float32))
    got = mv.move.policy.log_density(mv.params,
                                     torch.tensor(a, dtype=torch.float32), st)
    want = jax.vmap(lambda xx, aa: ref.move.policy.log_density(
        ref.params, aa, ref_p1d.Particle1DState(
            x=xx, beta=jnp.float32(BETA), e=xx * xx)))(
                jnp.asarray(x, jnp.float32), jnp.asarray(a, jnp.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_mala_rejects_nonpositive_step():
    for step in (0.0, -0.1):
        with pytest.raises(ValueError, match="positive"):
            p1d.mala_move(step=step)


def test_mala_step_learnable_by_pgmc(tmp_path):
    """PGMC differentiates through the drift: a tiny step grows."""
    steps = 1500
    sim = tmc.Simulation(
        p1d.make_system(p1d.harmonic), p1d.init_chains(128, BETA, seed=3,
                                                       device="cpu"),
        [dict(algorithm=tmc.Metropolis, pool=(p1d.mala_move(step=0.02),),
              seed=4),
         dict(algorithm=pg.PolicyGradientEstimator,
              dependencies=(tmc.Metropolis,),
              optimisers=(pg.VPG(1e-3),), q_batch_size=10),
         dict(algorithm=pg.PolicyGradientUpdate,
              dependencies=(pg.PolicyGradientEstimator,)),
         dict(algorithm=tmc.StoreParameters, dependencies=(tmc.Metropolis,),
              scheduler=tmc.build_schedule(steps, 0, 100))],
        steps, path=str(tmp_path))
    sim.run()
    assert _last_param(str(tmp_path))[-1][1] > 0.05


# -- two samplers (tests/test_two_samplers.py) ---------------------------------

def test_pgmc_on_second_sampler_updates_only_its_params(tmp_path):
    steps = 30
    sim = tmc.Simulation(p1d.make_system(), p1d.init_chains(16, BETA, seed=3,
                                                            device="cpu"), [
        dict(algorithm=tmc.Metropolis,
             pool=(p1d.displacement_move(sigma=0.5),), seed=11),
        dict(algorithm=tmc.Metropolis,
             pool=(p1d.displacement_move(sigma=0.2),), seed=12),
        dict(algorithm=pg.PolicyGradientEstimator, dependencies=(1,),
             optimisers=(pg.VPG(0.01),), q_batch_size=2),
        dict(algorithm=pg.PolicyGradientUpdate,
             dependencies=(pg.PolicyGradientEstimator,)),
        dict(algorithm=tmc.StoreParameters, dependencies=(1,),
             scheduler=[steps]),
    ], steps, path=str(tmp_path / "pgmc2"))
    sim.run()
    ds = sim.device_state
    assert float(ds["params"][0]["sigma"]) == np.float32(0.5)
    sigma2 = float(ds["params_metropolis_1"][0]["sigma"])
    assert sigma2 != np.float32(0.2)
    rows = open(tmp_path / "pgmc2" / "parameters" / "metropolis_1" / "1" /
                "parameters.dat").read().splitlines()
    assert rows[-1] == f"{steps} [{sigma2!r}]"


# -- misuse --------------------------------------------------------------------

def _misuse(tmp_path, algos):
    chains = p1d.init_chains(4, BETA, device="cpu")
    return tmc.Simulation(p1d.make_system(), chains, algos,
                          10, path=str(tmp_path))


def test_optimiser_count_mismatch_raises(tmp_path):
    with pytest.raises(ValueError, match="one optimiser per move"):
        _misuse(tmp_path, [
            dict(algorithm=tmc.Metropolis,
                 pool=(p1d.displacement_move(0.5),
                       p1d.displacement_move(0.7))),
            dict(algorithm=pg.PolicyGradientEstimator,
                 dependencies=(tmc.Metropolis,), optimisers=(pg.VPG(0.1),))])


def test_missing_dependencies_raise(tmp_path):
    with pytest.raises(ValueError, match="single Metropolis"):
        _misuse(tmp_path, [
            dict(algorithm=tmc.Metropolis, pool=(p1d.displacement_move(0.5),)),
            dict(algorithm=pg.PolicyGradientEstimator,
                 optimisers=(pg.VPG(0.1),))])
    with pytest.raises(ValueError, match="single PolicyGradientEstimator"):
        _misuse(tmp_path, [
            dict(algorithm=tmc.Metropolis, pool=(p1d.displacement_move(0.5),)),
            dict(algorithm=pg.PolicyGradientUpdate,
                 dependencies=(tmc.Metropolis,))])


def test_move_without_reward_raises(tmp_path):
    mv = p1d.displacement_move(0.5)
    mv = dataclasses.replace(mv, move=dataclasses.replace(mv.move,
                                                          reward=None))
    sim = _misuse(tmp_path, [
        dict(algorithm=tmc.Metropolis, pool=(mv,), fused="off"),
        dict(algorithm=pg.PolicyGradientEstimator,
             dependencies=(tmc.Metropolis,), optimisers=(pg.VPG(0.1),))])
    with pytest.raises(ValueError, match="defines no reward"):
        sim.run()
