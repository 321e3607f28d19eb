"""The port's generic Metropolis path (``fused='off'``) against the analytic
target and the JAX package's generic path.

The generic path draws from a ``torch.Generator``, not the reference's
threefry keys, so it is held to the reference by statistics, as
``tests/test_distribution.py`` holds the reference: posterior moments of
the harmonic chain (mean 0, std 1/sqrt(2 beta), <E> = 1/(2 beta)), and the
acceptance rate of the reference's own generic run within Monte Carlo
error.
"""

import os

import numpy as np
import pytest
import torch

import montecarlo_tpu as mc
import montecarlo_tpu_torch as tmc
from montecarlo_tpu.models import particle1d as ref_p1d
from montecarlo_tpu_torch import interop
from montecarlo_tpu_torch.models import particle1d as p1d

M, STEPS, BURN, SIGMA = 1000, 3000, 500, 0.5


def _run(pkg, mod, chains, beta, path, pool=None):
    sched = pkg.build_schedule(STEPS, BURN, 10)
    sim = pkg.Simulation(mod.make_system(), chains, [
        dict(algorithm=pkg.Metropolis,
             pool=pool or (mod.displacement_move(SIGMA),), seed=7,
             fused="off"),
        dict(algorithm=pkg.StoreCallbacks,
             callbacks=(mod.callback_energy, pkg.callback_acceptance),
             scheduler=sched),
        dict(algorithm=pkg.StoreTrajectories, fmt=pkg.BIN(), scheduler=sched),
    ], STEPS, path=path)
    sim.run()
    return sim


@pytest.mark.parametrize("beta", [2.0, 3.0])
def test_generic_path_moments_and_reference_acceptance(tmp_path, beta):
    ref_chains = ref_p1d.init_chains(M, beta=beta, seed=3)
    sim = _run(tmc, p1d, interop.chains_from_reference(ref_chains,
                                                       device="cpu"), beta,
               str(tmp_path / "port"))
    assert not sim.device_algos[0].supports_fused
    _, fields = tmc.load_chain_major_trajectories(sim.path)
    x = np.asarray(fields["frame"][1:])
    assert abs(x.mean()) < 0.02
    assert abs(x.std() - 1.0 / np.sqrt(2.0 * beta)) < 0.02
    e = np.loadtxt(os.path.join(sim.path, "energy.dat"))
    assert abs(e[e[:, 0] >= BURN, 1].mean() - 1.0 / (2.0 * beta)) < 0.02

    ref_sim = _run(mc, ref_p1d, ref_chains, beta, str(tmp_path / "ref"))
    acc = np.loadtxt(os.path.join(sim.path, "acceptance.dat"))[-1, 1]
    ref_acc = np.loadtxt(os.path.join(ref_sim.path, "acceptance.dat"))[-1, 1]
    # binomial error of M * STEPS attempts is ~3e-4; correlations double it
    assert abs(acc - ref_acc) < 5e-3
    counters = sim.device_state["metropolis"]["counters"]
    assert counters.shape == (M, 1, 2)
    assert int(counters[..., 1].min()) == int(counters[..., 1].max()) == STEPS


def test_grouped_pool_counts_and_moments(tmp_path):
    """Two displacement moves of one structure (grouped into one proposal
    with gathered sigmas): attempts follow the weights, the narrow move
    accepts more, and the target is still sampled."""
    chains = p1d.init_chains(M, beta=2.0, seed=4, device="cpu")
    pool = (p1d.displacement_move(0.2, weight=1.0),
            p1d.displacement_move(1.5, weight=3.0))
    sim = _run(tmc, p1d, chains, 2.0, str(tmp_path / "pool"), pool=pool)
    met = sim.device_algos[0]
    assert len(met.groups) == 1 and met.groups[0][1] == (0, 1)
    c = sim.device_state["metropolis"]["counters"].sum(0).numpy()
    frac = c[:, 1] / c[:, 1].sum()
    assert abs(frac[0] - 0.25) < 0.01
    rate = c[:, 0] / c[:, 1]
    assert rate[0] > rate[1] + 0.2
    _, fields = tmc.load_chain_major_trajectories(sim.path)
    x = np.asarray(fields["frame"][1:])
    assert abs(x.std() - 0.5) < 0.02


def test_mc_step_matches_grouped_step_statistics():
    """``mc_step`` (one proposal per move) and ``grouped_mc_step`` sample
    the same kernel: equal acceptance within Monte Carlo error."""
    from montecarlo_tpu_torch.core.metropolis import (build_move_groups,
                                                      grouped_mc_step)
    pool = (p1d.displacement_move(0.3), p1d.displacement_move(1.0))
    mds = tuple(m.move for m in pool)
    params = tuple({"sigma": m.params["sigma"]} for m in pool)
    logw = torch.log(torch.tensor([0.5, 0.5]))
    groups, g_of, w_of = build_move_groups(pool)
    rates = []
    for grouped in (False, True):
        st = p1d.init_chains(20000, beta=2.0, seed=1, device="cpu")
        cnt = torch.zeros((20000, 2, 2), dtype=torch.int32)
        gen = torch.Generator().manual_seed(5)
        for _ in range(20):
            if grouped:
                st, cnt = grouped_mc_step(groups, g_of, w_of, params, logw,
                                          2, st, cnt, gen)
            else:
                st, cnt = tmc.mc_step(mds, params, logw, st, cnt, gen)
        assert torch.equal(st.e, st.x * st.x)
        c = cnt.sum(0).double()
        rates.append((c[:, 0] / c[:, 1]).numpy())
    np.testing.assert_allclose(rates[0], rates[1], atol=0.01)


def test_metropolis_rejects_bad_options(tmp_path):
    chains = p1d.init_chains(4, beta=1.0, device="cpu")
    def build(**kw):
        return tmc.Simulation(p1d.make_system(), chains, [
            dict(algorithm=tmc.Metropolis, **kw)], 10, path=str(tmp_path))
    with pytest.raises(ValueError):
        build(pool=())
    with pytest.raises(ValueError):
        build(pool=(p1d.displacement_move(0.5),), fused="fast")
    with pytest.raises(NotImplementedError):
        build(pool=(p1d.displacement_move(0.5),), fused="cell")
    with pytest.raises(ValueError):
        build(pool=(p1d.displacement_move(0.5, weight=0.0),))
    met = build(pool=(p1d.displacement_move(0.5),)).device_algos[0]
    # 'auto' on the CPU: the generic path, as the reference off its TPU
    assert met.fused == "auto" and not met.supports_fused
