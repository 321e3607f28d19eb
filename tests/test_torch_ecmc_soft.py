"""Soft-potential event-chain MC in the port (``lennard_jones.ecmc_model``,
``polydisperse.ecmc_model``): the gates of ``tests/test_ecmc_soft.py``, run
by the port alone, each in its reference test's band.

(1) The LJ ECMC equilibrium energy matches Metropolis on the same system;
(2) the MKK lifting-event pressure matches the configurational virial
pressure (they share no code path); (3) the polydisperse bisection solver
matches displacement-only Metropolis; (4) the dimension-generic event pass
runs 3-D LJ chains.

Cut from the reference's sizes (each iteration of the batched event loop
is a few dozen tensor operations, the poly hook's a few hundred): the LJ
run takes 100 steps, not 150, with the tail from step 50; the poly run 16
chains and 40 steps with 4 events a step, not 32, 200 and 8, its tail
from step 20 (the Metropolis side runs as long).  The bands are the
reference's: a difference of means below 4 standard errors + 0.02, and
the pressures within 8 %.
"""

import numpy as np
import pytest
import torch

import montecarlo_tpu_torch as tmc
from montecarlo_tpu_torch.models import lennard_jones as lj
from montecarlo_tpu_torch.models import polydisperse as poly

PARAMS = lj.LJParams()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test runner runs several files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(algo, system, chains, steps, path, callbacks):
    sim = tmc.Simulation(system, chains, [
        algo,
        dict(algorithm=tmc.StoreCallbacks, callbacks=callbacks,
             scheduler=np.arange(5, steps + 1, 5)),
    ], steps, path=str(path))
    sim.run()
    return sim


def _tail(path, name, after):
    e = np.loadtxt(path / f"{name}.dat")
    return e[e[:, 0] > after, 1]


def _agree(tail, tail2):
    se = np.sqrt(tail.std() ** 2 / len(tail) + tail2.std() ** 2 / len(tail2))
    assert abs(tail.mean() - tail2.mean()) < 4 * se + 0.02, (
        f"ECMC {tail.mean():.4f} vs MET {tail2.mean():.4f} (se {se:.4f})")


LJ_STEPS = 100


@pytest.fixture(scope="module")
def lj_ecmc_run(tmp_path_factory):
    chains = lj.init_chains(48, 64, rho=0.6, beta=1.0, frac_b=0.0, seed=1,
                            params=PARAMS, device="cpu")
    path = tmp_path_factory.mktemp("ecmc_lj")
    sim = _run(dict(algorithm=tmc.EventChain,
                    model=lj.ecmc_model(chain_length=1.5, params=PARAMS),
                    events_per_step=8, seed=2),
               lj.make_system(PARAMS), chains, LJ_STEPS, path,
               (lj.callback_energy_per_particle,))
    return sim, path


def test_lj_ecmc_matches_metropolis_energy(lj_ecmc_run, tmp_path):
    sim, path = lj_ecmc_run
    stats = sim.device_state["ecmc"]["stats"]
    assert int(stats["cap_hits"].sum()) == 0
    assert bool((stats["collisions"] > 0).all())
    chains = lj.init_chains(48, 64, rho=0.6, beta=1.0, frac_b=0.0, seed=1,
                            params=PARAMS, device="cpu")
    _run(dict(algorithm=tmc.Metropolis,
              pool=(lj.lj_displacement_move(0.25, params=PARAMS),),
              seed=3, sweepstep=64),
         lj.make_system(PARAMS), chains, LJ_STEPS, tmp_path,
         (lj.callback_energy_per_particle,))
    after = LJ_STEPS // 2
    _agree(_tail(path, "energy_per_particle", after),
           _tail(tmp_path, "energy_per_particle", after))


def test_lj_ecmc_pressure_estimator_matches_virial(lj_ecmc_run):
    sim, _ = lj_ecmc_run
    stats = sim.device_state["ecmc"]["stats"]
    excess = float(stats["excess"].double().sum())
    chains = float(stats["chains"].double().sum())
    p_ecmc = 1.0 + excess / (chains * 1.5)
    pv = float(lj.virial_pressure(sim.device_state["sys"], PARAMS).mean())
    p_vir = pv * 1.0 / 0.6     # beta P / rho
    assert abs(p_ecmc - p_vir) / p_vir < 0.08, (p_ecmc, p_vir)


def test_poly_ipl_ecmc_matches_metropolis(tmp_path):
    par = poly.PolyParams()
    steps = 40
    chains = poly.init_chains(16, 64, rho=1.0, beta=2.0, seed=1, params=par,
                              device="cpu")
    cbs = (poly.callback_energy_per_particle,)
    sim = _run(dict(algorithm=tmc.EventChain,
                    model=poly.ecmc_model(chain_length=1.0, params=par),
                    events_per_step=4, seed=2),
               poly.make_system(par), chains, steps, tmp_path / "ecmc", cbs)
    assert int(sim.device_state["ecmc"]["stats"]["cap_hits"].sum()) == 0
    # displacement-only Metropolis: ECMC keeps the diameters quenched
    _run(dict(algorithm=tmc.Metropolis,
              pool=(poly.displacement_move(0.12, params=par),),
              seed=3, sweepstep=128),
         poly.make_system(par), chains, steps, tmp_path / "met", cbs)
    _agree(_tail(tmp_path / "ecmc", "energy_per_particle", steps // 2),
           _tail(tmp_path / "met", "energy_per_particle", steps // 2))


def test_lj_ecmc_3d_runs(tmp_path):
    chains = lj.init_chains(8, 128, rho=0.3, beta=1.0, frac_b=0.0, seed=5,
                            params=PARAMS, dim=3, device="cpu")
    sim = _run(dict(algorithm=tmc.EventChain,
                    model=lj.ecmc_model(chain_length=1.0, params=PARAMS),
                    events_per_step=8, seed=2),
               lj.make_system(PARAMS), chains, 30, tmp_path,
               (lj.callback_energy_per_particle,))
    stats = sim.device_state["ecmc"]["stats"]
    assert int(stats["cap_hits"].sum()) == 0
    assert bool((stats["collisions"] > 0).all())
    e = np.loadtxt(tmp_path / "energy_per_particle.dat")
    assert np.all(np.isfinite(e[:, 1]))
    pos = sim.device_state["sys"].pos
    box = float(sim.device_state["sys"].box[0])
    assert float(pos.min()) >= 0 and float(pos.max()) < box
