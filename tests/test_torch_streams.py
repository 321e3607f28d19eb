"""The reference's per-chain random streams in the port, end to end.

Both packages build the same script from the same seed, with no chains or
draws carried across (no ``interop``):

- the particle models' ``init_chains`` give the reference's chains:
  positions, species and diameters equal, energies (each package's own
  float32 sum) within rtol 1e-5;
- the generic path (``fused='off'``) over >= 100 Metropolis steps a chain
  for a one-move pool, a grouped two-move pool (the ``categorical`` pick),
  MALA beside a displacement move (two groups), the LJ displacement + swap
  pool, the polydisperse displacement + swap pool and a hard-disk NPT pool
  with a volume move: counters equal, states within 1e-5 (energies rtol
  1e-5: float32 sums of O(10) terms);
- the PGMC estimator's accumulated ``GradientData`` within rtol 1e-5 and
  the parameters its updates compute;
- BASELINE config 1 (``examples/mc_harmonic_oscillator.py``'s pool and
  recorders, 10 chains, seed 42) on the generic path writes the
  reference's ``energy.dat`` within 1e-5.

They agree to float32 ulps of XLA's and torch's log/log1p, so an accept
test whose two sides tie to an ulp would flip and send one chain its own
way; the seeds are ones where none does, which is what this pins.
"""

import os

import numpy as np
import pytest
import torch

import montecarlo_tpu as mc
import montecarlo_tpu_torch as tmc
from montecarlo_tpu import policy_guided as ref_pg
from montecarlo_tpu.models import hard_disks as ref_hd
from montecarlo_tpu.models import lennard_jones as ref_lj
from montecarlo_tpu.models import particle1d as ref_p1d
from montecarlo_tpu.models import polydisperse as ref_poly
from montecarlo_tpu_torch import policy_guided as pg
from montecarlo_tpu_torch.models import hard_disks as hd
from montecarlo_tpu_torch.models import lennard_jones as lj
from montecarlo_tpu_torch.models import particle1d as p1d
from montecarlo_tpu_torch.models import polydisperse as poly
from torch_lattice_helpers import warm_up_transcendentals

warm_up_transcendentals()

ATOL, RTOL_E = 1e-5, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test runner runs several files at once, and
    the many small ops of the plain threefry version slow down sharply when
    threads contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=0.0, atol=ATOL):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


# -- init_chains ----------------------------------------------------------------

INITS = {
    "particle1d": lambda m, **kw: m.init_chains(33, beta=2.0, seed=42, **kw),
    "lj": lambda m, **kw: m.init_chains(3, 20, 0.7, 1.0, frac_b=0.2, seed=5,
                                        **kw),
    "lj3d": lambda m, **kw: m.init_chains(2, 27, 0.8, 1.0, frac_b=0.3,
                                          seed=0, dim=3, **kw),
    "poly": lambda m, **kw: m.init_chains(3, 25, 0.9, 2.0, seed=2 ** 31 - 1,
                                          **kw),
    "poly3d": lambda m, **kw: m.init_chains(2, 27, 0.9, 2.0, seed=7, dim=3,
                                            **kw),
    "hard_disks": lambda m, **kw: m.init_chains(3, 30, 0.5, seed=42, **kw),
    "hard_spheres": lambda m, **kw: m.init_chains(2, 27, 0.3, seed=1, dim=3,
                                                  **kw),
}
MODULES = {"particle1d": (ref_p1d, p1d), "lj": (ref_lj, lj),
           "lj3d": (ref_lj, lj), "poly": (ref_poly, poly),
           "poly3d": (ref_poly, poly), "hard_disks": (ref_hd, hd),
           "hard_spheres": (ref_hd, hd)}
EXACT = ("x", "pos", "species", "diam", "box", "beta")
ENERGY = ("e", "energy")


@pytest.mark.parametrize("name", sorted(INITS))
def test_init_chains_equal_reference(name):
    ref_mod, mod = MODULES[name]
    want = INITS[name](ref_mod)
    got = INITS[name](mod, device="cpu")
    for f in EXACT + ENERGY:
        if not hasattr(want, f):
            continue
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert tuple(g.shape) == w.shape, f
        if f in EXACT:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f)
        else:
            _close(g, w, rtol=RTOL_E, atol=1e-6)


# -- the generic path ------------------------------------------------------------

def _p1d(m, seed):
    return lambda mod, **kw: mod.init_chains(m, beta=2.0, seed=seed, **kw)


POOLS = {
    # name: (modules, chains, pool, steps, sweepstep, state fields)
    "displacement": ((ref_p1d, p1d), _p1d(64, 11),
                     lambda mod: (mod.displacement_move(0.5),), 120, 1,
                     ("x", "e")),
    "two_moves": ((ref_p1d, p1d), _p1d(64, 12),
                  lambda mod: (mod.displacement_move(0.3, weight=1.0),
                               mod.displacement_move(1.5, weight=3.0)),
                  120, 1, ("x", "e")),
    "mala": ((ref_p1d, p1d), _p1d(64, 13),
             lambda mod: (mod.mala_move(0.2, weight=2.0),
                          mod.displacement_move(0.6)), 120, 1, ("x", "e")),
    "lj_mixed": ((ref_lj, lj),
                 lambda mod, **kw: mod.init_chains(4, 16, 0.7, 1.0,
                                                   frac_b=0.25, seed=3, **kw),
                 lambda mod: (mod.lj_displacement_move(0.1, weight=0.8),
                              mod.lj_swap_move(weight=0.2)), 8, 16,
                 ("pos", "species", "energy")),
    "poly_swap": ((ref_poly, poly),
                  lambda mod, **kw: mod.init_chains(4, 16, 0.9, 2.0, seed=5,
                                                    **kw),
                  lambda mod: (mod.displacement_move(0.1, weight=0.8),
                               mod.swap_move(weight=0.2)), 8, 16,
                  ("pos", "diam", "energy")),
    "hard_disk_npt": ((ref_hd, hd),
                      lambda mod, **kw: mod.init_chains(4, 16, 0.4, seed=7,
                                                        **kw),
                      lambda mod: (mod.displacement_move(0.2, weight=0.9),
                                   mod.volume_move(0.05, 2.0, weight=0.1)),
                      8, 16, ("pos", "box")),
}


def _generic(pkg, mod, chains, pool, steps, sweepstep, path):
    sim = pkg.Simulation(mod.make_system(), chains, [
        dict(algorithm=pkg.Metropolis, pool=pool, seed=42, fused="off",
             sweepstep=sweepstep)], steps, path=path)
    sim.run()
    return sim


@pytest.mark.parametrize("name", sorted(POOLS))
def test_generic_path_equals_reference(name, tmp_path):
    (ref_mod, mod), chains, pool, steps, sweepstep, fields = POOLS[name]
    assert steps * sweepstep >= 100
    ref = _generic(mc, ref_mod, chains(ref_mod), pool(ref_mod), steps,
                   sweepstep, str(tmp_path / "ref"))
    sim = _generic(tmc, mod, chains(mod, device="cpu"), pool(mod), steps,
                   sweepstep, str(tmp_path / "port"))
    assert not sim.device_algos[0].supports_fused
    counters = sim.device_state["metropolis"]["counters"]
    np.testing.assert_array_equal(
        counters.numpy(), np.asarray(ref.device_state["metropolis"][
            "counters"]))
    assert int(counters[..., 1].sum()) == (
        steps * sweepstep * counters.shape[0])
    assert int(counters[..., 0].sum()) > 0
    for f in fields:
        g = getattr(sim.device_state["sys"], f)
        w = getattr(ref.device_state["sys"], f)
        _close(g, w, rtol=RTOL_E if f in ENERGY else 0.0)


# -- the PGMC estimator ---------------------------------------------------------------

PGMC_STEPS = 40


def _pgmc(pkg, pgm, mod, path, **kw):
    chains = mod.init_chains(32, beta=2.0, seed=42, **kw)
    pool = (mod.displacement_move(sigma=0.2, weight=0.5),
            mod.mala_move(0.05, weight=0.5))
    sim = pkg.Simulation(mod.make_system(), chains, [
        dict(algorithm=pkg.Metropolis, pool=pool, seed=9, fused="off"),
        dict(algorithm=pgm.PolicyGradientEstimator,
             dependencies=(pkg.Metropolis,),
             optimisers=(pgm.VPG(0.05), pgm.VPG(0.01)), q_batch_size=3,
             scheduler=np.arange(2, PGMC_STEPS + 1, 2)),
        dict(algorithm=pgm.PolicyGradientUpdate,
             dependencies=(pgm.PolicyGradientEstimator,),
             scheduler=np.asarray([10, 20, 30])),
    ], PGMC_STEPS, path=path)
    sim.run()
    return sim


def test_estimator_gradient_data_equals_reference(tmp_path):
    """The estimator's sums since the last update (five events) and the
    parameters the three updates computed, from the same seed: keys folded
    with the estimator's tag, t and the move, split into the q-batch."""
    ref = _pgmc(mc, ref_pg, ref_p1d, str(tmp_path / "ref"))
    sim = _pgmc(tmc, pg, p1d, str(tmp_path / "port"), device="cpu")
    for k, start in enumerate(({"sigma": 0.2}, {"step": 0.05})):
        want = ref.device_state["params"][k]
        got = sim.device_state["params"][k]
        for name, value in start.items():
            _close(got[name], want[name], rtol=1e-5, atol=0)
            assert float(got[name]) != pytest.approx(value, abs=1e-4)
        gw, gg = ref.device_state["pge"]["gd"][k], sim.device_state["pge"][
            "gd"][k]
        assert int(gg.n) == int(gw.n) > 0
        for field in ("j", "grad_j", "grad_logq_forward", "g"):
            _close(getattr(gg, field), getattr(gw, field), rtol=1e-5,
                   atol=1e-6)
    np.testing.assert_array_equal(
        sim.device_state["metropolis"]["counters"].numpy(),
        np.asarray(ref.device_state["metropolis"]["counters"]))
    _close(sim.device_state["sys"].x, ref.device_state["sys"].x)


# -- BASELINE config 1 ------------------------------------------------------------------

def _config1(pkg, mod, path, steps=1000, burn=100, **kw):
    """``examples/mc_harmonic_oscillator.py`` at a depth of ``steps`` on the
    generic path."""
    sampletimes = pkg.build_schedule(steps, burn, [0, 10])
    sim = pkg.Simulation(mod.make_system(mod.harmonic),
                         mod.init_chains(10, beta=2.0, seed=42, **kw), [
        dict(algorithm=pkg.Metropolis,
             pool=(mod.displacement_move(sigma=0.1, weight=1.0),), seed=42,
             fused="off"),
        dict(algorithm=pkg.StoreCallbacks,
             callbacks=(mod.callback_energy, pkg.callback_acceptance),
             scheduler=sampletimes),
        dict(algorithm=pkg.StoreTrajectories, scheduler=sampletimes),
        dict(algorithm=pkg.StoreBackups,
             scheduler=pkg.build_schedule(steps, burn, steps // 10),
             store_first=True, store_last=True),
        dict(algorithm=pkg.StoreLastFrames, scheduler=np.asarray([steps])),
    ], steps, path=path)
    sim.run()
    return sim


def test_baseline_config1_energy_file_equals_reference(tmp_path):
    ref = _config1(mc, ref_p1d, str(tmp_path / "ref"))
    sim = _config1(tmc, p1d, str(tmp_path / "port"), device="cpu")
    for name in ("energy.dat", "acceptance.dat"):
        want = np.loadtxt(os.path.join(ref.path, name))
        got = np.loadtxt(os.path.join(sim.path, name))
        assert got.shape == want.shape and len(got) > 50
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=0, atol=ATOL)
    for c in (1, 10):
        rel = os.path.join("trajectories", str(c), "trajectory.dat")
        np.testing.assert_allclose(np.loadtxt(os.path.join(sim.path, rel)),
                                   np.loadtxt(os.path.join(ref.path, rel)),
                                   rtol=0, atol=ATOL)
