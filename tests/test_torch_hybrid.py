"""The hybrid stepper held to the JAX package's on the CPU.

A fused Metropolis listed first with sparse further device algorithms runs
in fused segments between their events, and the sparse algorithms at their
events (``core/simulation.py`` ``_make_hybrid_advance``).  To compare the
mechanics bit for bit, the sparse algorithm is a small deterministic one
defined here once per package: at its events it scales every move
parameter by 1.05, so the next segment's kernel reads a new sigma.  Both
runs take the fused path's CPU stand-in (``fused='interpret'``) from the
same chains (``interop``): the counters and sigma are equal, positions
agree within 1e-5 and energies within the bounds of the LJ slice's
end-to-end test (rtol 1e-5; the 1-D cache to float32 ulps); the LJ
species and the polydisperse diameters are equal.
"""

import os

import jax
import numpy as np
import pytest
import torch

import montecarlo_tpu as mc
import montecarlo_tpu_torch as tmc
from montecarlo_tpu.core.simulation import _select_advance as ref_select
from montecarlo_tpu.models import lennard_jones as ref_lj
from montecarlo_tpu.models import particle1d as ref_p1d
from montecarlo_tpu.models import polydisperse as ref_poly
from montecarlo_tpu_torch import interop
from montecarlo_tpu_torch import policy_guided as pg
from montecarlo_tpu_torch.core.simulation import _select_advance
from montecarlo_tpu_torch.models import lennard_jones as lj
from montecarlo_tpu_torch.models import particle1d as p1d
from montecarlo_tpu_torch.models import polydisperse as poly
from montecarlo_tpu_torch.ops import fused_sweep, lj_sweep, poly_sweep
from montecarlo_tpu_torch.utils.tree import tree_leaves, tree_map

SCALE_EVERY = 7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test runner runs several files at once, and
    the many small ops here slow down sharply when threads contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class RefScale(mc.DeviceAlgorithm):
    """Multiplies the Metropolis' move parameters by 1.05 at its events."""
    state_key = "scale"

    def __init__(self, sim, dependencies=(), **_):
        self.met = [d for d in dependencies if isinstance(d, mc.Metropolis)][0]

    def step(self, ds, t):
        k = self.met.params_key
        return {**ds, k: tuple(jax.tree_util.tree_map(lambda x: x * 1.05, p)
                               for p in ds[k])}


class Scale(tmc.DeviceAlgorithm):
    """The same, for the port."""
    state_key = "scale"

    def __init__(self, sim, dependencies=(), **_):
        self.met = [d for d in dependencies
                    if isinstance(d, tmc.Metropolis)][0]

    def step(self, ds, t):
        k = self.met.params_key
        return {**ds, k: tuple(tree_map(lambda x: x * 1.05, p)
                               for p in ds[k])}


def _setup(kind, pkg, ref):
    """(system, chains, pool, sweepstep, sweeps) of one package; the port's
    chains are the reference's carried over."""
    if kind == "lj":
        n, m, sweeps = 64, 8, 40
        mod = ref_lj if ref else lj
        chains = ref_lj.init_chains(m, n, 0.7, 1.0, frac_b=0.2, seed=42)
        pool = (mod.lj_displacement_move(0.1, weight=0.8),
                mod.lj_swap_move(weight=0.2))
        sweepstep = n
    elif kind == "poly":
        n, m, sweeps = 64, 8, 40
        mod = ref_poly if ref else poly
        chains = ref_poly.init_chains(m, n, rho=0.9, beta=2.0, seed=42)
        pool = (mod.displacement_move(0.1, weight=0.8),
                mod.swap_move(weight=0.2))
        sweepstep = n
    else:
        m, sweeps = 64, 400
        mod = ref_p1d if ref else p1d
        chains = ref_p1d.init_chains(m, beta=2.0, seed=1)
        pool = (mod.displacement_move(0.2),)
        sweepstep = 1
    if not ref:
        chains = interop.chains_from_reference(chains, device="cpu")
    return mod.make_system(), chains, pool, sweepstep, sweeps


def _simulation(kind, ref, path, fused="interpret"):
    pkg = mc if ref else tmc
    system, chains, pool, sweepstep, sweeps = _setup(kind, pkg, ref)
    return pkg.Simulation(system, chains, [
        dict(algorithm=pkg.Metropolis, pool=pool, seed=42,
             sweepstep=sweepstep, fused=fused),
        dict(algorithm=RefScale if ref else Scale,
             dependencies=(pkg.Metropolis,),
             scheduler=np.arange(SCALE_EVERY, sweeps + 1, SCALE_EVERY)),
        dict(algorithm=pkg.StoreCallbacks,
             callbacks=(pkg.callback_acceptance,),
             scheduler=np.arange(10, sweeps + 1, 10)),
    ], sweeps, path=path)


@pytest.fixture(scope="module", params=("lj", "poly", "p1d"))
def hybrid_runs(request, tmp_path_factory):
    kind = request.param
    root = tmp_path_factory.mktemp(kind)
    ref_sim = _simulation(kind, True, str(root / "ref"))
    assert "hybrid" in ref_select(ref_sim).__qualname__
    ref_sim.run()
    sim = _simulation(kind, False, str(root / "port"))
    assert "hybrid" in _select_advance(sim).__qualname__
    sim.run()
    return kind, ref_sim, sim


def test_hybrid_run_matches_reference(hybrid_runs):
    kind, ref_sim, sim = hybrid_runs
    assert sim.t == ref_sim.t
    counters = sim.device_state["metropolis"]["counters"].numpy()
    np.testing.assert_array_equal(
        counters, np.asarray(ref_sim.device_state["metropolis"]["counters"]))
    sweepstep = sim.device_algos[0].sweepstep
    assert np.all(counters[..., 1].sum(axis=1) == sim.steps * sweepstep)
    got_sigma = [float(x) for p in sim.device_state["params"]
                 for x in tree_leaves(p)]
    want_sigma = [float(x) for p in ref_sim.device_state["params"]
                  for x in jax.tree_util.tree_leaves(p)]
    assert got_sigma == want_sigma
    # one float32 rounding per event: 1.05 ** n_events to ~n_events ulps
    n_events = sim.steps // SCALE_EVERY
    assert got_sigma[0] == pytest.approx(
        float(_setup(kind, tmc, False)[2][0].params["sigma"])
        * 1.05 ** n_events, rel=1e-5)
    got, want = sim.device_state["sys"], ref_sim.device_state["sys"]
    if kind == "lj":
        np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos),
                                   rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got.species.numpy(),
                                      np.asarray(want.species))
        np.testing.assert_allclose(got.energy.numpy(),
                                   np.asarray(want.energy), rtol=1e-5)
    elif kind == "poly":
        np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos),
                                   rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got.diam.numpy(),
                                      np.asarray(want.diam))
        np.testing.assert_allclose(got.energy.numpy(),
                                   np.asarray(want.energy), rtol=1e-5)
    else:
        np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.e.numpy(), np.asarray(want.e),
                                   rtol=1e-6, atol=1e-6)
    want_acc = np.loadtxt(os.path.join(ref_sim.path, "acceptance.dat"))
    got_acc = np.loadtxt(os.path.join(sim.path, "acceptance.dat"))
    np.testing.assert_array_equal(got_acc[:, 0], want_acc[:, 0])
    np.testing.assert_allclose(got_acc[:, 1], want_acc[:, 1], rtol=0,
                               atol=1e-6)


def test_hybrid_segments_launch_the_sweep_once_each(tmp_path, monkeypatch):
    """Between two sync points (sparse events, recorder points, the end)
    the hybrid stepper makes one fused sweep call, and it never calls the
    Metropolis' generic step."""
    for kind, module, name in (("lj", lj_sweep, "fused_lj_mixed_sweep"),
                               ("poly", poly_sweep, "fused_poly_mixed_sweep"),
                               ("p1d", fused_sweep, "fused_gaussian_sweep")):
        sim = _simulation(kind, False, str(tmp_path / kind))
        calls = []
        real = getattr(module, name)
        monkeypatch.setattr(module, name,
                            lambda *a, _r=real, **k: calls.append(1)
                            or _r(*a, **k))
        met = sim.device_algos[0]
        monkeypatch.setattr(met, "step", None)
        sim.run()
        sync = set(range(SCALE_EVERY, sim.steps + 1, SCALE_EVERY)) \
            | set(range(10, sim.steps + 1, 10)) | {sim.steps}
        assert len(calls) == len(sync)


def _pgmc_sim(tmp_path, fused="interpret", est_every=10, upd_every=20,
              steps=200, metropolis_sched=None, extra=()):
    chains = p1d.init_chains(16, beta=2.0, seed=1, device="cpu")
    met = dict(algorithm=tmc.Metropolis, pool=(p1d.displacement_move(0.2),),
               seed=3, fused=fused)
    if metropolis_sched is not None:
        met["scheduler"] = metropolis_sched
    return tmc.Simulation(p1d.make_system(), chains, [
        met,
        dict(algorithm=pg.PolicyGradientEstimator,
             dependencies=(tmc.Metropolis,), optimisers=(pg.VPG(0.05),),
             scheduler=np.arange(est_every, steps + 1, est_every)),
        dict(algorithm=pg.PolicyGradientUpdate,
             dependencies=(pg.PolicyGradientEstimator,),
             scheduler=np.arange(upd_every, steps + 1, upd_every)),
        *extra,
    ], steps, path=str(tmp_path))


@pytest.mark.parametrize("case,hybrid", [
    ("sparse", True), ("dense", False), ("off", False),
    ("metropolis_not_always_on", False), ("metropolis_alone", False)])
def test_select_advance_picks_hybrid_where_the_reference_does(
        tmp_path, case, hybrid):
    """Hybrid for sparse schedules (``n_events * 2 <= steps``); the generic
    loop for dense ones (here every step), ``fused='off'`` or a Metropolis
    that does not run at every step; a lone fused Metropolis takes the
    plain fused stepper."""
    kw = {"sparse": {}, "dense": dict(est_every=1, upd_every=1),
          "off": dict(fused="off"),
          "metropolis_not_always_on": dict(
              metropolis_sched=np.arange(2, 201, 2))}.get(case)
    if case == "metropolis_alone":
        chains = p1d.init_chains(4, 2.0, device="cpu")
        sim = tmc.Simulation(p1d.make_system(), chains, [
            dict(algorithm=tmc.Metropolis,
                 pool=(p1d.displacement_move(0.2),), fused="interpret")],
            20, path=str(tmp_path))
    else:
        sim = _pgmc_sim(tmp_path, **kw)
    name = _select_advance(sim).__qualname__
    assert ("hybrid" in name) == hybrid
    if case in ("dense", "off", "metropolis_not_always_on"):
        assert "_make_advance" in name


def test_hybrid_pgmc_run_does_not_depend_on_recorder_points(tmp_path):
    """Recorders cut the hybrid stepper's segments at other steps, and the
    end state is bit for bit the same: the fused stream is keyed by the
    absolute step, and the estimator draws only at its own events."""
    a = _pgmc_sim(tmp_path / "a")
    a.run()
    b = _pgmc_sim(tmp_path / "b", extra=[dict(
        algorithm=tmc.StoreCallbacks, callbacks=(p1d.callback_energy,),
        scheduler=np.arange(1, 201, 3))])
    b.run()
    assert a.device_state["params"][0]["sigma"] != 0.2
    leaves = zip(tree_leaves(a.device_state), tree_leaves(b.device_state))
    for x, y in leaves:
        if torch.is_tensor(x):
            assert torch.equal(x, y)
