"""The slice end to end: the port's ``Simulation.run`` against the JAX
package's, both on the fused path's CPU stand-in (``fused='interpret'``),
from the same chains carried over by ``interop``.

The two runs share the counter-hash stream, so they agree to float32 ulps
of XLA's and torch's log/cos/sin: ``energy.dat`` and ``acceptance.dat``
within 1e-5, BIN frames within 1e-5.  An accept decision that flips on such
an ulp (about once in 10^7 steps here) would send one chain its own way;
the seed is one where none does, which is what this test pins.

Also the recorder files: the same values give byte-identical files.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlo_tpu as mc
import montecarlo_tpu_torch as tmc
from montecarlo_tpu.models import particle1d as ref_p1d
from montecarlo_tpu_torch import interop
from montecarlo_tpu_torch.models import particle1d as p1d

M, STEPS, STRIDE, SEED = 512, 4000, 100, 1
# summary.log lines that legitimately differ between two runs / backends
_VOLATILE = ("\tStarted on ", "\tSimulation time: ", "\tSimulation size: ",
             "\tStatus: Completed on ", "\t\tParallel: ", "\t\tDevices: ")
# summary.log lines of the port alone: the run's counters
_PORT_ONLY = ("\tCounters: ", "\tKernel launches: ")


def _algorithms(pkg, mod, sched):
    return [
        dict(algorithm=pkg.Metropolis, pool=(mod.displacement_move(0.5),),
             seed=SEED, fused="interpret"),
        dict(algorithm=pkg.StoreCallbacks,
             callbacks=(mod.callback_energy, pkg.callback_acceptance),
             scheduler=sched),
        dict(algorithm=pkg.StoreTrajectories, fmt=pkg.BIN(), scheduler=sched),
    ]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("e2e")
    sched = np.arange(STRIDE, STEPS + 1, STRIDE)
    ref_chains = ref_p1d.init_chains(M, beta=2.0, seed=SEED)
    ref_sim = mc.Simulation(ref_p1d.make_system(), ref_chains,
                            _algorithms(mc, ref_p1d, sched), STEPS,
                            path=str(root / "ref"))
    ref_sim.run()
    sim = tmc.Simulation(p1d.make_system(),
                         interop.chains_from_reference(ref_chains,
                                                       device="cpu"),
                         _algorithms(tmc, p1d, sched), STEPS,
                         path=str(root / "port"))
    sim.run()
    return ref_sim, sim


def test_callbacks_match_reference(runs):
    ref_sim, sim = runs
    for name in ("energy.dat", "acceptance.dat"):
        want = np.loadtxt(os.path.join(ref_sim.path, name))
        got = np.loadtxt(os.path.join(sim.path, name))
        assert got.shape == want.shape == (STEPS // STRIDE + 1, 2)
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=0, atol=1e-5)
    e = np.loadtxt(os.path.join(sim.path, "energy.dat"))
    assert abs(e[len(e) // 2:, 1].mean() - 0.25) < 0.02


def test_bin_stores_cross_load(runs):
    ref_sim, sim = runs
    t_rr, f_rr = mc.load_chain_major_trajectories(ref_sim.path)
    t_rp, f_rp = mc.load_chain_major_trajectories(sim.path)
    t_pr, f_pr = tmc.load_chain_major_trajectories(ref_sim.path)
    t_pp, f_pp = tmc.load_chain_major_trajectories(sim.path)
    for t in (t_rp, t_pr, t_pp):
        np.testing.assert_array_equal(t, t_rr)
    assert f_rp["frame"].shape == (STEPS // STRIDE + 1, M)
    np.testing.assert_array_equal(f_pr["frame"], f_rr["frame"])
    np.testing.assert_array_equal(f_rp["frame"], f_pp["frame"])
    np.testing.assert_allclose(f_pp["frame"], f_rr["frame"], rtol=0,
                               atol=1e-5)
    idx = [json.load(open(os.path.join(s.path, "trajectories",
                                       "index.json"))) for s in runs]
    assert idx[0] == idx[1]
    assert idx[1]["fields"] == {"frame": {"dtype": "<f4", "shape": [M]}}


def test_summary_log_matches_reference(runs):
    ref_sim, sim = runs
    lines = [open(os.path.join(s.path, "summary.log")).read().splitlines()
             for s in runs]
    assert [ln.split(":")[0] for ln in lines[1] if ln.startswith(
        _PORT_ONLY)] == ["\tCounters", "\tKernel launches"]
    lines[1] = [ln for ln in lines[1] if not ln.startswith(_PORT_ONLY)]
    assert len(lines[0]) == len(lines[1])
    for a, b in zip(*lines):
        if a.startswith(_VOLATILE):
            assert b.split(":")[0] == a.split(":")[0]
            continue
        assert a == b
    assert "\t\tx: shape () dtype float32" in lines[1]


def test_final_state_matches_reference(runs):
    ref_sim, sim = runs
    assert sim.t == ref_sim.t == STEPS
    want = np.asarray(ref_sim.device_state["sys"].x)
    got = sim.device_state["sys"].x.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        sim.device_state["metropolis"]["counters"].numpy(),
        np.asarray(ref_sim.device_state["metropolis"]["counters"]))


def test_per_event_path_matches_reference(tmp_path):
    """Irregular (log-spaced) recorder times, a host algorithm and
    ``sweepstep=2`` take the per-event path: advance, pull, write.  Same
    stream, so same files within 1e-5; parameters.dat byte-identical."""
    m, steps = 256, 2000
    log_times = mc.build_schedule(steps, 0, 2.0)
    host_times = np.asarray([500, 1000, 2000])
    ref_chains = ref_p1d.init_chains(m, beta=1.5, seed=SEED)

    def algorithms(pkg, mod, throughput):
        return [
            dict(algorithm=pkg.Metropolis, pool=(mod.displacement_move(0.8),),
                 seed=5, sweepstep=2, fused="interpret"),
            dict(algorithm=pkg.StoreCallbacks,
                 callbacks=(mod.callback_energy, pkg.callback_acceptance),
                 scheduler=log_times),
            dict(algorithm=pkg.StoreParameters, dependencies=(pkg.Metropolis,),
                 scheduler=log_times, store_last=True),
            dict(algorithm=pkg.PrintTimeSteps, scheduler=host_times),
            dict(algorithm=throughput, scheduler=host_times),
        ]

    ref_sim = mc.Simulation(ref_p1d.make_system(), ref_chains,
                            algorithms(mc, ref_p1d, mc.Throughput), steps,
                            path=str(tmp_path / "ref"))
    ref_sim.run()
    sim = tmc.Simulation(p1d.make_system(),
                         interop.chains_from_reference(ref_chains,
                                                       device="cpu"),
                         algorithms(tmc, p1d, tmc.Throughput), steps,
                         path=str(tmp_path / "port"))
    sim.run()
    assert sim.t == steps
    for name in ("energy.dat", "acceptance.dat"):
        want = np.loadtxt(os.path.join(ref_sim.path, name))
        got = np.loadtxt(os.path.join(sim.path, name))
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=0, atol=1e-5)
    rel = os.path.join("parameters", "1", "parameters.dat")
    port_params = open(os.path.join(sim.path, rel)).read()
    assert port_params == open(os.path.join(ref_sim.path, rel)).read()
    assert port_params.splitlines()[-1] == f"{steps} [0.800000011920929]"
    thr = np.loadtxt(os.path.join(sim.path, "throughput.dat"))
    np.testing.assert_array_equal(thr[:, 0], host_times)
    assert (thr[:, 1] > 0).all()
    np.testing.assert_array_equal(
        sim.device_state["metropolis"]["counters"].numpy(),
        np.asarray(ref_sim.device_state["metropolis"]["counters"]))


def test_hybrid_stepper_is_not_ported(tmp_path):
    """A fused Metropolis followed by a sparse second device algorithm
    takes the reference's hybrid stepper (it used to be refused here, before
    the stepper was ported): fused segments for the first, the second at its
    events only."""
    from montecarlo_tpu_torch.core.simulation import _select_advance
    chains = p1d.init_chains(8, beta=1.0, device="cpu")
    pool = (p1d.displacement_move(0.5),)
    sim = tmc.Simulation(p1d.make_system(), chains, [
        dict(algorithm=tmc.Metropolis, pool=pool, fused="interpret"),
        dict(algorithm=tmc.Metropolis, pool=pool, scheduler=[5, 10]),
    ], 10, path=str(tmp_path))
    assert "hybrid" in _select_advance(sim).__qualname__
    sim.run()
    ds = sim.device_state
    assert ds["t"] == 10
    assert ds["metropolis"]["counters"][..., 1].sum() == 8 * 10
    assert ds["metropolis_1"]["counters"][..., 1].sum() == 8 * 2


class _FakeSim:
    def __init__(self, path, n_chains, system, verbose=False):
        self.path, self.n_chains, self.system = path, n_chains, system
        self.verbose = verbose


@pytest.mark.parametrize("fmt", ["DAT", "BIN"])
def test_recorder_files_are_byte_identical(tmp_path, fmt):
    """Same numpy values through both packages' recorders: same bytes."""
    rng = np.random.default_rng(0)
    n, ts = 5, [10, 20, 30, 40]
    frames = rng.normal(size=(len(ts), n)).astype(np.float32)
    energy = rng.normal(size=len(ts)).astype(np.float32)
    acc = rng.uniform(size=len(ts)).astype(np.float32)
    dirs = []
    for name, pkg, mod in (("ref", mc, ref_p1d), ("port", tmc, p1d)):
        fake = _FakeSim(str(tmp_path / name), n, mod.make_system())
        cb = pkg.StoreCallbacks(fake, callbacks=(mod.callback_energy,
                                                 pkg.callback_acceptance))
        tr = pkg.StoreTrajectories(fake, fmt=getattr(pkg, fmt)())
        for r in (cb, tr):
            r.initialise(fake)
        cb.write(fake, 0, (energy[0], acc[0]))
        tr.write(fake, 0, frames[0])
        cb.write_batch(fake, ts, (energy, acc))
        tr.write_batch(fake, ts, frames)
        for r in (cb, tr):
            r.finalise(fake)
        dirs.append(fake.path)
    listing = [sorted(os.path.relpath(os.path.join(r, f), d)
                      for r, _, fs in os.walk(d) for f in fs) for d in dirs]
    assert listing[0] == listing[1] and len(listing[0]) >= 3
    for rel in listing[0]:
        with open(os.path.join(dirs[0], rel), "rb") as a, \
                open(os.path.join(dirs[1], rel), "rb") as b:
            assert a.read() == b.read(), rel


def test_callback_acceptance_matches_reference():
    """Mean over chains and moves, with zero-attempt entries excluded."""
    rng = np.random.default_rng(1)
    tot = rng.integers(0, 5, (64, 3))
    counters = np.stack([rng.integers(0, 5, (64, 3)) % (tot + 1), tot],
                        axis=-1).astype(np.int32)
    for c in (counters, np.zeros_like(counters)):
        state = {"metropolis": {"counters": c}, "metropolis_1": {
            "counters": c[:, :1]}, "other": {"counters": c}}
        want = float(mc.callback_acceptance(mc.SimView(
            sys=None, params=(), t=0, state={
                k: {"counters": jnp.asarray(v["counters"])}
                for k, v in state.items()})))
        got = float(tmc.callback_acceptance(tmc.SimView(
            sys=None, params=(), t=0, state={
                k: {"counters": torch.from_numpy(v["counters"])}
                for k, v in state.items()})))
        assert got == pytest.approx(want, rel=1e-6, abs=0)
