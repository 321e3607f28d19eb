"""The polydisperse swap-MC slice end to end: the port's ``Simulation.run``
against the JAX package's, both on the fused path's CPU stand-in
(``fused='interpret'``), from the same chains carried over by ``interop``,
with the recorders of ``examples/swap_mc_glass.py`` (energy per particle)
plus the acceptance callback and ``StoreLastFrames``.

The two runs share the counter-hash stream, so the counters and diameters
are equal and the values agree to float32 ulps: ``energy_per_particle.dat``
within atol 1e-5 (an O(N^2) refresh summed in torch's order instead of
XLA's), ``acceptance.dat`` within 1e-6, last frames within 1e-5.  The seed
is one where no accept decision flips on an ulp.
"""

import os

import numpy as np
import pytest

import montecarlo_tpu as mc
import montecarlo_tpu_torch as tmc
from montecarlo_tpu.models import polydisperse as ref_poly
from montecarlo_tpu_torch import interop
from montecarlo_tpu_torch.models import polydisperse as poly

M, N, SWEEPS = 8, 32, 12
# summary.log lines that legitimately differ between two runs / backends
_VOLATILE = ("\tStarted on ", "\tSimulation time: ", "\tSimulation size: ",
             "\tStatus: Completed on ", "\t\tParallel: ", "\t\tDevices: ")


def _pool(mod):
    return (mod.displacement_move(0.1, weight=0.8),
            mod.swap_move(weight=0.2))


def _algorithms(pkg, mod, fused="interpret"):
    return [
        dict(algorithm=pkg.Metropolis, pool=_pool(mod), seed=42,
             sweepstep=N, fused=fused),
        dict(algorithm=pkg.StoreCallbacks,
             callbacks=(mod.callback_energy_per_particle,
                        pkg.callback_acceptance),
             scheduler=pkg.build_schedule(SWEEPS, 0, 2)),
        dict(algorithm=pkg.StoreLastFrames, scheduler=np.asarray([SWEEPS])),
    ]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("poly")
    ref_chains = ref_poly.init_chains(M, N, rho=0.9, beta=2.0, seed=42)
    ref_sim = mc.Simulation(ref_poly.make_system(), ref_chains,
                            _algorithms(mc, ref_poly), SWEEPS,
                            path=str(root / "ref"))
    ref_sim.run()
    sim = tmc.Simulation(poly.make_system(),
                         interop.chains_from_reference(ref_chains,
                                                       device="cpu"),
                         _algorithms(tmc, poly), SWEEPS,
                         path=str(root / "port"))
    assert sim.device_algos[0].supports_fused
    sim.run()
    return ref_sim, sim, ref_chains


def test_callbacks_match_reference(runs):
    ref_sim, sim, _ = runs
    for name, atol in (("energy_per_particle.dat", 1e-5),
                       ("acceptance.dat", 1e-6)):
        want = np.loadtxt(os.path.join(ref_sim.path, name))
        got = np.loadtxt(os.path.join(sim.path, name))
        assert got.shape == want.shape == (SWEEPS // 2 + 1, 2)
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=0, atol=atol)
    acc = np.loadtxt(os.path.join(sim.path, "acceptance.dat"))
    assert 0.05 < acc[-1, 1] < 0.98


def test_counters_and_final_state_match_reference(runs):
    ref_sim, sim, ref_chains = runs
    assert sim.t == ref_sim.t == SWEEPS
    counters = sim.device_state["metropolis"]["counters"].numpy()
    np.testing.assert_array_equal(
        counters, np.asarray(ref_sim.device_state["metropolis"]["counters"]))
    want, got = ref_sim.device_state["sys"], sim.device_state["sys"]
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(got.diam.numpy(), np.asarray(want.diam))
    np.testing.assert_allclose(got.energy.numpy(), np.asarray(want.energy),
                               rtol=1e-5)
    assert np.all(counters[..., 1].sum(axis=1) == SWEEPS * N)
    assert np.all(counters[:, 1, 0] > 0)               # swaps accepted
    # diameters conserved per chain, and moved
    init = np.asarray(ref_chains.diam)
    np.testing.assert_array_equal(np.sort(got.diam.numpy(), 1),
                                  np.sort(init, 1))
    assert not np.array_equal(got.diam.numpy(), init)


def _read_frame(path):
    with open(path) as f:
        head, *rows = f.read().splitlines()
    t, n, e = head.split()
    rows = np.asarray([r.split() for r in rows], np.float64)
    return int(t), int(n), float(e), rows[:, 0], rows[:, 1:]


def test_last_frames_match_reference(runs):
    ref_sim, sim, _ = runs
    for c in range(M):
        rel = os.path.join("trajectories", str(c + 1), "lastframe.dat")
        t, n, e, dia, pos = _read_frame(os.path.join(sim.path, rel))
        rt, rn, re_, rdia, rpos = _read_frame(os.path.join(ref_sim.path,
                                                           rel))
        assert (t, n) == (rt, rn) == (SWEEPS, N)
        assert e == pytest.approx(re_, rel=1e-5)
        np.testing.assert_array_equal(dia, rdia)
        np.testing.assert_allclose(pos, rpos, rtol=0, atol=1e-5)


def test_summary_log_matches_reference(runs):
    ref_sim, sim, _ = runs
    lines = [[ln for ln in open(os.path.join(s.path, "summary.log"))
              .read().splitlines() if not ln.startswith("\t\tCell MC: ")]
             for s in runs[:2]]
    assert len(lines[0]) == len(lines[1])
    for a, b in zip(*lines):
        if a.startswith(_VOLATILE):
            assert b.split(":")[0] == a.split(":")[0]
            continue
        assert a == b
    port = open(os.path.join(sim.path, "summary.log")).read()
    assert "\tPolydisperseSoftSpheres2D\n" in port
    assert "\t\tdiam: shape (32,) dtype float32" in port
    assert "\t\t\t\tAction: PolySwap\n" in port


def test_auto_and_unfusable_pools_take_the_generic_path(tmp_path):
    """On the CPU 'auto' never fuses; a displacement-only poly pool has no
    kernel (as in the reference), nor has a swap with other PolyParams or
    a single particle: each takes the generic path under 'interpret' too,
    and runs."""
    chains = poly.init_chains(4, 16, rho=0.9, beta=2.0, seed=1, device="cpu")

    def metropolis(pool, fused, st=chains):
        sim = tmc.Simulation(poly.make_system(), st, [
            dict(algorithm=tmc.Metropolis, pool=pool, sweepstep=4,
                 fused=fused)], 3, path=str(tmp_path))
        return sim, sim.device_algos[0]

    assert metropolis(_pool(poly), "interpret")[1].supports_fused
    for pool, fused in ((_pool(poly), "auto"),
                        ((poly.displacement_move(0.1),), "interpret"),
                        ((poly.displacement_move(0.1),
                          poly.swap_move(params=poly.PolyParams(eps=0.1))),
                         "interpret")):
        sim, met = metropolis(pool, fused)
        assert not met.supports_fused
        sim.run()
        counters = sim.device_state["metropolis"]["counters"]
        assert int(counters[..., 1].sum()) == 4 * 3 * 4
        final = sim.device_state["sys"]
        np.testing.assert_allclose(final.energy.numpy(),
                                   poly.total_energy(final).numpy(),
                                   rtol=1e-4, atol=1e-3)
    one = poly.init_chains(4, 1, rho=0.9, beta=2.0, seed=1, device="cpu")
    assert not metropolis(_pool(poly), "interpret", one)[1].supports_fused
