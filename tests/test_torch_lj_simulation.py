"""The LJ slice end to end: the port's ``Simulation.run`` against the JAX
package's, both on the fused path's CPU stand-in (``fused='interpret'``),
from the same chains carried over by ``interop``, with the recorders of
``examples/lj_2d.py`` (``pgmc=False``): energy per particle and acceptance
callbacks, and ``StoreLastFrames``.

The two runs share the counter-hash stream, so the counters are equal and
the values agree to float32 ulps: ``energy_per_particle.dat`` within atol
1e-5 (an O(N^2) refresh summed in torch's order instead of XLA's),
``acceptance.dat`` within 1e-6, last frames within 1e-5.  The seeds are
ones where no accept decision flips on an ulp.
"""

import os

import numpy as np
import pytest

import montecarlo_tpu as mc
import montecarlo_tpu_torch as tmc
from montecarlo_tpu.models import lennard_jones as ref_lj
from montecarlo_tpu_torch import interop
from montecarlo_tpu_torch.models import lennard_jones as lj

M, N, SWEEPS = 8, 32, 12
POOLS = ("displacement", "mixed")
# summary.log lines that legitimately differ between two runs / backends
_VOLATILE = ("\tStarted on ", "\tSimulation time: ", "\tSimulation size: ",
             "\tStatus: Completed on ", "\t\tParallel: ", "\t\tDevices: ",
             "\t\tCell MC: ")


def _pool(mod, kind):
    if kind == "displacement":
        return (mod.lj_displacement_move(sigma=0.1),)
    return (mod.lj_displacement_move(sigma=0.1, weight=0.8),
            mod.lj_swap_move(weight=0.2))


def _algorithms(pkg, mod, kind, fused="interpret"):
    sampletimes = pkg.build_schedule(SWEEPS, 2, [0, 2])
    return [
        dict(algorithm=pkg.Metropolis, pool=_pool(mod, kind), seed=42,
             sweepstep=N, fused=fused),
        dict(algorithm=pkg.StoreCallbacks,
             callbacks=(mod.callback_energy_per_particle,
                        pkg.callback_acceptance),
             scheduler=sampletimes),
        dict(algorithm=pkg.StoreLastFrames, scheduler=np.asarray([SWEEPS])),
    ]


@pytest.fixture(scope="module", params=POOLS)
def runs(request, tmp_path_factory):
    kind = request.param
    root = tmp_path_factory.mktemp(kind)
    ref_chains = ref_lj.init_chains(M, N, 0.7, 1.0, frac_b=0.2, seed=42)
    ref_sim = mc.Simulation(ref_lj.make_system(), ref_chains,
                            _algorithms(mc, ref_lj, kind), SWEEPS,
                            path=str(root / "ref"))
    ref_sim.run()
    sim = tmc.Simulation(lj.make_system(),
                         interop.chains_from_reference(ref_chains,
                                                       device="cpu"),
                         _algorithms(tmc, lj, kind), SWEEPS,
                         path=str(root / "port"))
    assert sim.device_algos[0].supports_fused
    sim.run()
    return ref_sim, sim


def test_callbacks_match_reference(runs):
    ref_sim, sim = runs
    for name, atol in (("energy_per_particle.dat", 1e-5),
                       ("acceptance.dat", 1e-6)):
        want = np.loadtxt(os.path.join(ref_sim.path, name))
        got = np.loadtxt(os.path.join(sim.path, name))
        assert got.shape == want.shape and len(got) > 4
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=0, atol=atol)
    acc = np.loadtxt(os.path.join(sim.path, "acceptance.dat"))
    assert 0.05 < acc[-1, 1] < 0.98


def test_counters_and_final_state_match_reference(runs):
    ref_sim, sim = runs
    assert sim.t == ref_sim.t == SWEEPS
    np.testing.assert_array_equal(
        sim.device_state["metropolis"]["counters"].numpy(),
        np.asarray(ref_sim.device_state["metropolis"]["counters"]))
    want, got = ref_sim.device_state["sys"], sim.device_state["sys"]
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(got.species.numpy(),
                                  np.asarray(want.species))
    np.testing.assert_allclose(got.energy.numpy(), np.asarray(want.energy),
                               rtol=1e-5)
    counters = sim.device_state["metropolis"]["counters"].numpy()
    assert np.all(counters[..., 1].sum(axis=1) == SWEEPS * N)


def _read_frame(path):
    with open(path) as f:
        head, *rows = f.read().splitlines()
    t, n, e = head.split()
    rows = np.asarray([r.split() for r in rows], np.float64)
    return int(t), int(n), float(e), rows[:, 0].astype(int), rows[:, 1:]


def test_last_frames_match_reference(runs):
    ref_sim, sim = runs
    for c in range(M):
        rel = os.path.join("trajectories", str(c + 1), "lastframe.dat")
        t, n, e, spc, pos = _read_frame(os.path.join(sim.path, rel))
        rt, rn, re_, rspc, rpos = _read_frame(os.path.join(ref_sim.path, rel))
        assert (t, n) == (rt, rn) == (SWEEPS, N)
        assert e == pytest.approx(re_, rel=1e-5)
        np.testing.assert_array_equal(spc, rspc)
        np.testing.assert_allclose(pos, rpos, rtol=0, atol=1e-5)


def test_summary_log_matches_reference(runs):
    ref_sim, sim = runs
    lines = [[ln for ln in open(os.path.join(s.path, "summary.log"))
              .read().splitlines() if not ln.startswith("\t\tCell MC: ")]
             for s in runs]
    assert len(lines[0]) == len(lines[1])
    for a, b in zip(*lines):
        if a.startswith(_VOLATILE):
            assert b.split(":")[0] == a.split(":")[0]
            continue
        assert a == b
    port = open(os.path.join(sim.path, "summary.log")).read()
    assert "\t\tCell MC: unavailable — not ported" in port
    assert "\t\tpos: shape (32, 2) dtype float32" in port


def test_auto_and_unfusable_pools_take_the_generic_path(tmp_path):
    """On the CPU 'auto' never fuses; an LJ pool the kernels do not take (a
    swap with another interaction table, a 3-D state) takes the generic path
    under 'interpret' too, and runs."""
    chains = lj.init_chains(4, 16, 0.7, 1.0, frac_b=0.25, seed=1, device="cpu")

    def metropolis(pool, fused, st=chains):
        sim = tmc.Simulation(lj.make_system(), st, [
            dict(algorithm=tmc.Metropolis, pool=pool, sweepstep=4,
                 fused=fused)], 3, path=str(tmp_path))
        return sim, sim.device_algos[0]

    sim, met = metropolis(_pool(lj, "mixed"), "auto")
    assert not met.supports_fused
    sim.run()
    assert int(sim.device_state["metropolis"]["counters"][..., 1].sum()) \
        == 4 * 3 * 4
    other = lj.LJParams(rcut=2.0)
    sim, met = metropolis((lj.lj_displacement_move(0.1),
                           lj.lj_swap_move(params=other)), "interpret")
    assert not met.supports_fused
    sim.run()
    assert metropolis(_pool(lj, "mixed"), "interpret")[1].supports_fused
    assert metropolis(_pool(lj, "displacement"), "interpret")[1] \
        .supports_fused
    flat = chains.__class__(pos=chains.pos[..., :1].expand(-1, -1, 3)
                            .contiguous(), species=chains.species,
                            beta=chains.beta, energy=chains.energy,
                            box=chains.box)
    assert not metropolis(_pool(lj, "displacement"), "interpret",
                          flat)[1].supports_fused
