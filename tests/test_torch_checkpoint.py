"""Checkpoint and resume in the port (``checkpoint.py``, ``StoreBackups``).

As in the JAX package's ``tests/test_checkpoint.py``: a run interrupted at
a backup and resumed from its checkpoint in a fresh ``Simulation`` ends in
the same state, bit for bit, as the run that was not interrupted.  Here
that holds on the generic path (the generator's state is saved), on the
fused path's CPU stand-in (the stream is keyed by the step), and with PGMC
(the estimator's generator and accumulators are saved).  A chain-major BIN
store resumed in its own directory appends, where the JAX package's
truncates.
"""

import glob
import os

import numpy as np
import pytest
import torch

import montecarlo_tpu_torch as tmc
from montecarlo_tpu_torch import checkpoint
from montecarlo_tpu_torch import policy_guided as pg
from montecarlo_tpu_torch.core.simulation import _select_advance
from montecarlo_tpu_torch.models import lennard_jones as lj
from montecarlo_tpu_torch.models import particle1d as p1d
from montecarlo_tpu_torch.utils.tree import tree_leaves_with_path

STEPS, BACKUP = 60, 30


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test runner runs several files at once, and
    the many small ops here slow down sharply when threads contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(a, b):
    """Two device states are equal leaf by leaf: tensors bitwise,
    generators by their state, the step as an int."""
    la, lb = tree_leaves_with_path(a), tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Generator):
            assert isinstance(y, torch.Generator) and x.device == y.device
            assert torch.equal(x.get_state(), y.get_state()), path
        elif torch.is_tensor(x):
            assert x.dtype == y.dtype and x.device == y.device, path
            assert torch.equal(x, y), path
        else:
            assert type(x) is type(y) and x == y, path


def _algorithms(case, backup=False, fmt=None):
    if case == "lj_pgmc":
        pool = (lj.lj_displacement_move(0.1, weight=0.8),
                lj.lj_swap_move(weight=0.2))
        met = dict(algorithm=tmc.Metropolis, pool=pool, seed=5, sweepstep=8,
                   fused="interpret")
    else:
        met = dict(algorithm=tmc.Metropolis,
                   pool=(p1d.displacement_move(0.5),), seed=42,
                   fused="off" if case == "generic" else "interpret")
    algos = [met]
    if case in ("pgmc", "lj_pgmc"):
        opts = (pg.VPG(0.05),) + ((pg.Static(),) if case == "lj_pgmc" else ())
        algos += [
            dict(algorithm=pg.PolicyGradientEstimator,
                 dependencies=(tmc.Metropolis,), optimisers=opts,
                 q_batch_size=2, scheduler=np.arange(4, STEPS + 1, 4)),
            dict(algorithm=pg.PolicyGradientUpdate,
                 dependencies=(pg.PolicyGradientEstimator,),
                 scheduler=np.arange(8, STEPS + 1, 8))]
    energy = (lj.callback_energy_per_particle if case == "lj_pgmc"
              else p1d.callback_energy)
    algos.append(dict(algorithm=tmc.StoreCallbacks,
                      callbacks=(energy, tmc.callback_acceptance),
                      scheduler=tmc.build_schedule(STEPS, 10, 10)))
    if case in ("pgmc", "lj_pgmc"):
        algos.append(dict(algorithm=tmc.StoreParameters,
                          dependencies=(tmc.Metropolis,),
                          scheduler=tmc.build_schedule(STEPS, 0, 10)))
    if fmt is not None:
        algos.append(dict(algorithm=tmc.StoreTrajectories, fmt=fmt,
                          scheduler=tmc.build_schedule(STEPS, 0, 5)))
    if backup:
        algos.append(dict(algorithm=tmc.StoreBackups,
                          scheduler=np.asarray([BACKUP])))
    return algos


def _simulation(case, path, **kw):
    if case == "lj_pgmc":
        system = lj.make_system()
        chains = lj.init_chains(4, 32, 0.7, 1.0, frac_b=0.2, seed=3)
    else:
        system = p1d.make_system()
        chains = p1d.init_chains(16, beta=2.0, seed=1)
    return tmc.Simulation(system, chains, _algorithms(case, **kw), STEPS,
                          path=str(path))


def test_roundtrip_save_restore(tmp_path):
    """Tensors, generators (also mid-stream) and the step come back equal,
    and a restored generator continues the saved one's stream."""
    sim = _simulation("pgmc", tmp_path / "rt")
    sim.run()
    ds = sim.device_state
    path = str(tmp_path / "state.npz")
    checkpoint.save(path, ds)
    restored = checkpoint.restore(path, sim.init_device_state())
    _same(ds, restored)
    assert restored["t"] == STEPS and isinstance(restored["t"], int)
    gen, gen2 = ds["metropolis"]["generator"], restored["metropolis"][
        "generator"]
    assert torch.equal(torch.rand(5, generator=gen),
                       torch.rand(5, generator=gen2))
    assert len(restored["pge"]["gd"]) == 1
    assert restored["pge"]["gd"][0].g.shape == (1, 1)


def test_restore_refuses_another_structure(tmp_path):
    sim = _simulation("generic", tmp_path / "a")
    path = str(tmp_path / "state.npz")
    checkpoint.save(path, sim.init_device_state())
    other = _simulation("pgmc", tmp_path / "b")
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.restore(path, other.init_device_state())


@pytest.mark.parametrize("case", ["generic", "fused", "pgmc", "lj_pgmc"])
def test_resume_bitwise_equals_uninterrupted(tmp_path, case):
    ref = _simulation(case, tmp_path / "ref")
    if case != "generic":
        name = _select_advance(ref).__qualname__
        assert ("hybrid" in name) == (case in ("pgmc", "lj_pgmc"))
    ref.run()

    a = _simulation(case, tmp_path / "a", backup=True)
    a.run()
    ckpt = os.path.join(a.path, "checkpoints", f"ckpt_t{BACKUP}.npz")
    assert os.path.exists(ckpt)

    b = _simulation(case, tmp_path / "b")
    checkpoint.resume_state(b, ckpt)
    assert b.t == BACKUP
    b.run()
    assert b.t == STEPS
    _same(ref.device_state, b.device_state)
    if case in ("pgmc", "lj_pgmc"):
        assert float(ref.device_state["params"][0]["sigma"]) != float(
            ref.algorithms[0].pool[0].params["sigma"])

    # the resumed text recorders hold exactly the post-resume rows
    for name in ("energy.dat" if case != "lj_pgmc"
                 else "energy_per_particle.dat", "acceptance.dat"):
        got = np.loadtxt(os.path.join(b.path, name))
        want = np.loadtxt(os.path.join(ref.path, name))
        assert got[0, 0] > BACKUP
        np.testing.assert_array_equal(got, want[want[:, 0] > BACKUP])


def test_bin_store_appends_on_resume_in_place(tmp_path):
    """Resumed in the directory of the run it continues, the chain-major
    store keeps that run's records up to the checkpoint, drops the later
    ones, and appends: the same times and records as a run that was not
    interrupted."""
    ref = _simulation("fused", tmp_path / "ref", fmt=tmc.BIN())
    ref.run()
    a = _simulation("fused", tmp_path / "a", backup=True, fmt=tmc.BIN())
    a.run()
    b = _simulation("fused", tmp_path / "a", fmt=tmc.BIN())
    checkpoint.resume_state(
        b, os.path.join(a.path, "checkpoints", f"ckpt_t{BACKUP}.npz"))
    b.run()
    want_t, want = tmc.load_chain_major_trajectories(ref.path)
    got_t, got = tmc.load_chain_major_trajectories(b.path)
    np.testing.assert_array_equal(got_t, want_t)
    assert np.all(np.diff(got_t) == 5) and got_t[0] == 0
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))


def test_restart_text_files_written(tmp_path):
    system = p1d.make_system()
    path = str(tmp_path / "bk")
    sim = tmc.Simulation(system, p1d.init_chains(4, beta=2.0, seed=1), [
        dict(algorithm=tmc.Metropolis, pool=(p1d.displacement_move(0.5),),
             seed=42),
        dict(algorithm=tmc.StoreBackups, scheduler=np.asarray([20, 40]),
             store_first=True),
    ], 40, path=path)
    sim.run()
    x = sim.device_state["sys"].x
    for c in range(1, 5):
        d = os.path.join(path, "trajectories", str(c))
        for t in (0, 20, 40):
            f = os.path.join(d, f"restart_t{t}.dat")
            tt, xc = system.parse_frame(open(f).read().strip())
            assert tt == t
        assert xc == float(x[c - 1])
    ckpts = sorted(glob.glob(os.path.join(path, "checkpoints", "*.npz")))
    assert [os.path.basename(p) for p in ckpts] == [
        "ckpt_t0.npz", "ckpt_t20.npz", "ckpt_t40.npz"]
    last = checkpoint.restore(ckpts[-1], sim.init_device_state())
    _same(sim.device_state, last)
    assert not tmc.StoreBackups.buffered_ok
