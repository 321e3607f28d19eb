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
import subprocess
import sys

import numpy as np
import pytest
import torch

import montecarlo_tpu_torch as tmc
from montecarlo_tpu_torch import checkpoint
from montecarlo_tpu_torch import policy_guided as pg
from montecarlo_tpu_torch.core import simulation
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


def _algorithms(case, backup=False, fmt=None, backup_first=False):
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
    store = []
    if fmt is not None:
        store.append(dict(algorithm=tmc.StoreTrajectories, fmt=fmt,
                          scheduler=tmc.build_schedule(STEPS, 0, 5)))
    if backup:
        store.append(dict(algorithm=tmc.StoreBackups,
                          scheduler=np.asarray([BACKUP])))
    return algos + (store[::-1] if backup_first else store)


def _simulation(case, path, **kw):
    if case == "lj_pgmc":
        system = lj.make_system()
        chains = lj.init_chains(4, 32, 0.7, 1.0, frac_b=0.2, seed=3,
                                device="cpu")
    else:
        system = p1d.make_system()
        chains = p1d.init_chains(16, beta=2.0, seed=1, device="cpu")
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


_KILLED_RUN = """
import os, sys
sys.path.insert(0, {tests!r})
import test_torch_checkpoint as tc
import montecarlo_tpu_torch as tmc

write = tmc.StoreBackups.write

def write_then_die(self, sim, t, value):
    write(self, sim, t, value)
    os._exit(1)          # no finalise, no flush of open files, no atexit

tmc.StoreBackups.write = write_then_die
tc._simulation("fused", {path!r}, backup=True, fmt=tmc.BIN(),
               backup_first={backup_first}).run()
"""


@pytest.mark.parametrize("backup_first", [False, True])
def test_bin_store_survives_a_kill_after_a_backup(tmp_path, backup_first):
    """A run killed hard (``os._exit``) right after its backup, wherever
    the backup stands in the algorithm list, leaves a manifest that lists
    the records up to the checkpoint; resumed in the same directory, the
    store ends with the times and records of the run that was not cut."""
    ref = _simulation("fused", tmp_path / "ref", fmt=tmc.BIN())
    ref.run()
    want_t, want = tmc.load_chain_major_trajectories(ref.path)

    path = str(tmp_path / "a")
    script = _KILLED_RUN.format(tests=os.path.dirname(__file__), path=path,
                                backup_first=backup_first)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1, proc.stderr
    assert not os.path.exists(os.path.join(path, "summary.log")) or \
        "Completed" not in open(os.path.join(path, "summary.log")).read()
    ckpt = os.path.join(path, "checkpoints", f"ckpt_t{BACKUP}.npz")
    assert os.path.exists(ckpt)
    cut_t, cut = tmc.load_chain_major_trajectories(path)
    np.testing.assert_array_equal(cut_t, want_t[want_t <= BACKUP])
    for k in want:
        np.testing.assert_array_equal(np.asarray(cut[k]),
                                      np.asarray(want[k])[:len(cut_t)])
    del cut                                   # memory maps of the store

    b = _simulation("fused", path, fmt=tmc.BIN())
    checkpoint.resume_state(b, ckpt)
    b.run()
    got_t, got = tmc.load_chain_major_trajectories(path)
    np.testing.assert_array_equal(got_t, want_t)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    _same(ref.device_state, b.device_state)


def test_bin_manifest_follows_each_flushed_chunk(tmp_path, monkeypatch):
    """The manifest on disk lists every record of a flushed chunk as soon
    as the chunk is written, long before finalise."""
    monkeypatch.setattr(simulation, "_CHUNK", 4)
    sim = tmc.Simulation(
        p1d.make_system(), p1d.init_chains(16, beta=2.0, seed=1, device="cpu"),
        [dict(algorithm=tmc.Metropolis, pool=(p1d.displacement_move(0.5),),
              seed=42, fused="interpret"),
         dict(algorithm=tmc.StoreTrajectories, fmt=tmc.BIN(),
              scheduler=tmc.build_schedule(STEPS, 0, 5))],
        STEPS, path=str(tmp_path / "m"))
    store = sim.algorithms[-1]
    seen = []
    write_batch = store.write_batch

    def spy(sim_, ts, value):
        write_batch(sim_, ts, value)
        t, fields = tmc.load_chain_major_trajectories(sim.path)
        seen.append((list(t), {k: v.shape[0] for k, v in fields.items()}))

    store.write_batch = spy
    sim.run()
    assert seen, "the run flushed no chunk"
    last = 0
    for times, lengths in seen:
        assert times[-1] > last and times == list(range(0, times[-1] + 1, 5))
        assert set(lengths.values()) == {len(times)}
        last = times[-1]
    assert last == STEPS and len(seen) == 3


def test_bin_resume_refuses_a_store_without_manifest(tmp_path):
    """``.bin`` files without ``index.json`` are not silently overwritten
    by a resumed run."""
    a = _simulation("fused", tmp_path / "a", backup=True, fmt=tmc.BIN())
    a.run()
    os.remove(os.path.join(a.path, "trajectories", "index.json"))
    b = _simulation("fused", tmp_path / "a", fmt=tmc.BIN())
    checkpoint.resume_state(
        b, os.path.join(a.path, "checkpoints", f"ckpt_t{BACKUP}.npz"))
    size = os.path.getsize(os.path.join(a.path, "trajectories", "frame.bin"))
    with pytest.raises(RuntimeError, match="no index.json"):
        b.run()
    assert os.path.getsize(
        os.path.join(a.path, "trajectories", "frame.bin")) == size


def test_bin_resume_in_an_empty_directory_starts_a_store(tmp_path):
    """Resumed elsewhere, the store holds the post-resume records only."""
    a = _simulation("fused", tmp_path / "a", backup=True, fmt=tmc.BIN())
    a.run()
    b = _simulation("fused", tmp_path / "b", fmt=tmc.BIN())
    checkpoint.resume_state(
        b, os.path.join(a.path, "checkpoints", f"ckpt_t{BACKUP}.npz"))
    b.run()
    want_t, want = tmc.load_chain_major_trajectories(a.path)
    got_t, got = tmc.load_chain_major_trajectories(b.path)
    np.testing.assert_array_equal(got_t, want_t[want_t > BACKUP])
    np.testing.assert_array_equal(np.asarray(got["frame"]),
                                  np.asarray(want["frame"])[want_t > BACKUP])


def test_restart_text_files_written(tmp_path):
    system = p1d.make_system()
    path = str(tmp_path / "bk")
    sim = tmc.Simulation(system, p1d.init_chains(4, beta=2.0, seed=1,
                                                 device="cpu"), [
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
