"""The port's chain mesh across two processes (a ``gloo`` group on the CPU),
mirroring ``tests/test_multihost.py``.

Two workers (``_torch_mesh_worker.py``) run every scenario once, in one
spawn; each test reads what its scenario left:

1. the reference's multihost configuration against the JAX package's own
   2-device mesh run (``fused='interpret'`` both; its shards draw from the
   same folded seeds): ``energy.dat`` and every ``trajectory.dat`` within
   the Gaussian gate (atol 1e-5), one writer of every file;
2. the generic path with PGMC against a one-process emulation
   (``parallel.run_emulated``) and against one process without a mesh:
   every chain draws from its own key and the estimator adds every
   chain's sums in one order, so each rank's chains, sigma and sums equal
   both bit for bit, and sigma moved;
3. an LJ swap pool and a poly swap pool on the fused path: caches against
   an O(N^2) recompute within the reference's bounds;
4. a cell-path pool: the same plan on both ranks, and an overflow on one
   rank sends both to the fallback;
5. a run resumed from its backup equals the uncut one bit for bit, each
   rank's slice of the keys restored; the state holds no generator, so the
   two-rank checkpoint resumes on one rank too and equals the uncut run;
6. replica exchange with a ladder straddling the ranks' boundary: with
   the generic path's moves each rank equals the emulation's rank, and
   alone (its swaps the only randomness) equals one process;
7. a lattice driver (2-D Ising Wolff), event-chain MC (the LJ hook) and
   the cell path, each with a backup at step 4 (the cell path keys a
   segment on its first micro-step, so every run here is cut into the same
   segments): every chain draws from its global chain's keys, so the two
   ranks' gathered state equals one process's, and the checkpoint the two
   ranks wrote resumes in one process equal to the uncut run.  Bit for
   bit, but for ECMC's floats, held within 1e-5 (its counts exactly): the
   LJ hook's float ops over a rank's (2, N) tensors do not round all alike
   with one process's (4, N) ones on the CPU (a threads-emulated mesh
   shows the same), which moves a position by an ulp.

Each worker has its own timeout, so a rank left waiting in a collective
fails the tests instead of hanging them.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import montecarlo_tpu as mc
from montecarlo_tpu.models import particle1d as ref_p1d
from montecarlo_tpu.parallel import make_mesh as ref_make_mesh
from montecarlo_tpu_torch import checkpoint
from montecarlo_tpu_torch.models import lennard_jones as lj
from montecarlo_tpu_torch.models import polydisperse as poly
from montecarlo_tpu_torch.parallel import make_mesh, run_emulated
from torch_mesh_helpers import (PGMC_STEPS, REF_STEPS, SAMPLER_BACKUP,
                                SAMPLER_STEPS, TEMPERING_STEPS, pgmc_sim,
                                reference_algorithms, sampler_sim,
                                state_arrays,
                                tempering_sim)

WORKER = os.path.join(os.path.dirname(__file__), "_torch_mesh_worker.py")
ATOL = 1e-5            # the Gaussian gate of tests/test_torch_sweep.py
TIMEOUT = 240


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Spawn the two ranks, and meanwhile run the reference's 2-device
    mesh in this process; returns (worker root, reference run dir)."""
    root = tmp_path_factory.mktemp("mesh")
    ref_chains = ref_p1d.init_chains(8, beta=2.0, seed=42)
    np.savez(root / "ref_chains.npz", x=np.asarray(ref_chains.x),
             beta=np.asarray(ref_chains.beta), e=np.asarray(ref_chains.e))
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS", "XLA_FLAGS")}
    env["OMP_NUM_THREADS"] = "1"
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-u", WORKER, str(r), "2", str(port), str(root)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    try:
        ref_path = str(root / "ref")
        mesh = ref_make_mesh(n_devices=2, devices=jax.devices("cpu"))
        mc.Simulation(ref_p1d.make_system(ref_p1d.harmonic), ref_chains,
                      reference_algorithms(mc, ref_p1d, fused="interpret"),
                      REF_STEPS, path=ref_path, mesh=mesh).run()
        outs = [p.communicate(timeout=TIMEOUT)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return root, ref_path


def _result(root, rank, name):
    return root / "results" / f"rank{rank}" / name


def test_two_ranks_match_reference_mesh(runs):
    root, ref = runs
    port = root / "runs" / "reference"
    for name in ("energy.dat", "acceptance.dat"):
        got, want = np.loadtxt(port / name), np.loadtxt(os.path.join(ref,
                                                                      name))
        assert got.shape == want.shape == (REF_STEPS // 10 + 1, 2)
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=0, atol=ATOL)
    for c in range(1, 9):
        rel = os.path.join("trajectories", str(c), "trajectory.dat")
        got, want = np.loadtxt(port / rel), np.loadtxt(os.path.join(ref, rel))
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=0, atol=ATOL)
    # one writer: one line per event, as the reference's
    params = (port / "parameters" / "1" / "parameters.dat").read_text()
    assert len(params.splitlines()) == REF_STEPS // 10 + 1
    assert params == open(os.path.join(ref, "parameters", "1",
                                       "parameters.dat")).read()
    th = np.loadtxt(port / "throughput.dat", ndmin=2)
    assert 1 <= th.shape[0] <= REF_STEPS // 10 and np.all(th[:, 1] > 0)
    ckpt = port / "checkpoints" / "ckpt_t30.npz"
    assert sorted(os.listdir(port / "checkpoints")) == ["ckpt_t30.npz"]
    with np.load(ckpt) as f:
        assert int(f["__mesh_size__"]) == 2
    summary = (port / "summary.log").read_text()
    assert "\t\tDevices: 2\n" in summary and "\t\tParallel: True\n" in summary
    # the profiler trace of steps 20-40, by rank 0 alone
    assert os.listdir(port / "trace") == ["trace_t40.json"]
    assert json.load(open(port / "trace" / "trace_t40.json"))["traceEvents"]
    with np.load(_result(root, 1, "violations.npz")) as f:
        assert f["paths"].tolist() == []


def test_pgmc_sums_are_all_reduced(runs, tmp_path):
    """Both ranks end with the same sigma and sums; each rank's state
    equals the emulated rank's and its slice of one process's run, bit for
    bit."""
    root, _ = runs

    def emulate(mesh):
        sim = pgmc_sim(str(tmp_path / "emul"), mesh)
        sim.run()
        return state_arrays(sim.device_state)

    emulated = run_emulated(emulate, 2, "cpu")
    one = pgmc_sim(str(tmp_path / "one"), None)
    one.run()
    whole = state_arrays(one.device_state)
    sigmas = []
    for r in range(2):
        with np.load(_result(root, r, "pgmc.npz")) as f:
            got = dict(f)
        want = emulated[r]
        assert sorted(got) == sorted(want) == sorted(whole)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            w = whole[k]
            if w.ndim and w.shape[0] == 16:          # a chain leaf
                w = w[8 * r:8 * (r + 1)]
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        assert got["sys/x"].shape == (8,)
        sigmas.append(float(got["params/1/sigma"]))
    assert sigmas[0] == sigmas[1] != pytest.approx(0.2, abs=1e-4)
    last = (root / "runs" / "pgmc" / "parameters" / "2" / "parameters.dat") \
        .read_text().splitlines()
    assert len(last) == PGMC_STEPS // 10 + 1
    assert float(last[-1].split()[1].strip("[]")) == pytest.approx(
        sigmas[0], rel=1e-6)


@pytest.mark.parametrize("name, mod, bounds", [
    ("lj", lj, dict(rtol=3e-4, atol=5e-2)),
    ("poly", poly, dict(rtol=3e-3, atol=8e-2))])
def test_particle_pools_keep_their_caches(runs, name, mod, bounds):
    root, _ = runs
    with np.load(_result(root, 0, f"{name}.npz")) as f:
        st = {k.split("/", 1)[1]: torch.as_tensor(v) for k, v in f.items()
              if k.startswith("sys/")}
        counters = f["metropolis/counters"]
    state = (lj.LJState if name == "lj" else poly.PolyState)(**st)
    assert state.pos.shape == (4, 32, 2)
    full = mod.total_energy(state, mod.LJParams() if name == "lj"
                            else mod.PolyParams())
    np.testing.assert_allclose(state.energy.numpy(), full.numpy(), **bounds)
    assert np.all(counters[..., 1].sum(axis=1) == 8 * 32)
    assert 0 < counters[..., 0].sum() < counters[..., 1].sum()
    e = np.loadtxt(root / "runs" / name / "energy_per_particle.dat")
    assert e.shape == (5, 2)
    assert len(os.listdir(root / "runs" / name / "trajectories")) == 4


def test_cell_path_plans_once_and_falls_back_together(runs):
    root, _ = runs
    res = [json.load(open(_result(root, r, "cell.json"))) for r in range(2)]
    assert res[0]["plan"] == res[1]["plan"] != "None"
    for r in res:
        assert r["use_cell"] and not r["overflow"]
        # rank 1 alone flagged an overflow; both fell back and finished
        assert r["fell_back"] and r["warned"] and r["t"] == 4
        assert r["attempts"] == [16]


def test_resumed_two_rank_run_equals_uncut(runs, tmp_path):
    root, _ = runs
    with np.load(_result(root, 0, "resume_uncut.npz")) as a, \
            np.load(_result(root, 0, "resume_resumed.npz")) as b:
        assert sorted(a) == sorted(b)
        assert a["sys/x"].shape == (16,)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for r in range(2):
        with np.load(_result(root, r, "resume_keys.npz")) as f:
            assert f["equal"].all() and int(f["rows"]) == 8
    ckpt = str(root / "runs" / "uncut" / "checkpoints" / "ckpt_t20.npz")
    with np.load(_result(root, 0, "resume_uncut.npz")) as f:
        uncut = dict(f)
    for i, mesh in enumerate((None, make_mesh(device="cpu"))):
        sim = pgmc_sim(str(tmp_path / f"one{i}"), mesh)
        checkpoint.resume_state(sim, ckpt)
        assert sim.t == 20
        sim.run()
        got = state_arrays(sim.device_state)
        assert sorted(got) == sorted(uncut)
        for k in got:
            np.testing.assert_array_equal(got[k], uncut[k], err_msg=k)


def test_replica_exchange_across_the_ranks(runs, tmp_path):
    root, _ = runs

    def emulate(mesh):
        sim = tempering_sim(str(tmp_path / "emul"), mesh)
        sim.run()
        return state_arrays(sim.device_state)

    emulated = run_emulated(emulate, 2, "cpu")
    for r in range(2):
        with np.load(_result(root, r, "tempering.npz")) as f:
            got = dict(f)
        assert sorted(got) == sorted(emulated[r])
        for k in got:
            np.testing.assert_array_equal(got[k], emulated[r][k], err_msg=k)
        assert got["sys/x"].shape == (6,)
        assert int(got["replica_exchange/calls"]) == TEMPERING_STEPS // 3
    assert int(got["replica_exchange/counters"][:, 0].sum()) > 0
    one = tempering_sim(str(tmp_path / "one"), None, metropolis=False)
    one.run()
    want = state_arrays(one.device_state)
    with np.load(_result(root, 0, "swaps_whole.npz")) as f:
        for k in ("sys/x", "sys/e", "sys/beta", "replica_exchange/counters"):
            np.testing.assert_array_equal(f[k], want[k], err_msg=k)
    rate = np.loadtxt(root / "runs" / "tempering" / "swap_rate.dat")
    assert rate.shape == (TEMPERING_STEPS // 3 + 1, 2)


@pytest.fixture(scope="module")
def one_process_samplers(tmp_path_factory):
    """Each sampler's uncut one-process final state, by name."""
    root = tmp_path_factory.mktemp("samplers")
    out = {}
    for name in ("lattice", "ecmc", "cell"):
        sim = sampler_sim(name, str(root / name), None,
                          backups=[SAMPLER_BACKUP])
        sim.run()
        out[name] = state_arrays(sim.device_state)
    return out


def _same_arrays(got, want, name):
    assert sorted(got) == sorted(want)
    for k in want:
        if name == "ecmc" and np.issubdtype(want[k].dtype, np.floating):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", ["lattice", "ecmc", "cell"])
def test_two_ranks_equal_one_process(runs, one_process_samplers, name):
    root, _ = runs
    with np.load(_result(root, 0, f"sampler_{name}.npz")) as f:
        got = dict(f)
    want = one_process_samplers[name]
    _same_arrays(got, want, name)
    assert got["sys/pos" if name != "lattice" else "sys/spins"].shape[0] == 4


@pytest.mark.parametrize("name", ["lattice", "ecmc", "cell"])
def test_two_rank_checkpoint_resumes_in_one_process(runs,
                                                    one_process_samplers,
                                                    name, tmp_path):
    root, _ = runs
    ckpt = str(root / "runs" / f"sampler_{name}" / "checkpoints"
               / f"ckpt_t{SAMPLER_BACKUP}.npz")
    sim = sampler_sim(name, str(tmp_path / name), None)
    checkpoint.resume_state(sim, ckpt)
    assert sim.t == SAMPLER_BACKUP < SAMPLER_STEPS
    sim.run()
    _same_arrays(state_arrays(sim.device_state), one_process_samplers[name],
                 name)
