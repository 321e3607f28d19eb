"""The port's chain mesh in one process: ``parallel.shard_device_state``,
``fetch`` and ``replicate``, the four sharded sweep entry points against
the reference's ``shard_map`` wrappers, and a Simulation on a mesh
(``summary.log``, the device check, replicated PGMC parameters, the
profiler trace).

The sharded entry points: the port's, called for every rank r of S = 8 on
that rank's slice and concatenated, against the reference's on the 8
virtual CPU devices of ``tests/conftest.py`` in interpret mode.  Tolerances
are the unsharded tests': the Gaussian sweep's accept counts equal, x and e
within atol 1e-5 (``tests/test_torch_sweep.py``); the LJ and poly sweeps'
counts, species and diameters equal, positions within atol 1e-5 and
energies within rtol 1e-5 (``tests/test_torch_lj_sweep.py``,
``test_torch_poly_sweep.py``).  Every shard starts from the same chains,
so the shard blocks must differ: each rank draws its own stream.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlo_tpu as mc
import montecarlo_tpu_torch as tmc
from montecarlo_tpu.models import lennard_jones as ref_lj
from montecarlo_tpu.models import particle1d as ref_p1d
from montecarlo_tpu.models import polydisperse as ref_poly
from montecarlo_tpu.ops import fused_sweep as ref_fs
from montecarlo_tpu.ops import lj_sweep as ref_ljs
from montecarlo_tpu.ops import poly_sweep as ref_ps
from montecarlo_tpu.parallel import make_mesh as ref_make_mesh
from montecarlo_tpu_torch import interop
from montecarlo_tpu_torch.models import lennard_jones as lj
from montecarlo_tpu_torch.models import particle1d as p1d
from montecarlo_tpu_torch.models import polydisperse as poly
from montecarlo_tpu_torch.ops import fused_sweep, lj_sweep, poly_sweep
from montecarlo_tpu_torch.parallel import (CHAIN_AXIS, Mesh, fetch,
                                           make_mesh, replicate, run_emulated,
                                           shard_device_state)
from montecarlo_tpu_torch.utils.tree import tree_leaves
from torch_mesh_helpers import pgmc_sim, state_arrays

S = 8
ATOL, RTOL = 1e-5, 1e-5


def _rank(r, size=S):
    return Mesh(rank=r, size=size, device=torch.device("cpu"))


def _ref_mesh():
    devices = jax.devices("cpu")
    if len(devices) < S:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    return ref_make_mesh(n_devices=S, devices=devices)


def _tile(a):
    """``a`` repeated for each of the S shards along the chain axis."""
    return np.concatenate([np.asarray(a)] * S)


def _per_shard(fn, *arrays):
    """``fn(rank_mesh, *slices)`` for every rank, outputs concatenated."""
    m = arrays[0].shape[0] // S
    outs = [fn(_rank(r), *(a[r * m:(r + 1) * m] for a in arrays))
            for r in range(S)]
    return [torch.cat(parts).numpy() for parts in zip(*outs)]


def _blocks_differ(a):
    blocks = a.reshape(S, -1)
    assert all(not np.array_equal(blocks[i], blocks[j])
               for i in range(S) for j in range(i + 1, S))


# -- shard_device_state, fetch, replicate -------------------------------------------

def _state(m=8):
    sys = p1d.init_chains(m, beta=2.0, seed=3, device="cpu")
    return {"sys": sys, "t": 5, "params": ({"sigma": torch.tensor(0.5)},),
            "metropolis": {"counters": torch.arange(m * 2).reshape(m, 1, 2)},
            "replica_exchange": {"key": torch.tensor([[0, 5]],
                                                     dtype=torch.uint32)},
            "pge": {"obj": torch.zeros(3)}}


def test_shard_device_state_slices_chain_leaves():
    ds = _state(8)
    mesh = _rank(2, size=4)
    out = shard_device_state(ds, mesh, 8)
    assert mesh.sliced == {("sys", "x"), ("sys", "beta"), ("sys", "e"),
                           ("metropolis", "counters")}
    np.testing.assert_array_equal(out["sys"].x.numpy(), ds["sys"].x[4:6])
    np.testing.assert_array_equal(out["metropolis"]["counters"].numpy(),
                                  ds["metropolis"]["counters"][4:6])
    assert out["t"] == 5 and out["pge"]["obj"] is ds["pge"]["obj"]
    assert out["params"][0]["sigma"] is ds["params"][0]["sigma"]
    assert out["replica_exchange"]["key"] is ds["replica_exchange"]["key"]
    with pytest.raises(ValueError, match="not divisible"):
        shard_device_state(_state(10), _rank(0, size=4), 10)


@pytest.mark.parametrize("size", [1, 2, 4])
def test_fetch_of_sharded_state_is_the_whole_state(size):
    ds = _state(8)

    def rank(mesh):
        whole = fetch(shard_device_state(ds, mesh, 8), mesh)
        return whole, mesh.counts["all_gather"]

    for whole, n_gathers in run_emulated(rank, size, "cpu"):
        assert torch.equal(whole["sys"].x, ds["sys"].x)
        assert torch.equal(whole["metropolis"]["counters"],
                           ds["metropolis"]["counters"])
        assert n_gathers == 4            # the sliced leaves, no other
        assert whole["pge"]["obj"] is ds["pge"]["obj"]


def test_replicate_gives_every_rank_rank_zeros_values():
    out = run_emulated(lambda mesh: replicate(
        {"a": torch.full((3,), float(mesh.rank)), "n": mesh.rank}, mesh),
        3, "cpu")
    for r, tree in enumerate(out):
        assert torch.equal(tree["a"], torch.zeros(3)) and tree["n"] == r


def test_make_mesh_without_a_group_has_one_rank():
    mesh = make_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.group, mesh.axis) == (0, 1, None,
                                                             CHAIN_AXIS)
    assert make_mesh().device == torch.device("cuda", 0)
    x = torch.arange(4.0)
    assert mesh.all_gather(x) is x and mesh.all_reduce(x) is x


# -- the four sharded entry points against the reference's -------------------------

def test_sharded_gaussian_sweep_matches_reference():
    rng = np.random.default_rng(21)
    x = _tile(rng.uniform(-2, 2, 16).astype(np.float32))
    beta = _tile(rng.uniform(0.5, 3, 16).astype(np.float32))
    xr, er, ar = (np.asarray(a) for a in ref_fs.sharded_gaussian_sweep(
        _ref_mesh(), "chains", jnp.asarray(x), jnp.asarray(beta), 0.7, 11,
        3, 101, potential=ref_p1d.harmonic, interpret=True))
    xp, ep, ap = _per_shard(
        lambda mesh, xs, bs: fused_sweep.sharded_gaussian_sweep(
            mesh, "chains", xs, bs, 0.7, 11, 3, 101,
            potential=p1d.harmonic),
        torch.from_numpy(x), torch.from_numpy(beta))
    np.testing.assert_array_equal(ap, ar)
    np.testing.assert_allclose(xp, xr, rtol=0, atol=ATOL)
    np.testing.assert_allclose(ep, er, rtol=0, atol=ATOL)
    _blocks_differ(xp)
    # a rank's call is the unsharded sweep with its folded seed
    xs, _, _ = fused_sweep.fused_gaussian_sweep(
        torch.from_numpy(x[16:32]), torch.from_numpy(beta[16:32]), 0.7,
        fused_sweep._shard_seed(1, 11), 3, 101, potential=p1d.harmonic)
    np.testing.assert_array_equal(xs.numpy(), xp[16:32])
    with pytest.raises(ValueError, match="axis"):
        fused_sweep.sharded_gaussian_sweep(
            _rank(0), "batch", torch.zeros(4), torch.ones(4), 0.5, 1, 0, 1,
            potential=p1d.harmonic)


def _lj_inputs():
    ref = ref_lj.init_chains(2, 24, rho=0.7, beta=1.0, frac_b=0.25, seed=5)
    return {k: _tile(v) for k, v in interop.chains_to_reference(
        interop.chains_from_reference(ref, device="cpu")).items()}


@pytest.mark.parametrize("mixed", [False, True])
def test_sharded_lj_sweeps_match_reference(mixed):
    st = _lj_inputs()
    box = float(st["box"][0])
    names = ("pos", "species", "beta", "energy")
    tail = ((0.7,) if mixed else ()) + (7, 3, 60)
    ref_fn = (ref_ljs.sharded_lj_mixed_sweep if mixed
              else ref_ljs.sharded_lj_sweep)
    want = [np.asarray(a) for a in ref_fn(
        _ref_mesh(), "chains", *(jnp.asarray(st[k]) for k in names), box,
        0.12, *tail, params=ref_lj.LJParams(), interpret=True,
        block_chains=8)]
    fn = lj_sweep.sharded_lj_mixed_sweep if mixed else lj_sweep.sharded_lj_sweep
    got = _per_shard(
        lambda mesh, *a: fn(mesh, "chains", *a, box, 0.12, *tail,
                            params=lj.LJParams(), block_chains=8),
        *(torch.from_numpy(st[k]) for k in names))
    pos, e = got[0], got[-3 if mixed else 1]
    np.testing.assert_allclose(pos, want[0], rtol=0, atol=ATOL)
    np.testing.assert_allclose(e, want[-3 if mixed else 1], rtol=RTOL,
                               atol=0)
    for g, w in zip(got[1:], want[1:]):
        if g.dtype != np.float32:       # species and the counts
            np.testing.assert_array_equal(g, w)
    assert got[-1].sum() > 0
    _blocks_differ(pos)


def test_sharded_poly_sweep_matches_reference():
    ref = ref_poly.init_chains(2, 24, rho=0.9, beta=1.0, seed=5)
    st = {k: _tile(v) for k, v in interop.chains_to_reference(
        interop.chains_from_reference(ref, device="cpu")).items()}
    box = float(st["box"][0])
    names = ("pos", "diam", "beta", "energy")
    want = [np.asarray(a) for a in ref_ps.sharded_poly_mixed_sweep(
        _ref_mesh(), "chains", *(jnp.asarray(st[k]) for k in names), box,
        0.1, 0.7, 7, 3, 60, params=ref_poly.PolyParams(), interpret=True,
        block_chains=8)]
    got = _per_shard(
        lambda mesh, *a: poly_sweep.sharded_poly_mixed_sweep(
            mesh, "chains", *a, box, 0.1, 0.7, 7, 3, 60,
            params=poly.PolyParams(), block_chains=8),
        *(torch.from_numpy(st[k]) for k in names))
    (pos, dia, e, acc, tot), (pos_r, dia_r, e_r, acc_r, tot_r) = got, want
    np.testing.assert_array_equal(dia, dia_r)
    np.testing.assert_array_equal(acc, acc_r)
    np.testing.assert_array_equal(tot, tot_r)
    np.testing.assert_allclose(pos, pos_r, rtol=0, atol=ATOL)
    np.testing.assert_allclose(e, e_r, rtol=RTOL, atol=0)
    assert acc[:, 1].sum() > 0
    _blocks_differ(pos)


# -- a Simulation on a mesh -------------------------------------------------------

def test_mesh_and_device_must_agree(tmp_path):
    chains = p1d.init_chains(4, beta=2.0, device="cpu")
    algos = [dict(algorithm=tmc.Metropolis,
                  pool=(p1d.displacement_move(0.5),))]
    mesh = make_mesh(device="cpu")
    sim = tmc.Simulation(p1d.make_system(), chains, algos, 4,
                         path=str(tmp_path), device="cpu", mesh=mesh)
    assert sim.device == torch.device("cpu") and sim.mesh is mesh
    with pytest.raises(ValueError, match="disagrees"):
        tmc.Simulation(p1d.make_system(), chains, algos, 4,
                       path=str(tmp_path), device="cuda", mesh=mesh)
    with pytest.raises(ValueError, match="not divisible"):
        tmc.Simulation(p1d.make_system(), chains, algos, 4,
                       path=str(tmp_path), mesh=_rank(0, size=3))


@pytest.mark.parametrize("size", [None, 2])
def test_summary_counts_ranks(tmp_path, size):
    """``Devices:`` and ``Parallel:`` count the mesh's ranks (the CPU's one
    device without a mesh); rank 0 alone writes the files."""
    def run(mesh):
        sim = pgmc_sim(str(tmp_path), mesh)
        sim.run()
        return sim

    if size is None:
        run(None)
    else:
        run_emulated(run, size, "cpu")
    summary = (tmp_path / "summary.log").read_text()
    n = size or 1
    assert summary.count(f"\t\tDevices: {n}\n") == 2   # Metropolis, estimator
    assert f"\t\tParallel: {n > 1}\n" in summary
    assert summary.count("SIMULATION SUMMARY") == 1


def test_pgmc_parameters_stay_replicated(tmp_path):
    """With every chain's estimator sums gathered to every rank, every
    rank's update computes the same parameters: no collective in the
    update, and none but the gathers."""
    def run(mesh):
        sim = pgmc_sim(str(tmp_path), mesh)
        sim.run()
        return (float(sim.device_state["params"][1]["sigma"]),
                mesh.counts["all_reduce"], mesh.counts["all_gather"])

    out = run_emulated(run, 4, "cpu")
    sigmas = {s for s, _, _ in out}
    assert len(sigmas) == 1 and sigmas != {0.2}
    # no all_reduce (no cell flag on this path); one all_gather per
    # GradientData field at each of the 20 estimator events, besides those
    # of the recorders' views
    assert {n for _, n, _ in out} == {0}
    gathers = {n for _, _, n in out}
    assert len(gathers) == 1 and gathers.pop() >= 20 * 5


def test_generators_are_seeded_with_the_rank_folded_in(tmp_path):
    """No state holds a generator, on a mesh or without one: the generic
    path's and the estimator's keys are those of the rank's global chains,
    the same on every rank count, and the cell path, which keys each
    segment on its micro-step and folds in its chains' global ids, gives
    each rank its slice of the one-process run bit for bit."""
    def keys(mesh):
        ds = pgmc_sim(str(tmp_path), mesh).init_device_state()
        assert not any(isinstance(leaf, torch.Generator)
                       for leaf in tree_leaves(ds))
        return ds["metropolis"]["keys"], ds["pge"]["keys"]

    whole = keys(None)
    assert whole[0].shape == (16, 2) and whole[0].dtype == torch.uint32
    assert not torch.equal(whole[0], whole[1])
    for size in (1, 2, 4):
        for r, got in enumerate(run_emulated(keys, size, "cpu")):
            m = 16 // size
            for g, w in zip(got, whole):
                assert torch.equal(g, w[r * m:(r + 1) * m])

    chains = lj.init_chains(4, 512, rho=1.2, beta=1.0, seed=21, device="cpu")

    def cell_run(mesh):
        sim = tmc.Simulation(lj.make_system(), chains, [
            dict(algorithm=tmc.Metropolis,
                 pool=(lj.lj_displacement_move(0.08),), seed=42,
                 sweepstep=64, fused="cell")], 3, path=str(tmp_path),
            mesh=mesh)
        assert sim.device_algos[0]._use_cell
        sim.run()
        ds = sim.device_state
        assert not any(isinstance(leaf, torch.Generator)
                       for leaf in tree_leaves(ds))
        return ds["sys"].pos, ds["metropolis"]["counters"]

    one = cell_run(None)
    assert int(one[1][:, 0, 0].min()) > 0
    for size in (1, 2):
        for r, got in enumerate(run_emulated(cell_run, size, "cpu")):
            m = 4 // size
            for g, w in zip(got, one):
                assert torch.equal(g, w[r * m:(r + 1) * m])


@pytest.mark.parametrize("size", [1, 2, 4])
def test_generic_pgmc_run_equals_one_process_on_every_rank_count(tmp_path,
                                                                 size):
    """The generic path with PGMC on an emulated mesh of ``size`` ranks:
    each rank's whole state (positions, energies, counters, keys, sigma,
    the estimator's sums) equals its slice of the one-process run, bit for
    bit, as ``tests/test_sharding.py`` holds the reference."""
    one = pgmc_sim(str(tmp_path / "one"), None)
    one.run()
    whole = state_arrays(one.device_state)

    def run(mesh):
        sim = pgmc_sim(str(tmp_path / f"mesh{size}"), mesh)
        sim.run()
        return state_arrays(sim.device_state)

    m = 16 // size
    for r, got in enumerate(run_emulated(run, size, "cpu")):
        assert sorted(got) == sorted(whole)
        for k, w in whole.items():
            if w.ndim and w.shape[0] == 16:          # a chain leaf
                w = w[r * m:(r + 1) * m]
            np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert float(whole["params/1/sigma"]) != pytest.approx(0.2, abs=1e-4)


def test_profiler_trace_spans_its_first_two_firings(tmp_path):
    chains = p1d.init_chains(16, beta=2.0, device="cpu")
    sim = tmc.Simulation(p1d.make_system(), chains, [
        dict(algorithm=tmc.Metropolis, pool=(p1d.displacement_move(0.5),),
             fused="interpret"),
        dict(algorithm=tmc.ProfilerTrace, scheduler=np.asarray([5, 15])),
    ], 20, path=str(tmp_path))
    sim.run()
    assert os.listdir(tmp_path / "trace") == ["trace_t15.json"]
    events = json.load(open(tmp_path / "trace" / "trace_t15.json"))
    assert events["traceEvents"]


def test_parallel_exports_follow_reference():
    from montecarlo_tpu import parallel as ref_parallel
    assert tmc.parallel.__all__ == ref_parallel.__all__
    for name in ("fetch", "initialize", "is_io_host", "process_count",
                 "global_mesh", "make_mesh", "shard_device_state",
                 "replicate", "CHAIN_AXIS"):
        assert hasattr(tmc.parallel, name)
    assert "ProfilerTrace" in tmc.__all__ and "parallel" in tmc.__all__
    assert set(tmc.__all__) - {"interop"} <= set(mc.__all__)
    assert tmc.parallel.process_count() == 1 and tmc.parallel.is_io_host()
