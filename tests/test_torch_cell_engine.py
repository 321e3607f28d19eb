"""The checkerboard cell-MC path through the engine: ``Metropolis(fused=
'cell' | 'auto')`` in ``Simulation.run``, on the CPU.

Held to the JAX package value for value: the substep counts a ``Metropolis``
runs per segment (its float32 ``cell_debt`` arithmetic over a fine-stride
schedule) and ``summary.log``'s ``Cell MC:`` line.  Then the reference's
engine gates (``tests/test_cell_mc.py``) on the port's stream: counters
within one substep of the requested attempts, the cache after a refresh,
the mixed pool, PGMC through the hybrid stepper, the misuse errors, the
invalid-bind flag surfaced as an error or, under ``'auto'``, as a fallback
with a ``RuntimeWarning`` that loses no record; a 0-d box; and a run cut by
``StoreBackups`` and resumed, equal to the uncut run bit for bit.
"""

import dataclasses
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlo_tpu as mc
import montecarlo_tpu_torch as tmc
from montecarlo_tpu.models import lennard_jones as ref_lj
from montecarlo_tpu_torch import checkpoint, interop
from montecarlo_tpu_torch import policy_guided as pg
from montecarlo_tpu_torch.core import metropolis
from montecarlo_tpu_torch.core.simulation import _select_advance
from montecarlo_tpu_torch.models import lennard_jones as lj
from montecarlo_tpu_torch.ops import cell_mc
from torch_cell_helpers import assert_same_state, segment_lengths

PARAMS = lj.LJParams()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test runner runs several files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lj_sim(path, chains, steps, pool=None, recorders=(), **met):
    pool = pool or (lj.lj_displacement_move(0.1),)
    algos = [dict(algorithm=tmc.Metropolis, pool=pool,
                  **{"seed": 1, "sweepstep": 64, **met})]
    return tmc.Simulation(lj.make_system(), chains, algos + list(recorders),
                          steps, path=str(path))


@pytest.fixture(scope="module")
def engine_cell_run(tmp_path_factory):
    path = tmp_path_factory.mktemp("cellmc")
    n, m, steps = 512, 8, 40
    chains = lj.init_chains(m, n, rho=1.0, beta=1.0, frac_b=0.2, seed=6,
                            device="cpu")
    sim = _lj_sim(path, chains, steps, fused="cell", recorders=[
        dict(algorithm=tmc.StoreCallbacks,
             callbacks=(lj.callback_energy_per_particle,),
             scheduler=np.arange(10, steps + 1, 10))])
    sim.run()
    return sim, str(path), steps


def test_engine_cell_path(engine_cell_run):
    sim, path, steps = engine_cell_run
    met = sim.device_algos[0]
    assert met._use_cell and met.supports_fused
    assert "Cell MC: enabled (CellGrid(" in open(
        os.path.join(path, "summary.log")).read()
    slc = sim.device_state["metropolis"]
    assert not bool(slc["cell_overflow"])
    cnt = slc["counters"].numpy()
    # the fractional-substep debt keeps the attempts within one substep of
    # the requested count
    want = steps * 64
    per = met._cell_plan.nc ** 2 // 4
    assert np.all(cnt[:, 0, 1] >= want - per)
    assert np.all(cnt[:, 0, 1] <= want + per)
    assert np.all(cnt[:, 0, 0] > 0)
    e = np.loadtxt(os.path.join(path, "energy_per_particle.dat"))
    assert e.shape == (5, 2) and np.all(np.isfinite(e[:, 1]))


def test_engine_cell_energy_consistent(engine_cell_run):
    sim, _, _ = engine_cell_run
    st = sim.device_state["sys"]
    # the refresh revalidated the cache at the last observation point
    np.testing.assert_allclose(st.energy.numpy(),
                               lj.total_energy(st, PARAMS).numpy(),
                               rtol=1e-5, atol=1e-2)


def test_engine_cell_mixed_pool(tmp_path):
    """The species pool: counters split by kind, composition conserved,
    the cache exact."""
    chains = lj.init_chains(4, 512, rho=1.2, beta=1.0 / 0.45, frac_b=0.2,
                            seed=13, device="cpu")
    pool = (lj.lj_displacement_move(0.08, weight=0.7),
            lj.lj_swap_move(weight=0.3))
    sim = _lj_sim(tmp_path, chains, 24, pool=pool, seed=3, fused="cell")
    met = sim.device_algos[0]
    assert met._use_cell and met.supports_fused
    assert met._cell_model.model.swap_mode == "species"
    sim.run()
    slc = sim.device_state["metropolis"]
    assert not bool(slc["cell_overflow"])
    cnt = slc["counters"].numpy()
    assert np.all(cnt[:, :, 1] > 0) and np.all(cnt[:, 1, 0] > 0)
    st = sim.device_state["sys"]
    assert st.species.dtype == torch.int32
    np.testing.assert_array_equal(st.species.sum(1).numpy(),
                                  chains.species.sum(1).numpy())
    np.testing.assert_allclose(st.energy.numpy(),
                               lj.total_energy(st, PARAMS).numpy(),
                               rtol=1e-5, atol=1e-2)


def test_pgmc_composes_with_cell_path(tmp_path):
    """The hybrid stepper runs cell segments between the estimator's and
    the update's events, and VPG grows a too-small width."""
    steps = 24
    chains = lj.init_chains(8, 512, rho=1.0, beta=1.0, frac_b=0.2, seed=15,
                            device="cpu")
    sim = _lj_sim(tmp_path, chains, steps,
                  pool=(lj.lj_displacement_move(0.05),), seed=2,
                  sweepstep=32, fused="cell", recorders=[
                      dict(algorithm=pg.PolicyGradientEstimator,
                           dependencies=(tmc.Metropolis,),
                           optimisers=(pg.VPG(0.02),), q_batch_size=1,
                           scheduler=np.arange(4, steps + 1, 4)),
                      dict(algorithm=pg.PolicyGradientUpdate,
                           dependencies=(pg.PolicyGradientEstimator,),
                           scheduler=np.arange(8, steps + 1, 8))])
    assert "hybrid" in _select_advance(sim).__qualname__
    assert sim.device_algos[0]._use_cell
    sim.run()
    assert float(sim.device_state["params"][0]["sigma"]) > 0.05 * 1.01
    assert not bool(sim.device_state["metropolis"]["cell_overflow"])


def test_fused_cell_unplannable_raises(tmp_path):
    st = lj.init_chains(4, 32, rho=1.0, beta=1.0, seed=30, device="cpu")
    with pytest.raises(ValueError, match="fused='cell'.*too small"):
        _lj_sim(tmp_path, st, 4, fused="cell")


def test_fused_cell_3d_and_volume_pools_plan(tmp_path):
    """A 3-D state and a pool with a volume move plan on the cell path (the
    3-D grid, and the NPT headroom ``box_margin`` 0.15 by default), as in
    the reference; ``cell_opts`` takes ``box_margin`` and still raises on
    any other unknown key."""
    st3 = lj.init_chains(2, 1372, rho=0.5, beta=1.0, seed=30, device="cpu",
                         dim=3)
    met = _lj_sim(tmp_path, st3, 4, fused="cell").device_algos[0]
    assert met._use_cell and met._cell_plan.dim == 3
    assert met._cell_plan.nc == 4 and met._cell_model.vol is None
    st = lj.init_chains(2, 512, rho=1.0, beta=1.0, seed=30, device="cpu")
    pool = (lj.lj_displacement_move(0.1, weight=0.9),
            lj.lj_volume_move(0.01, pressure=2.0, weight=0.1))
    met = _lj_sim(tmp_path, st, 4, pool=pool, fused="cell").device_algos[0]
    box = float(st.box[0])
    plan0 = cell_mc.plan_grid(512, box, 2.5, box_margin=0.15)
    occ = metropolis._max_cell_occupancy(st, plan0.nc, 2)
    occ = int(np.ceil(occ * (box / plan0.box_min) ** 2))
    assert met._cell_plan == cell_mc.plan_grid(
        512, box, 2.5, box_margin=0.15, max_occupancy=occ)
    assert met._cell_model.vol == 1 and met._cell_model.pressure == 2.0
    met = _lj_sim(tmp_path, st, 4, pool=pool, fused="cell",
                  cell_opts={"box_margin": 0.0}).device_algos[0]
    assert met._cell_plan.nc == cell_mc.plan_grid(512, box, 2.5).nc
    with pytest.raises(ValueError, match="cell_opts takes 'd_cap', "
                                         "'cap_slack' and 'box_margin'"):
        _lj_sim(tmp_path, st, 4, fused="cell", cell_opts={"halo": 0.1})
    # a volume move on another interaction table has no shared geometry
    other = lj.lj_volume_move(0.01, 2.0, params=lj.LJParams(rcut=2.0))
    with pytest.raises(ValueError, match="volume move carries a different"):
        _lj_sim(tmp_path, st, 4, pool=(pool[0], other), fused="cell")


def test_cell_opts_tune_the_plan(tmp_path):
    st = lj.init_chains(2, 512, rho=1.0, beta=1.0, seed=30, device="cpu")
    met = _lj_sim(tmp_path, st, 4, fused="cell",
                  cell_opts={"d_cap": 0.3, "cap_slack": 4.0}).device_algos[0]
    box = float(st.box[0])
    occ = metropolis._max_cell_occupancy(st, met._cell_plan.nc, 2)
    assert met._cell_plan == cell_mc.plan_grid(
        512, box, 2.5, d_cap=0.3, cap_slack=4.0, max_occupancy=occ)


def test_zero_d_box_plans_and_runs(tmp_path):
    """One box edge for every chain, as a 0-d tensor: the planner ravels it
    (the reference's raises IndexError there) and the segments broadcast
    it."""
    st = lj.init_chains(2, 512, rho=1.0, beta=1.0, seed=30, device="cpu")
    st0 = dataclasses.replace(st, box=st.box[0].clone())
    assert st0.box.dim() == 0
    sim = _lj_sim(tmp_path, st0, 4, fused="cell")
    # the LJ model's O(N^2) refresh takes per-chain boxes: run without it
    sim.system = dataclasses.replace(sim.system, refresh=None)
    met = sim.device_algos[0]
    assert met._use_cell
    assert met._cell_plan == _lj_sim(tmp_path, st, 4,
                                     fused="cell").device_algos[0]._cell_plan
    sim.run()
    out = sim.device_state["sys"]
    assert out.box.dim() == 0
    assert bool((out.pos >= 0).all()) and bool((out.pos < out.box).all())
    assert int(sim.device_state["metropolis"]["counters"][:, 0, 1].min()) > 0


def test_engine_surfaces_invalid_bind(tmp_path):
    """An explicit fused='cell' run whose bind overflows raises."""
    st = lj.init_chains(2, 512, rho=1.2, beta=1.0 / 0.45, seed=32,
                        device="cpu")
    sim = _lj_sim(tmp_path, st, 8, pool=(lj.lj_displacement_move(0.08),),
                  sweepstep=16, fused="cell")
    met = sim.device_algos[0]
    plan = met._cell_plan
    met._cell_plan = cell_mc.CellGrid(nc=plan.nc, cap=8, box=plan.box,
                                      d_cap=plan.d_cap, rcut=plan.rcut)
    with pytest.raises(RuntimeError, match="invalid"):
        sim.run()


def test_auto_cell_falls_back_on_overflow(tmp_path):
    """An auto-selected cell path that overflows mid-run falls back to the
    generic path with a warning, and the run records every event."""
    n, m, steps = metropolis.CELL_AUTO_MIN_N, 2, 8
    st = lj.init_chains(m, n, rho=1.0, beta=1.0, seed=33, device="cpu")
    sim = _lj_sim(tmp_path, st, steps, pool=(lj.lj_displacement_move(0.08),),
                  sweepstep=4, recorders=[
                      dict(algorithm=tmc.StoreCallbacks,
                           callbacks=(lj.callback_energy_per_particle,),
                           scheduler=np.arange(1, steps + 1))])
    met = sim.device_algos[0]
    assert met.fused == "auto" and met._use_cell
    plan = met._cell_plan
    met._cell_plan = cell_mc.CellGrid(nc=plan.nc, cap=8, box=plan.box,
                                      d_cap=plan.d_cap, rcut=plan.rcut)
    with pytest.warns(RuntimeWarning, match="falling back"):
        sim.run()
    assert met._cell_disabled and not met._use_cell
    e = np.loadtxt(os.path.join(sim.path, "energy_per_particle.dat"))
    assert e.shape[0] == steps + 1          # store_first + every step
    np.testing.assert_array_equal(e[:, 0], np.arange(steps + 1))
    slc = sim.device_state["metropolis"]
    assert not bool(slc["cell_overflow"])
    assert np.all(slc["counters"][:, 0, 1].numpy() == steps * 4)


@pytest.mark.parametrize("pool_kind", ["displacement", "mixed"])
def test_substeps_per_segment_match_reference(monkeypatch, tmp_path,
                                              pool_kind):
    """Over a fine-stride schedule the port's Metropolis runs the substep
    counts the reference's float32 ``cell_debt`` arithmetic gives, and ends
    with the same debt."""
    from montecarlo_tpu.ops import cell_mc as ref_cell
    ref_chains = ref_lj.init_chains(2, 512, 1.2, 1.0 / 0.45, frac_b=0.2,
                                    seed=3)

    def pool(mod):
        if pool_kind == "displacement":
            return (mod.lj_displacement_move(0.08),)
        return (mod.lj_displacement_move(0.08, weight=0.7),
                mod.lj_swap_move(weight=0.3))

    counts = {"ref": [], "port": []}
    # n_substeps: the reference's tenth argument, the port's ninth
    for name, mod, at in (("ref", ref_cell, 9), ("port", cell_mc, 8)):
        orig = mod.cell_mc_segment

        def spy(*args, _orig=orig, _name=name, _at=at, **kw):
            counts[_name].append(int(args[_at]))
            return _orig(*args, **kw)

        monkeypatch.setattr(mod, "cell_mc_segment", spy)
    lengths = segment_lengths(40)
    ref_sim = mc.Simulation(ref_lj.make_system(), ref_chains, [
        dict(algorithm=mc.Metropolis, pool=pool(ref_lj), seed=4,
             sweepstep=7, fused="cell")], 40, path=str(tmp_path / "ref"))
    sim = _lj_sim(tmp_path / "port",
                  interop.chains_from_reference(ref_chains, device="cpu"),
                  40, pool=pool(lj), seed=4, sweepstep=7, fused="cell")
    ref_met, met = ref_sim.device_algos[0], sim.device_algos[0]
    ref_ds, ds = ref_sim.init_device_state(), sim.init_device_state()
    for n in lengths:
        ref_ds = ref_met.fused_advance(ref_ds, jnp.asarray(n, jnp.int32))
        ds = met.fused_advance(ds, n)
    assert counts["port"] == counts["ref"] and len(counts["ref"]) == \
        len(lengths)
    assert 0 in counts["ref"] and max(counts["ref"]) > 0
    assert ds["metropolis"]["cell_debt"].numpy() == np.asarray(
        ref_ds["metropolis"]["cell_debt"])


def _cell_line(summary):
    return [ln for ln in summary.splitlines()
            if ln.startswith("\t\tCell MC: ")]


@pytest.mark.parametrize("case", ["enabled", "unplannable", "auto"])
def test_summary_cell_line_matches_reference(tmp_path, case):
    """``summary.log``'s ``Cell MC:`` line for the same pool and chains."""
    n = {"enabled": 512, "unplannable": 32, "auto": 2048}[case]
    fused = "cell" if case == "enabled" else "auto"
    ref_chains = ref_lj.init_chains(2, n, 1.0, 1.0, frac_b=0.2, seed=3)
    lines = []
    for pkg, mod, chains in (
            (mc, ref_lj, ref_chains),
            (tmc, lj, interop.chains_from_reference(ref_chains,
                                                    device="cpu"))):
        sim = pkg.Simulation(mod.make_system(), chains, [
            dict(algorithm=pkg.Metropolis,
                 pool=(mod.lj_displacement_move(0.1),), fused=fused)], 4,
            path=str(tmp_path / pkg.__name__))
        buf = io.StringIO()
        sim.device_algos[0].write_summary(buf, sim.schedulers[0])
        lines.append(_cell_line(buf.getvalue()))
    assert lines[1] == lines[0] and len(lines[0]) == 1
    assert ("unavailable — box" in lines[0][0]) == (case == "unplannable")
    assert ("enabled (CellGrid(" in lines[0][0]) == (case != "unplannable")


def test_auto_leaves_row_kernel_pools_to_the_kernel(tmp_path):
    """Under 'auto', on the card, a pool that a row kernel takes stays with
    the kernel at N >= 2048 (the port's divergence, with its reason in
    ``summary.log``); a pool no kernel takes (hard disks) and any pool on
    the CPU take the cell path there, as in the reference."""
    from montecarlo_tpu_torch.models import hard_disks as hd
    st = lj.init_chains(2, 2048, rho=1.0, beta=1.0, seed=3, device="cpu")
    met = _lj_sim(tmp_path, st, 4, fused="auto").device_algos[0]
    assert met._use_cell and met.supports_fused     # on the CPU
    met.device = torch.device("cuda")               # as the card sees it
    assert not met._use_cell and met.supports_fused
    buf = io.StringIO()
    met.write_summary(buf, np.arange(1, 5))
    assert _cell_line(buf.getvalue()) == [
        f"\t\tCell MC: off — a row kernel takes this pool at N 2048, where "
        f"it was faster than the cell path on the H100; fused='cell' forces "
        f"{met._cell_plan!r}"]
    disks = hd.init_chains(2, 2048, eta=0.6, seed=3, device="cpu")
    hd_met = tmc.Simulation(hd.make_system(), disks, [
        dict(algorithm=tmc.Metropolis, pool=(hd.displacement_move(0.1),))],
        4, path=str(tmp_path / "hd")).device_algos[0]
    hd_met.device = torch.device("cuda")
    assert hd_met._use_cell and hd_met.supports_fused
    small = lj.init_chains(2, 512, rho=1.0, beta=1.0, seed=3, device="cpu")
    assert not _lj_sim(tmp_path, small, 4).device_algos[0]._use_cell


def test_cell_run_resumed_equals_uncut(tmp_path):
    """A cell-path run (the species pool, so the variant stream, the
    chains' keys, the debt and the flag all matter) cut by a backup and
    resumed in a fresh Simulation ends bit-equal to the uncut run."""
    steps, backup = 12, 5
    chains = lj.init_chains(2, 512, rho=1.2, beta=1.0 / 0.45, frac_b=0.2,
                            seed=21, device="cpu")
    pool = (lj.lj_displacement_move(0.08, weight=0.7),
            lj.lj_swap_move(weight=0.3))

    def build(path, backups=False):
        recs = [dict(algorithm=tmc.StoreCallbacks,
                     callbacks=(lj.callback_energy_per_particle,
                                tmc.callback_acceptance),
                     scheduler=np.arange(1, steps + 1))]
        if backups:
            recs.append(dict(algorithm=tmc.StoreBackups,
                             scheduler=np.asarray([backup])))
        return _lj_sim(path, chains, steps, pool=pool, sweepstep=13,
                       fused="cell", recorders=recs)

    whole = build(tmp_path / "whole")
    whole.run()
    cut = build(tmp_path / "cut", backups=True)
    cut.run()
    ckpt = os.path.join(cut.path, "checkpoints", f"ckpt_t{backup}.npz")
    resumed = build(tmp_path / "resumed")
    checkpoint.resume_state(resumed, ckpt)
    assert resumed.t == backup
    assert "cell_debt" in resumed.device_state["metropolis"]
    resumed.run()
    assert_same_state(whole.device_state, resumed.device_state)
    got = np.loadtxt(os.path.join(resumed.path, "energy_per_particle.dat"))
    want = np.loadtxt(os.path.join(whole.path, "energy_per_particle.dat"))
    np.testing.assert_array_equal(got, want[want[:, 0] > backup])
