"""The cell-MC path in 3-D and with volume substeps (NPT): the port's
``ops/cell_mc.py`` and ``Metropolis`` against the JAX package's.

Held value for value, fed the reference's own ``jax.random`` draws
(``torch_cell_helpers.ReferenceDraws``): the volume substep (2-D poly, 3-D
hard spheres), a whole 3-D segment whose substeps visit every displacement
and swap color, and an NPT stretch that starts at ``box == grid.box_min``
(all three kinds of substep), where the port's
box-invariant halo (``d_cap / box_min``) and the reference's (``d_cap /
box``) coincide; positions within 1e-5, boxes within 1e-6 relative (the
rescale's ``exp``), energies within rtol 1e-5, counters, attributes and
flags exactly.  Then the substep counts ``Metropolis`` runs per segment and
``summary.log``'s ``Cell MC:`` line for NPT and 3-D pools, equal to the
reference's; and by property or statistics on the port's stream: the
fractional halo does not move with the box, the cell path's NPT density
equals the generic path's (``tests/test_cell_mc.py:541``, reduced), hard
spheres stay overlap-free, and an NPT run cut by a backup resumes
bit-equal.
"""

import dataclasses
import functools
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlo_tpu as mc
import montecarlo_tpu_torch as tmc
from montecarlo_tpu.models import hard_disks as ref_hd
from montecarlo_tpu.models import lennard_jones as ref_lj
from montecarlo_tpu.models import polydisperse as ref_poly
from montecarlo_tpu.ops import cell_mc as ref_cell
from montecarlo_tpu_torch import checkpoint, interop
from montecarlo_tpu_torch.models import hard_disks as hd
from montecarlo_tpu_torch.models import lennard_jones as lj
from montecarlo_tpu_torch.models import polydisperse as poly
from montecarlo_tpu_torch.ops import cell_mc
from torch_cell_helpers import (ReferenceDraws, T, assert_same_state,
                                segment_lengths)

IDEAL = lj.LJParams(eps=((0.0, 0.0), (0.0, 0.0)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test runner runs several files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- states of the three families, with both packages' closures --------------

@functools.lru_cache(maxsize=None)
def _family(name, dim, m=2, seed=4):
    """(reference chains, port chains, reference closures, port closures,
    reference attributes): 3-D LJ at N 1372 (rho 0.5: a box of 14, four
    cells an axis), 3-D hard spheres at N 1024 (eta 0.3), 2-D LJ and poly
    at N 512."""
    if name == "lj":
        n, rho = (1372, 0.5) if dim == 3 else (512, 1.0)
        ref = ref_lj.init_chains(m, n, rho=rho, beta=1.0 / 0.45, frac_b=0.2,
                                 seed=seed, dim=dim)
        return (ref, interop.chains_from_reference(ref, device="cpu"),
                ref_lj.cell_closures(ref_lj.LJParams()),
                lj.cell_closures(lj.LJParams()),
                ref.species.astype(jnp.float32))
    if name == "poly":
        ref = ref_poly.init_chains(m, 512, rho=0.6, beta=1.0 / 0.4,
                                   seed=seed, dim=dim)
        return (ref, interop.chains_from_reference(ref, device="cpu"),
                ref_poly.cell_closures(ref_poly.PolyParams()),
                poly.cell_closures(poly.PolyParams()), ref.diam)
    ref = ref_hd.init_chains(m, 1024, eta=0.3, seed=seed, dim=dim)
    return (ref, interop.chains_from_reference(ref, device="cpu"),
            ref_hd.cell_closures(), hd.cell_closures(),
            jnp.zeros(ref.pos.shape[:-1], jnp.float32))


def _grids(ref, rcut, **kw):
    """The same plan in both packages."""
    n, dim = ref.pos.shape[1:]
    box = float(ref.box[0])
    return (ref_cell.plan_grid(n, box, rcut, dim=dim, **kw),
            cell_mc.plan_grid(n, box, rcut, dim=dim, **kw))


def _beta_energy(ref):
    m = ref.pos.shape[0]
    return (getattr(ref, "beta", jnp.ones((m,), jnp.float32)),
            getattr(ref, "energy", jnp.zeros((m,), jnp.float32)))


def _ref_volume(grid, closures, vol):
    """The reference's volume variant alone, over the chains: the tail of
    the variant list its ``_make_substep`` closes over (compiling it alone
    spares the test the whole ``lax.switch``)."""
    substep, _ = ref_cell._make_substep(grid, *closures[:2], None,
                                        "gaussian", vol)
    free = dict(zip(substep.__code__.co_freevars,
                    (c.cell_contents for c in substep.__closure__)))
    return jax.jit(jax.vmap(free["variants"][-1],
                            in_axes=(0, 0, 0, 0, None, 0)))


def _ref_cells(grid, ref, attr):
    s = (ref.pos / ref.box[:, None, None]) % 1.0
    cells = jax.vmap(lambda a, b: ref_cell.bind_cells(grid, a, b))(s, attr)
    cells.pop("overflow")
    return s, cells


# -- with the reference's draws ----------------------------------------------

@pytest.mark.parametrize("family,dim,pressure", [
    ("poly", 2, 4.0), ("hd", 3, 2.5)])
def test_volume_substep_matches_reference(family, dim, pressure):
    """The volume variant on the bound state: four chains and four substep
    indices.  The halo is sized so that the grid's floor sits just below
    the chains' box: chain 3 is put on the floor (its compressions leave
    the range), the others are expanded by up to 6 %."""
    ref, _, rc, pc, attr = _family(family, dim, m=4)
    n, box0 = ref.pos.shape[1], float(ref.box[0])
    nc = _grids(ref, rc[2])[0].nc
    grid, pgrid = _grids(ref, rc[2],
                         d_cap=(box0 / nc - rc[2]) / 2 - 1e-6)
    assert grid.nc == nc and grid.box_min < box0
    box = np.float32(box0) * np.array([1.0, 1.03, 1.06, 1.0], np.float32)
    box[3] = np.float32(grid.box_min)
    ref = dataclasses.replace(ref, box=jnp.asarray(box),
                              pos=ref.pos * (box / ref.box)[:, None, None])
    vol = (n, pressure)
    # the cached energy both sides start from (the rescaled chains keep
    # their unscaled energies: a stale cache, the same on both sides)
    beta, energy = _beta_energy(ref)
    s, cells = _ref_cells(grid, ref, attr)
    P = cell_mc._pack(cell_mc.bind_cells(pgrid, T(s), T(attr)))
    variants, _ = cell_mc._make_substep(pgrid, *pc[:2], None, vol)
    draws = ReferenceDraws(jax.random.key(17))
    fn = _ref_volume(grid, rc, vol)
    accepted, expands = [], []
    for i in range(4):
        _, want_e, want_box, want_att, want_acc = fn(
            cells, energy, ref.box, draws._keys(i, 4), 0.05, beta)
        u_delta, u_acc = draws.volume(i, 4, "cpu")
        got_box, got_e, got_att, got_acc = variants[2][0](
            P, T(box), T(energy), torch.tensor(0.05), T(beta), u_delta,
            u_acc)
        np.testing.assert_allclose(got_box.numpy(), np.asarray(want_box),
                                   rtol=1e-6)
        np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e),
                                   rtol=1e-5)
        np.testing.assert_array_equal(got_att.numpy(),
                                      np.asarray(want_att).astype(bool))
        np.testing.assert_array_equal(got_acc.numpy(),
                                      np.asarray(want_acc).astype(bool))
        accepted.append(got_acc.numpy())
        expands.append(u_delta.numpy() > 0)
    accepted, expands = np.array(accepted), np.array(expands)
    assert accepted.any() and not accepted.all()
    # the chain at the floor: every compression rejected
    assert not np.any(accepted[:, 3] & ~expands[:, 3])


def test_segment_3d_matches_reference():
    """``cell_mc_segment`` on 3-D LJ (2 x N 1372, four cells an axis), the
    species pool, 48 substeps that visit each of the 8 displacement and 8
    swap colors, against the reference's on the same key."""
    ref, st, rc, pc, attr = _family("lj", 3)
    grid, pgrid = _grids(ref, rc[2])
    key = jax.random.key(7)
    kw = dict(w_disp=0.6, w_swap=0.4)
    seq = ReferenceDraws(key).variants(48, 8, 0.6, 0.4, True, False)
    assert len({tuple(v) for v in seq.tolist()}) == 16
    want = ref_cell.cell_mc_segment(
        grid, *rc[:2], ref.pos, attr, ref.beta, ref.energy, 0.08, key, 48,
        box=ref.box, swap_mode="species", **kw)
    got = cell_mc.cell_mc_segment(
        pgrid, cell_mc.CellModel(*pc, swap_mode="species"),
        ReferenceDraws(key), st.pos, st.species.float(), st.beta, st.energy,
        0.08, 48, box=st.box, **kw)
    _same_segment(got, want)
    assert int(got[4][:, 0].min()) > 0 and int(got[5][:, 1].min()) > 0


def _same_segment(got, want):
    pos, attr, e, box, att, acc, inv = got
    np.testing.assert_allclose(pos.numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(attr.numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(e.numpy(), np.asarray(want[2]), rtol=1e-5)
    np.testing.assert_allclose(box.numpy(), np.asarray(want[3]), rtol=1e-6)
    np.testing.assert_array_equal(att.numpy(), np.asarray(want[4]))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want[5]))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(want[6]))


def test_npt_segment_from_box_min_matches_reference():
    """The three-kind pool (displacement, pair swap, volume) on 2-D poly
    chains compressed to ``box == grid.box_min``, where the two halos are
    equal: 40 substeps against the reference's.  Compressions stay out of
    range; the accepted expansions (ln-V half-width 1e-4) part the halos by
    under 1e-5 of a cell, and no proposal of these keys falls between
    them."""
    ref, _, rc, pc, attr = _family("poly", 2)
    grid, pgrid = _grids(ref, rc[2], box_margin=0.15, max_occupancy=30)
    scale = np.float32(grid.box_min) / np.asarray(ref.box)
    ref = dataclasses.replace(ref, box=ref.box * scale,
                              pos=ref.pos * scale[:, None, None])
    ref = dataclasses.replace(ref, energy=jax.vmap(ref_poly.total_energy)(
        ref))
    st = interop.chains_from_reference(ref, device="cpu")
    assert float(st.box[0]) == np.float32(grid.box_min)
    key = jax.random.key(23)
    kw = dict(w_disp=0.5, w_swap=0.2, vol=(512, 4.0), dlnv=1e-4)
    want = ref_cell.cell_mc_segment(
        grid, *rc[:2], ref.pos, attr, ref.beta, ref.energy, 0.08, key, 40,
        box=ref.box, swap_mode="pair", **kw)
    got = cell_mc.cell_mc_segment(
        pgrid, cell_mc.CellModel(*pc, swap_mode="pair"), ReferenceDraws(key),
        st.pos, st.diam, st.beta, st.energy, 0.08, 40, box=st.box, **kw)
    _same_segment(got, want)
    att, acc = got[4], got[5]
    assert bool((att > 0).all()) and int(acc[:, 2].min()) > 0
    assert bool((got[3] > st.box).all())


def test_fractional_halo_is_box_invariant():
    """With volume substeps the displacement's halo is a fixed fraction of
    the box: the same fractional cells and draws give the same accepted
    moves at a box 10 % larger (the width scaled with it); without them the
    halo is ``d_cap`` in real units and rejects more at the larger box.  At
    the grid's floor the two halos are one.  On an ideal gas, so that only
    the halo decides; 30 substeps, each from the same bound cells."""
    st = lj.init_chains(2, 512, rho=0.8, beta=1.0, seed=3, params=IDEAL,
                        device="cpu")
    pe, rc2, rcut = lj.cell_closures(IDEAL)
    box = float(st.box[0])
    grid = cell_mc.plan_grid(512, box, rcut, box_margin=0.15)
    cells = cell_mc.bind_cells(
        grid, torch.remainder(st.pos / st.box[:, None, None], 1.0),
        st.species)
    gen = cell_mc.KeyDraws(5, 0, torch.arange(2))
    halos = {"npt": cell_mc._make_substep(grid, pe, rc2, None, (512, 1.0)),
             "nvt": cell_mc._make_substep(grid, pe, rc2)}
    acc = {(k, b): 0 for k in halos for b in ("min", "1.0", "1.1")}
    for i in range(30):
        draws = gen.substep(i, 0, 2, grid.nc // 2, grid.cap, 2, "gaussian",
                            "cpu")
        color = i % 4
        out = {}
        for k, (variants, _) in halos.items():
            for b, edge in (("min", grid.box_min), ("1.0", box),
                            ("1.1", 1.1 * box)):
                P = cell_mc._pack(cells)
                a = variants[0][color](P, torch.full((2,), edge),
                                       torch.tensor(0.5 * edge / box),
                                       st.beta, *draws)[2]
                out[k, b] = (P, a)
                acc[k, b] += int(a.sum())
        for b in ("min", "1.0", "1.1"):
            assert torch.equal(out["npt", b][1], out["npt", "min"][1])
            assert torch.allclose(out["npt", b][0], out["npt", "min"][0],
                                  rtol=0, atol=1e-6)
        assert torch.equal(out["nvt", "min"][0], out["npt", "min"][0])
    assert acc["nvt", "1.1"] < acc["nvt", "1.0"] < acc["nvt", "min"]
    assert acc["npt", "1.0"] == acc["nvt", "min"] > 0


# -- through Metropolis -------------------------------------------------------

def _pool(mod, family):
    if family == "poly":
        return (mod.displacement_move(0.08, weight=0.75),
                mod.swap_move(weight=0.2),
                mod.volume_move(0.002, 4.0, weight=0.05))
    return (mod.lj_displacement_move(0.06),)


@pytest.mark.parametrize("case", ["poly_npt", "lj_3d"])
def test_substeps_and_summary_match_reference(monkeypatch, tmp_path, case):
    """For an NPT pool (2-D poly: displacement, swap, volume) and a 3-D
    pool, ``Metropolis`` runs the substep counts of the reference's float32
    ``cell_debt`` arithmetic over a fine-stride schedule (the segments
    themselves stubbed: the counts depend on the weights and the plan
    alone), ends with the same debt, and writes the same ``Cell MC:``
    line."""
    family, dim = ("poly", 2) if case == "poly_npt" else ("lj", 3)
    ref, st = _family(family, dim)[:2]
    counts = {"ref": [], "port": []}

    def stub(name, xp, pos, attr, energy, n_sub, box):
        counts[name].append(int(n_sub))
        z = xp.zeros((pos.shape[0], 3), dtype=xp.int32)
        return (pos, attr, energy, box, z, z,
                xp.zeros(pos.shape[0], dtype=bool))

    monkeypatch.setattr(
        ref_cell, "cell_mc_segment",
        lambda grid, pe, rc2, pos, attr, beta, energy, sigma, key, n_sub,
        **kw: stub("ref", jnp, pos, attr, energy, n_sub, kw["box"]))
    monkeypatch.setattr(
        cell_mc, "cell_mc_segment",
        lambda grid, model, draws, pos, attr, beta, energy, sigma, n_sub,
        **kw: stub("port", torch, pos, attr, energy, n_sub, kw["box"]))
    ref_mod = {"poly": ref_poly, "lj": ref_lj}[family]
    mod = {"poly": poly, "lj": lj}[family]
    ref_sim = mc.Simulation(ref_mod.make_system(), ref, [
        dict(algorithm=mc.Metropolis, pool=_pool(ref_mod, family), seed=4,
             sweepstep=7, fused="cell")], 40, path=str(tmp_path / "ref"))
    sim = tmc.Simulation(mod.make_system(), st, [
        dict(algorithm=tmc.Metropolis, pool=_pool(mod, family), seed=4,
             sweepstep=7, fused="cell")], 40, path=str(tmp_path / "port"))
    ref_met, met = ref_sim.device_algos[0], sim.device_algos[0]
    assert met._cell_plan == cell_mc.CellGrid(*ref_met._cell_plan._key())
    assert (met._cell_model.vol, met._cell_model.pressure) == \
        ref_met._cell_model[6:8]
    ref_ds, ds = ref_sim.init_device_state(), sim.init_device_state()
    lengths = segment_lengths(40)
    for n in lengths:
        ref_ds = ref_met.fused_advance(ref_ds, jnp.asarray(n, jnp.int32))
        ds = met.fused_advance(ds, n)
    assert counts["port"] == counts["ref"] and len(counts["ref"]) == \
        len(lengths)
    assert 0 in counts["ref"] and max(counts["ref"]) > 0
    assert ds["metropolis"]["cell_debt"].numpy() == np.asarray(
        ref_ds["metropolis"]["cell_debt"])
    lines = []
    for s, m in ((ref_sim, ref_met), (sim, met)):
        buf = io.StringIO()
        m.write_summary(buf, s.schedulers[0])
        lines.append([ln for ln in buf.getvalue().splitlines()
                      if ln.startswith("\t\tCell MC: ")])
    assert lines[1] == lines[0] and len(lines[0]) == 1
    assert "enabled (CellGrid(" in lines[0][0]


def test_auto_takes_the_cell_path_for_3d_and_npt_pools(tmp_path):
    """From N 2048, ``'auto'`` takes the cell path for a 3-D pool and for a
    pool with a volume move on the card too: no row kernel takes them."""
    st3 = lj.init_chains(2, 2048, rho=0.6, beta=1.0, seed=3, device="cpu",
                         dim=3)
    st2 = lj.init_chains(2, 2048, rho=0.8, beta=1.0, seed=3, device="cpu")
    npt = (lj.lj_displacement_move(0.08, weight=0.95),
           lj.lj_volume_move(0.002, 1.0, weight=0.05))
    for st, pool in ((st3, (lj.lj_displacement_move(0.06),)), (st2, npt)):
        met = tmc.Simulation(lj.make_system(), st, [
            dict(algorithm=tmc.Metropolis, pool=pool)], 4,
            path=str(tmp_path)).device_algos[0]
        assert met._use_cell and met.supports_fused
        met.device = torch.device("cuda")           # as the card sees it
        assert met._use_cell and met._row is None


def test_hard_spheres_npt_cell_path(tmp_path):
    """Hard-core NPT on the 3-D cell path through ``Simulation.run``: the
    volume substeps are accepted and rejected by the infinite wall, no
    sphere overlaps, the box moves (the reference's
    ``test_hard_sphere_npt_cell_path`` at N 512 and 4 steps of 256 moves
    where it takes N 4096 and 12 of 512: a volume substep's all-cells pass
    grows with the square of the cell capacity)."""
    chains = hd.init_chains(2, 512, eta=0.30, seed=9, dim=3, device="cpu")
    pool = (hd.displacement_move(0.12, weight=0.95),
            hd.volume_move(dlnv=0.002, beta_pressure=3.0, weight=0.05))
    sim = tmc.Simulation(hd.make_system(), chains, [
        dict(algorithm=tmc.Metropolis, pool=pool, seed=5, sweepstep=256,
             fused="cell")], 4, path=str(tmp_path))
    met = sim.device_algos[0]
    assert met._use_cell and met._cell_plan.dim == 3
    assert met._cell_model.model == hd.FAMILY.cell(None)
    assert met._cell_model.vol == 1
    sim.run()
    slc = sim.device_state["metropolis"]
    assert not bool(slc["cell_overflow"])
    cnt = slc["counters"].numpy()
    assert cnt[:, 1, 1].min() > 0 and cnt[:, 1, 0].sum() > 0
    st = sim.device_state["sys"]
    assert bool((st.box != chains.box).all())
    assert bool((st.box >= met._cell_plan.box_min).all())
    assert bool(hd.overlap_free(st).all())


def test_npt_cell_matches_generic_density(tmp_path):
    """The cell path's NPT density equals the generic path's at the same
    (T, P) within 4 standard errors + 0.01: the two volume moves share no
    code.  The reference's test (``tests/test_cell_mc.py:541``: N 512, 16
    chains, ~31k attempts a chain, ln-V half-width 0.01) reduced to N 128
    (with ``d_cap`` 0.2, the smallest box a 4 x 4 grid plans with the NPT
    margin), 12 chains and 1,024 attempts a chain, the half-width raised
    to 0.03 so that the density relaxes within them; the density averaged
    over the second half of each run."""
    n, m, pressure = 128, 12, 2.0
    p = lj.LJParams()
    means = {}
    for mode, sweep, steps in (("cell", 128, 8), ("off", 16, 64)):
        chains = lj.init_chains(m, n, rho=0.65, beta=1.0, seed=45, params=p,
                                device="cpu")
        pool = (lj.lj_displacement_move(0.12, weight=0.95, params=p),
                lj.lj_volume_move(dlnv=0.03, pressure=pressure, weight=0.05,
                                  params=p))
        every = steps // 8
        sim = tmc.Simulation(lj.make_system(p), chains, [
            dict(algorithm=tmc.Metropolis, pool=pool, seed=1,
                 sweepstep=sweep, fused=mode, cell_opts={"d_cap": 0.2}),
            dict(algorithm=tmc.StoreCallbacks,
                 callbacks=(lj.callback_density,),
                 scheduler=np.arange(every, steps + 1, every))], steps,
            path=str(tmp_path / mode))
        assert sim.device_algos[0]._use_cell == (mode == "cell")
        sim.run()
        d = np.loadtxt(os.path.join(sim.path, "density.dat"))
        rho = n / sim.device_state["sys"].box.double().numpy() ** 2
        tail = d[d[:, 0] > steps // 2, 1]
        means[mode] = (float(tail.mean()),
                       float(rho.std(ddof=1) / np.sqrt(m)))
    se = np.hypot(means["cell"][1], means["off"][1])
    assert abs(means["cell"][0] - means["off"][0]) < 4 * se + 0.01, means


def test_npt_cell_run_resumed_equals_uncut(tmp_path):
    """An NPT cell run (poly: displacement, swap, volume; the density and
    the energy every step, so the refresh runs on per-chain boxes) cut by a
    backup and resumed in a fresh Simulation ends bit-equal to the uncut
    run, its boxes included; the cache equals a recompute."""
    steps, backup = 12, 5
    chains = poly.init_chains(2, 512, rho=0.6, beta=1.0 / 0.4, seed=21,
                              device="cpu")

    def build(path, backups=False):
        recs = [dict(algorithm=tmc.StoreCallbacks,
                     callbacks=(poly.callback_energy_per_particle,
                                poly.callback_density),
                     scheduler=np.arange(1, steps + 1))]
        if backups:
            recs.append(dict(algorithm=tmc.StoreBackups,
                             scheduler=np.asarray([backup])))
        return tmc.Simulation(poly.make_system(), chains, [
            dict(algorithm=tmc.Metropolis, pool=_pool(poly, "poly"), seed=3,
                 sweepstep=64, fused="cell")] + recs, steps, path=str(path))

    whole = build(tmp_path / "whole")
    whole.run()
    cut = build(tmp_path / "cut", backups=True)
    cut.run()
    ckpt = os.path.join(cut.path, "checkpoints", f"ckpt_t{backup}.npz")
    resumed = build(tmp_path / "resumed")
    checkpoint.resume_state(resumed, ckpt)
    assert resumed.t == backup
    resumed.run()
    assert_same_state(whole.device_state, resumed.device_state)
    st = whole.device_state["sys"]
    cnt = whole.device_state["metropolis"]["counters"].numpy()
    assert cnt[:, 2, 0].sum() > 0 and not torch.equal(st.box, chains.box)
    np.testing.assert_allclose(st.energy.numpy(),
                               poly.total_energy(st).numpy(), rtol=1e-5,
                               atol=1e-3)
    got = np.loadtxt(os.path.join(resumed.path, "density.dat"))
    want = np.loadtxt(os.path.join(whole.path, "density.dat"))
    np.testing.assert_array_equal(got, want[want[:, 0] > backup])
