"""The checkerboard cell-MC path at the ops level: the port's
``ops/cell_mc.py`` against the JAX package's on the same inputs.

Held value for value: the plan, the bind (an overflowing one included), the
cell energy, one substep of every variant and whole segments, each fed the
reference's own ``jax.random`` draws (:class:`ReferenceDraws`, derived as
the reference's ``cell_mc_segment`` derives them).  Positions agree within
1e-5 (1e-6 after one substep), attributes, counters and flags exactly,
energies within rtol 1e-5 (the port's neighbourhood sums accumulate in
float64, XLA's in float32); the keys are ones where no accept decision sits within an ulp of
its threshold.  Then the reference's own gates (``tests/test_cell_mc.py``) by
statistics and invariants on the port's own stream, and the port's
:class:`KeyDraws` against :class:`ReferenceDraws`.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.models import hard_disks as ref_hd
from montecarlo_tpu.models import lennard_jones as ref_lj
from montecarlo_tpu.models import polydisperse as ref_poly
from montecarlo_tpu.ops import cell_mc as ref_cell
from montecarlo_tpu_torch import interop
from montecarlo_tpu_torch.models import hard_disks as hd
from montecarlo_tpu_torch.models import lennard_jones as lj
from montecarlo_tpu_torch.models import polydisperse as poly
from montecarlo_tpu_torch.ops import cell_mc
from montecarlo_tpu_torch.ops.lj_sweep import fused_lj_sweep
from torch_cell_helpers import ReferenceDraws, T

LJP = lj.LJParams()
POLYP = poly.PolyParams()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test runner runs several files at once, and
    the many small ops here slow down sharply when threads contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the three families, as (reference state, port state, closures) --------

@functools.lru_cache(maxsize=None)
def _family(name, m=2, n=512, seed=4):
    if name == "lj":
        ref = ref_lj.init_chains(m, n, rho=1.2, beta=1.0 / 0.45, frac_b=0.2,
                                 seed=seed)
        return (ref, interop.chains_from_reference(ref, device="cpu"),
                ref_lj.cell_closures(ref_lj.LJParams()),
                lj.cell_closures(LJP), ref.species.astype(jnp.float32))
    if name == "poly":
        ref = ref_poly.init_chains(m, n, rho=1.0, beta=1.0, seed=seed)
        return (ref, interop.chains_from_reference(ref, device="cpu"),
                ref_poly.cell_closures(ref_poly.PolyParams()),
                poly.cell_closures(POLYP), ref.diam)
    ref = ref_hd.init_chains(m, n, eta=0.70, seed=seed)
    return (ref, interop.chains_from_reference(ref, device="cpu"),
            ref_hd.cell_closures(), hd.cell_closures(),
            jnp.zeros(ref.pos.shape[:-1], jnp.float32))


@functools.lru_cache(maxsize=None)
def _ref_bind(grid):
    return jax.jit(jax.vmap(lambda a, b: ref_cell.bind_cells(grid, a, b)))


@functools.lru_cache(maxsize=None)
def _ref_substep(grid, closures, swap_mode, proposal, sigma):
    """The reference's substep over the chains, compiled once per model and
    kind (the variant index is traced)."""
    substep, _ = ref_cell._make_substep(grid, *closures[:2], swap_mode,
                                        proposal)
    return jax.jit(jax.vmap(
        lambda c, e, b, k, be, v: substep(c, e, b, k, v, sigma, 0.0, be),
        in_axes=(0, 0, 0, 0, 0, None)))


def _beta_energy(ref):
    m = ref.pos.shape[0]
    beta = getattr(ref, "beta", jnp.ones((m,), jnp.float32))
    energy = getattr(ref, "energy", jnp.zeros((m,), jnp.float32))
    return beta, energy


# -- plan and bind ------------------------------------------------------------

@pytest.mark.parametrize("args,kw", [
    ((1024, 29.2, 2.5), {}),
    ((512, 20.6559, 2.5), dict(d_cap=0.3)),
    ((16384, 116.85, 2.5), dict(max_occupancy=29)),
    ((4096, 67.3, 2.025), dict(cap_slack=3.0)),
    ((2048, 41.31, 2.5), dict(box_margin=0.15, max_occupancy=60)),
    ((100, 14.0, 1.0), dict(d_cap=0.2, cap_slack=1.0)),
])
def test_plan_grid_matches_reference(args, kw):
    got, want = cell_mc.plan_grid(*args, **kw), ref_cell.plan_grid(*args, **kw)
    assert repr(got) == repr(want)
    assert (got.nc, got.cap, got.box_min, got.w) == (
        want.nc, want.cap, want.box_min, want.w)
    assert hash(got) == hash(cell_mc.CellGrid(want.nc, want.cap, want.box,
                                              want.d_cap, want.rcut))


def test_plan_grid_raises_where_the_reference_does():
    for mod in (ref_cell, cell_mc):
        with pytest.raises(ValueError, match="too small for cell MC"):
            mod.plan_grid(64, 8.0, rcut=2.5, d_cap=0.45)


@pytest.mark.parametrize("cap", [None, 8])
def test_bind_cells_matches_reference(cap):
    """The same fractional positions bind to the same cells, slot for slot;
    with a capacity of 8 (mean occupancy ~14) every chain overflows, and the
    overwritten slots hold what the reference's scatter leaves there."""
    ref, st, _, _, attr = _family("lj")
    box = float(ref.box[0])
    grid = ref_cell.plan_grid(512, box, 2.5)
    if cap is not None:
        grid = ref_cell.CellGrid(grid.nc, cap, grid.box, grid.d_cap,
                                 grid.rcut)
    pgrid = cell_mc.CellGrid(grid.nc, grid.cap, grid.box, grid.d_cap,
                             grid.rcut)
    s = np.asarray((ref.pos / ref.box[:, None, None]) % 1.0)
    want = _ref_bind(grid)(jnp.asarray(s), attr)
    got = cell_mc.bind_cells(pgrid, T(s), st.species)
    for k in ("crd", "attr", "occ", "idx", "overflow"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert bool(got["overflow"].all()) == (cap is not None)
    if cap is None:
        s2, a2 = cell_mc.unbind_cells(got, 512)
        np.testing.assert_array_equal(s2.numpy(), s)
        np.testing.assert_array_equal(a2.numpy(),
                                      st.species.numpy().astype(np.float32))


@pytest.mark.parametrize("family", ["lj", "poly", "hd", "hd_overlap"])
def test_cell_total_energy_matches_reference_and_dense(family):
    ref, st, (pe, rc2, rcut), (pe2, rc22, _), attr = _family(
        "hd" if family == "hd_overlap" else family)
    if family == "hd_overlap":
        # two disks of chain 1 at distance 0.5: an infinite energy
        pos = np.array(ref.pos)
        pos[1, 1] = pos[1, 0] + np.float32(0.5)
        ref = dataclasses.replace(ref, pos=jnp.asarray(pos))
        st = interop.chains_from_reference(ref, device="cpu")
    box = float(ref.box[0])
    grid = ref_cell.plan_grid(512, box, rcut)
    pgrid = cell_mc.plan_grid(512, box, rcut)
    want = np.asarray(jax.jit(jax.vmap(
        lambda p, a: ref_cell.cell_total_energy(grid, pe, rc2, p, a, box)))(
        ref.pos, attr))
    got = cell_mc.cell_total_energy(pgrid, pe2, rc22, st.pos, T(attr),
                                    st.box).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    if family == "lj":
        np.testing.assert_allclose(got, lj.total_energy(st, LJP).numpy(),
                                   rtol=1e-5)
    elif family == "poly":
        np.testing.assert_allclose(got, poly.total_energy(st, POLYP).numpy(),
                                   rtol=1e-5)
    elif family == "hd":
        np.testing.assert_array_equal(got, 0.0)
    else:
        np.testing.assert_array_equal(got, [0.0, np.inf])


# -- one substep of every variant, with the reference's draws ----------------

_VARIANTS = ([("lj", 0, c) for c in range(4)]
             + [("hd", 0, c) for c in range(4)]
             + [("lj", 1, c) for c in range(4)]
             + [("poly", 1, c) for c in range(4)])


@pytest.mark.parametrize("family,kind,color", _VARIANTS)
def test_substep_matches_reference(family, kind, color):
    """Displacement colors (Gaussian on LJ, square on hard disks) and swap
    colors (species on LJ, pair on poly) from the same cells and key."""
    ref, st, (pe, rc2, rcut), (pe2, rc22, _), attr = _family(family)
    swap_mode = {"lj": "species", "poly": "pair"}.get(family) \
        if kind == 1 else None
    proposal = "square" if family == "hd" else "gaussian"
    sigma = 0.12 if family == "hd" else 0.08
    box = float(ref.box[0])
    grid = ref_cell.plan_grid(512, box, rcut)
    pgrid = cell_mc.plan_grid(512, box, rcut)
    beta, energy = _beta_energy(ref)
    s = (ref.pos / ref.box[:, None, None]) % 1.0
    cells = _ref_bind(grid)(s, attr)
    cells.pop("overflow")
    key = jax.random.key(11)
    chain = jax.vmap(jax.random.fold_in, (None, 0))(
        key, jnp.arange(2, dtype=jnp.uint32))
    keys = jax.vmap(jax.random.fold_in, (0, None))(chain, 0)
    want_cells, want_e, _, want_att, want_acc = _ref_substep(
        grid, (pe, rc2), swap_mode, proposal, sigma)(
        cells, energy, ref.box, keys, beta, kind * 4 + color)

    pcells = cell_mc.bind_cells(pgrid, T(s), T(attr))
    P = cell_mc._pack(pcells)
    variants, _ = cell_mc._make_substep(pgrid, pe2, rc22, swap_mode)
    draws = ReferenceDraws(key).substep(0, kind, 2, pgrid.nc // 2,
                                        pgrid.cap, 2, proposal, "cpu")
    d_e, n_att, n_acc = variants[kind][color](
        P, st.box, torch.tensor(sigma), T(beta), *draws)
    np.testing.assert_allclose(P[:, :2].numpy(),
                               np.asarray(want_cells["crd"]), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(P[:, 2].numpy(),
                                  np.asarray(want_cells["attr"]))
    np.testing.assert_allclose((T(energy) + d_e).numpy(),
                               np.asarray(want_e), rtol=1e-5)
    np.testing.assert_array_equal(n_att.numpy(), np.asarray(want_att))
    np.testing.assert_array_equal(n_acc.numpy(), np.asarray(want_acc))
    assert int(n_acc.sum()) > 0


# -- whole segments, with the reference's draws --------------------------------

@pytest.mark.parametrize("swap_mode,w_disp", [(None, 1.0), ("species", 0.6)])
def test_segment_matches_reference(swap_mode, w_disp):
    """``cell_mc_segment`` at 2 x N 512, LJ one-move and the species pool,
    40 substeps, against the reference's on the same key."""
    ref, st, (pe, rc2, rcut), (pe2, rc22, _), attr = _family("lj")
    box = float(ref.box[0])
    grid = ref_cell.plan_grid(512, box, rcut)
    key = jax.random.key(7)
    want = ref_cell.cell_mc_segment(
        grid, pe, rc2, ref.pos, attr, ref.beta, ref.energy, 0.08, key, 40,
        w_disp=w_disp, swap_mode=swap_mode, box=ref.box)
    got = cell_mc.cell_mc_segment(
        cell_mc.plan_grid(512, box, rcut),
        cell_mc.CellModel(pe2, rc22, rcut, swap_mode=swap_mode),
        ReferenceDraws(key), st.pos, st.species.float(), st.beta, st.energy,
        0.08, 40, w_disp=w_disp, box=st.box)
    pos, attr_o, e, box_o, att, acc, inv = got
    np.testing.assert_allclose(pos.numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(attr_o.numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(e.numpy(), np.asarray(want[2]), rtol=1e-5)
    np.testing.assert_array_equal(box_o.numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(att.numpy(), np.asarray(want[4]))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want[5]))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(want[6]))
    assert int(att[:, 0].min()) > 0
    if swap_mode:
        assert int(acc[:, 1].min()) > 0


# -- the reference's gates, on the port's stream ------------------------------

def _segment(grid, closures, st, attr, sigma, n_sub, seed, swap_mode=None,
             **kw):
    """An NVT segment on the port's stream: ``cell_mc_segment``'s outputs
    without the (unchanged) box."""
    beta = getattr(st, "beta", torch.ones(st.pos.shape[0]))
    energy = getattr(st, "energy", torch.zeros(st.pos.shape[0]))
    pos, attr, e, _, att, acc, inv = cell_mc.cell_mc_segment(
        grid, cell_mc.CellModel(*closures, swap_mode=swap_mode),
        cell_mc.KeyDraws(seed, 0, torch.arange(st.pos.shape[0])), st.pos,
        attr, beta, energy, sigma, n_sub, box=st.box, **kw)
    return pos, attr, e, att, acc, inv


def test_segment_energy_bookkeeping():
    st = lj.init_chains(2, 512, rho=1.2, beta=1.0 / 0.45, frac_b=0.2,
                        seed=4, device="cpu")
    grid = cell_mc.plan_grid(512, float(st.box[0]), 2.5)
    pos, _, e, att, acc, ovf = _segment(grid, lj.cell_closures(LJP), st,
                                        st.species.float(), 0.08, 100, 0)
    assert not bool(ovf.any())
    assert bool((att[:, 0] > 0).all()) and bool((acc[:, 0] > 0).all())
    e_true = lj.total_energy(dataclasses.replace(st, pos=pos), LJP)
    np.testing.assert_allclose(e.numpy(), e_true.numpy(), rtol=2e-5,
                               atol=5e-2)


def test_cell_vs_row_same_ensemble_multisegment():
    """Equilibrium e/N from many short cell segments (a fresh grid origin
    per bind) matches the row path's (the plain version of the LJ row
    kernel) with the same attempt count."""
    n, m = 256, 32
    st = lj.init_chains(m, n, rho=1.0, beta=1.0, frac_b=0.0, seed=8,
                        device="cpu")
    grid = cell_mc.plan_grid(n, float(st.box[0]), 2.5)
    pos, attr, e = st.pos, st.species.float(), st.energy
    att_tot = 0
    for seg in range(30):
        cur = dataclasses.replace(st, pos=pos, energy=e)
        pos, attr, e, att, _, ovf = _segment(
            grid, lj.cell_closures(LJP), cur, attr, 0.12, 25, 100 + seg)
        assert not bool(ovf.any())
        att_tot += int(att[:, 0].sum())
    e_cell = lj.total_energy(dataclasses.replace(st, pos=pos), LJP) / n
    pos_r, _, _ = fused_lj_sweep(st.pos, st.species, st.beta, st.energy,
                                 float(st.box[0]), 0.12, 17, 0, att_tot // m,
                                 params=LJP, interpret=True)
    e_row = lj.total_energy(dataclasses.replace(st, pos=pos_r), LJP) / n
    e_cell, e_row = e_cell.numpy(), e_row.numpy()
    se = np.sqrt(e_cell.std() ** 2 / m + e_row.std() ** 2 / m)
    assert abs(e_cell.mean() - e_row.mean()) < 4 * se + 0.015, (
        e_cell.mean(), e_row.mean(), se)


def test_random_origin_uniformises_positions():
    """In a dilute gas sampled by many short segments, positions mod the
    cell width stay uniform (a fixed origin would pile density into the
    halo bands)."""
    n, m = 64, 64
    st = lj.init_chains(m, n, rho=0.05, beta=1.0, frac_b=0.0, seed=9,
                        device="cpu")
    grid = cell_mc.plan_grid(n, float(st.box[0]), 2.5)
    pos, attr, e = st.pos, st.species.float(), st.energy
    frac = []
    for seg in range(30):
        cur = dataclasses.replace(st, pos=pos, energy=e)
        pos, attr, e, _, _, ovf = _segment(
            grid, lj.cell_closures(LJP), cur, attr, 0.5, 40, 200 + seg)
        assert not bool(ovf.any())
        if seg >= 10:
            frac.append(pos.numpy().reshape(-1) % grid.w / grid.w)
    frac = np.concatenate(frac)
    hist, _ = np.histogram(frac, bins=8, range=(0.0, 1.0))
    expected = len(frac) / 8
    chi2 = ((hist - expected) ** 2 / expected).sum()
    assert chi2 < 50, (chi2, hist)


def test_cell_swap_species_conserved():
    st = lj.init_chains(4, 512, rho=1.2, beta=1.0 / 0.45, frac_b=0.2,
                        seed=11, device="cpu")
    grid = cell_mc.plan_grid(512, float(st.box[0]), 2.5)
    pos, attr, e, att, acc, ovf = _segment(
        grid, lj.cell_closures(LJP), st, st.species.float(), 0.08, 400, 1,
        w_disp=0.6, swap_mode="species")
    assert not bool(ovf.any())
    assert bool((att[:, :2] > 0).all()) and bool((acc[:, 1] > 0).all())
    np.testing.assert_array_equal(attr.sum(1).numpy(),
                                  st.species.sum(1).numpy())
    st2 = dataclasses.replace(st, pos=pos, species=attr.to(torch.int32))
    np.testing.assert_allclose(e.numpy(), lj.total_energy(st2, LJP).numpy(),
                               rtol=1e-4, atol=5e-2)


def test_cell_swap_pair_diameters_conserved():
    st = poly.init_chains(4, 512, rho=1.0, beta=1.0, seed=12, device="cpu")
    closures = poly.cell_closures(POLYP)
    grid = cell_mc.plan_grid(512, float(st.box[0]), closures[2])
    pos, diam, e, att, acc, ovf = _segment(
        grid, closures, st, st.diam, 0.08, 400, 2, w_disp=0.6,
        swap_mode="pair")
    assert not bool(ovf.any())
    assert bool((att[:, 1] > 0).all())
    np.testing.assert_array_equal(torch.sort(diam, 1).values.numpy(),
                                  torch.sort(st.diam, 1).values.numpy())
    st2 = dataclasses.replace(st, pos=pos, diam=diam)
    np.testing.assert_allclose(e.numpy(),
                               poly.total_energy(st2, POLYP).numpy(),
                               rtol=1e-4, atol=5e-2)


def test_anchor_constraint_invariant():
    """A particle's net displacement over a segment stays within its storage
    cell's halo: what keeps same-color moves independent."""
    st = lj.init_chains(2, 512, rho=1.0, beta=1.0, frac_b=0.2, seed=20,
                        device="cpu")
    box = float(st.box[0])
    grid = cell_mc.plan_grid(512, box, 2.5)
    pos1 = _segment(grid, lj.cell_closures(LJP), st, st.species.float(),
                    0.3, 500, 3)[0]
    d = (pos1 - st.pos).numpy()
    d = (d + box / 2) % box - box / 2
    assert np.all(np.abs(d) <= grid.w + 2 * grid.d_cap + 1e-5), \
        np.abs(d).max()


def test_invalid_bind_is_noop_and_flagged():
    st = lj.init_chains(2, 512, rho=1.2, beta=1.0 / 0.45, seed=31,
                        device="cpu")
    box = float(st.box[0])
    closures = lj.cell_closures(LJP)
    attr = st.species.float()
    bad = cell_mc.CellGrid(nc=4, cap=8, box=box, d_cap=0.45, rcut=2.5)
    pos, attr_o, e, att, acc, inv = _segment(bad, closures, st, attr, 0.08,
                                             50, 0)
    assert bool(inv.all())
    np.testing.assert_array_equal(pos.numpy(), st.pos.numpy())
    np.testing.assert_array_equal(e.numpy(), st.energy.numpy())
    np.testing.assert_array_equal(att.numpy(), 0)
    np.testing.assert_array_equal(acc.numpy(), 0)
    # a box below the grid's validity floor: invalid, a no-op
    good = cell_mc.plan_grid(512, box, 2.5)
    small = dataclasses.replace(st, box=torch.full((2,), good.box_min * 0.9))
    pos2, _, _, att2, _, inv2 = _segment(good, closures, small, attr, 0.08,
                                         50, 0)
    assert bool(inv2.all())
    np.testing.assert_array_equal(pos2.numpy(), st.pos.numpy())
    # a LARGER per-chain box is fine (fractional geometry): no flag
    big = dataclasses.replace(st, pos=st.pos * 1.1,
                              box=torch.full((2,), box * 1.1))
    _, _, _, att3, _, inv3 = _segment(good, closures, big, attr, 0.08, 50, 0)
    assert not bool(inv3.any())
    assert bool((att3[:, 0] > 0).all())


def test_variants_are_a_function_of_seed_and_microstep():
    """The host's variant sequence needs no state: the same (seed, micro-step)
    gives the same sequence, a different micro-step another, and the kind
    frequencies follow w_disp."""
    ids = torch.arange(2)
    a = cell_mc.KeyDraws(5, 1000, ids).variants(4000, 4, 0.7, 0.3, True,
                                                False)
    b = cell_mc.KeyDraws(5, 1000, ids).variants(4000, 4, 0.7, 0.3, True,
                                                False)
    c = cell_mc.KeyDraws(5, 1001, ids).variants(4000, 4, 0.7, 0.3, True,
                                                False)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert abs((a[:, 0] == 0).mean() - 0.7) < 0.03
    assert np.bincount(a[:, 1], minlength=4).min() > 900
    assert not cell_mc.KeyDraws(5, 0, ids).variants(
        100, 4, 0.7, 0.0, False, False)[:, 0].any()


@pytest.mark.parametrize("kind", ["displacement", "swap", "volume"])
def test_key_draws_equal_the_reference_draws(kind):
    """:class:`KeyDraws` of a segment derive the reference's numbers from
    its base key ``fold_in(key(seed), micro_t0)``: the variants of 300
    substeps (three kinds), the grid shifts and a substep's tensors, for
    chains 4..7 of a mesh rank (their global ids folded in) as for one
    process."""
    seed, micro_t0, m, h, cap, dim = 7, 1234, 4, 3, 5, 2
    ids = torch.arange(4, 4 + m)
    mine = cell_mc.KeyDraws(seed, micro_t0, ids)
    ref = ReferenceDraws(jax.random.fold_in(jax.random.key(seed),
                                            micro_t0))
    np.testing.assert_array_equal(
        mine.variants(300, 4, 0.6, 0.3, True, True),
        ref.variants(300, 4, 0.6, 0.3, True, True))
    full = lambda x: x[4:]      # the reference's draws of chains 0..7
    np.testing.assert_array_equal(mine.shift(m, dim, "cpu").numpy(),
                                  full(ref.shift(8, dim, "cpu")).numpy())
    if kind == "volume":
        got, want = mine.volume(11, m, "cpu"), ref.volume(11, 8, "cpu")
    else:
        k = int(kind == "swap")
        for proposal in ("gaussian", "square"):
            got = mine.substep(11, k, m, h, cap, dim, proposal, "cpu")
            want = ref.substep(11, k, 8, h, cap, dim, proposal, "cpu")
            # normals within a few float32 ulps, the rest bit for bit
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), full(w).numpy(),
                                           rtol=1e-6, atol=1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), full(w).numpy(), rtol=1e-6,
                                   atol=1e-6)
