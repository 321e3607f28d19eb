"""3-D states of the three particle families through the port's generic
engine, against the JAX package (``tests/test_lj3d.py``'s gates).

Held to the reference: ``init_chains(dim=3)`` (the same box, composition
and cubic lattice, the jitter within its band: the two packages' jitter
streams differ) and the text frame of a 3-D state, character for
character.  Then on the port alone: the trajectory stores (DAT, BIN, last
frames) of 3-D runs, the cache under displacement + swap, and the NVT
virial pressure; the row kernels and the cell path refuse a 3-D state too
small to plan, as in the reference.
"""

import os

import jax
import numpy as np
import pytest
import torch

import montecarlo_tpu_torch as tmc
from montecarlo_tpu.models import hard_disks as ref_hd
from montecarlo_tpu.models import lennard_jones as ref_lj
from montecarlo_tpu.models import polydisperse as ref_poly
from montecarlo_tpu_torch import interop
from montecarlo_tpu_torch.core.algorithms import (
    BIN, load_chain_major_trajectories)
from montecarlo_tpu_torch.models import hard_disks as hd
from montecarlo_tpu_torch.models import lennard_jones as lj
from montecarlo_tpu_torch.models import polydisperse as poly

PARAMS = lj.LJParams()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test runner runs several files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(family, m, n, seed=3):
    """(reference chains, the port's own chains) of the same arguments."""
    if family == "lj":
        kw = dict(rho=0.8, beta=1.0, frac_b=0.2, seed=seed, dim=3)
        return (ref_lj.init_chains(m, n, **kw),
                lj.init_chains(m, n, device="cpu", **kw))
    if family == "poly":
        kw = dict(rho=0.9, beta=1.0, seed=seed, dim=3)
        return (ref_poly.init_chains(m, n, **kw),
                poly.init_chains(m, n, device="cpu", **kw))
    kw = dict(eta=0.3, seed=seed, dim=3)
    return (ref_hd.init_chains(m, n, **kw),
            hd.init_chains(m, n, device="cpu", **kw))


@pytest.mark.parametrize("family", ["lj", "poly", "hd"])
def test_3d_init_geometry_matches_reference(family):
    m, n = 3, 100                                # 5^3 sites, 100 filled
    ref, st = _pair(family, m, n)
    box = float(ref.box[0])
    assert st.pos.shape == (m, n, 3) and st.box.shape == (m,)
    assert st.box.dtype == torch.float32 and float(st.box[0]) == box
    spacing = box / 5
    amp = 0.1 * spacing if family != "hd" else 0.45 * (spacing - 1.0)
    d = st.pos.numpy() - np.asarray(ref.pos)
    d -= box * np.round(d / box)
    # both jitter the same lattice site of each particle, in the same order
    assert np.abs(d).max() <= 2 * amp + 1e-5
    assert bool(((st.pos >= 0) & (st.pos <= box)).all())
    if family == "lj":
        np.testing.assert_array_equal(st.species.numpy(),
                                      np.asarray(ref.species))
        np.testing.assert_allclose(st.energy.numpy(),
                                   lj.total_energy(st, PARAMS).numpy(),
                                   rtol=1e-5)
    elif family == "poly":
        np.testing.assert_array_equal(st.diam.numpy(), np.asarray(ref.diam))
        np.testing.assert_allclose(
            st.energy.numpy(), poly.total_energy(st).numpy(), rtol=1e-5)
    else:
        assert bool(hd.overlap_free(st).all())
    with pytest.raises(ValueError, match="too dense"):
        hd.init_chains(1, 64, eta=0.53, dim=3, device="cpu")


@pytest.mark.parametrize("family", ["lj", "poly", "hd"])
def test_3d_frame_format_matches_reference(family):
    """``format_frame`` of one chain's 3-D frame, as the reference writes
    it."""
    ref, _ = _pair(family, 2, 27)
    st = interop.chains_from_reference(ref, device="cpu")
    mods = {"lj": (ref_lj, lj), "poly": (ref_poly, poly), "hd": (ref_hd,
                                                                 hd)}
    ref_sys, sys = (mod.make_system() for mod in mods[family])
    want = ref_sys.format_frame(5, jax.tree_util.tree_map(
        lambda x: np.asarray(x)[1], ref_sys.frame(ref)))
    got = sys.format_frame(5, jax.tree_util.tree_map(
        lambda x: x[1].numpy(), sys.frame(st)))
    assert got == want
    lines = got.splitlines()
    assert len(lines) == 28 and len(lines[1].split()) == (
        3 if family == "hd" else 4)


def test_3d_trajectory_stores(tmp_path):
    """DAT and BIN trajectories and the last frames of a 3-D LJ run."""
    chains = lj.init_chains(2, 27, rho=0.6, beta=1.0, device="cpu", dim=3)
    pool = (lj.lj_displacement_move(0.1),)
    for fmt in ("dat", "bin"):
        rec = dict(algorithm=tmc.StoreTrajectories,
                   scheduler=np.asarray([5]))
        if fmt == "bin":
            rec["fmt"] = BIN()
        sim = tmc.Simulation(lj.make_system(), chains, [
            dict(algorithm=tmc.Metropolis, pool=pool, seed=1), rec,
            dict(algorithm=tmc.StoreLastFrames)], 5,
            path=str(tmp_path / fmt))
        sim.run()
        st = sim.device_state["sys"]
        if fmt == "dat":
            lines = open(os.path.join(sim.path, "trajectories", "1",
                                      "trajectory.dat")).read().split("\n")
            assert len(lines) == 2 * 28 + 1 and lines[-1] == ""
            assert len(lines[1].split()) == 4    # species + 3 coordinates
        else:
            times, fields = load_chain_major_trajectories(sim.path)
            np.testing.assert_array_equal(times, [0, 5])
            assert fields["pos"].shape == (2, 2, 27, 3)
            np.testing.assert_array_equal(fields["pos"][1], st.pos.numpy())
            np.testing.assert_array_equal(fields["pos"][0],
                                          chains.pos.numpy())
        last = open(os.path.join(sim.path, "trajectories", "2",
                                 "lastframe.dat")).read().splitlines()
        assert last[0].split()[:2] == ["5", "27"] and len(last) == 28
        np.testing.assert_array_equal(
            np.array([ln.split()[1:] for ln in last[1:]], np.float64),
            st.pos[1].numpy().astype(np.float64))


def test_3d_nvt_mixed_pool_cache_and_pressure(tmp_path):
    """Displacement + swap in 3-D on the generic path: the cache exact, the
    acceptance sane, the virial pressure finite; no row kernel and no cell
    plan take the pool (the box is too small for a 3-D grid).  The
    reference's test at 100 steps where it takes 300."""
    chains = lj.init_chains(16, 64, rho=0.7, beta=1.0, frac_b=0.2, seed=5,
                            params=PARAMS, device="cpu", dim=3)
    pool = (lj.lj_displacement_move(0.15, weight=0.9, params=PARAMS),
            lj.lj_swap_move(weight=0.1, params=PARAMS))
    sim = tmc.Simulation(lj.make_system(PARAMS), chains, [
        dict(algorithm=tmc.Metropolis, pool=pool, seed=11, sweepstep=8)],
        100, path=str(tmp_path))
    met = sim.device_algos[0]
    assert not met.supports_fused and met._cell_plan is None
    assert met._row is None
    sim.run()
    st = sim.device_state["sys"]
    np.testing.assert_allclose(st.energy.numpy(),
                               lj.total_energy(st, PARAMS).numpy(),
                               rtol=2e-3, atol=5e-2)
    cnt = sim.device_state["metropolis"]["counters"].sum(0).numpy()
    rates = cnt[:, 0] / cnt[:, 1]
    assert 0.05 < rates[0] < 0.99 and rates[1] > 0
    np.testing.assert_array_equal(st.species.sum(1).numpy(),
                                  chains.species.sum(1).numpy())
    assert bool(torch.isfinite(lj.virial_pressure(st, PARAMS)).all())
    assert not torch.equal(st.pos, chains.pos)
