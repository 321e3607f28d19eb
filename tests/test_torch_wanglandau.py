"""Wang-Landau in the port (``core/wanglandau.py``, ``ising2d.wl_model``)
against the JAX package's.

Equal outright, the reference's draws fed in (per chain ``fold_in(key,
t)``, ``split`` into the step's proposals, each ``split`` into the site's
``randint`` and the acceptance's ``uniform`` from the smallest normal
float32 up): five consecutive steps of 16 proposals (spins, energies,
``log_g``, ``hist`` and ``visited``), one ``WangLandauRefine`` call on
flat, unflat and not-covering walkers, and the estimators ``mean_log_g``
and ``reweight``; the slice carried both ways by ``interop``.

Mirrored gates of ``tests/test_wanglandau.py`` run the port alone in its
bands.  The density-of-states gate is cut from the reference's 4 x 4
lattice (4 walkers, 60,000 steps of 16 proposals, ~10^6 proposals a
walker) to the 3 x 3 lattice against ``exact_log_g(3)``: 3,000 steps of 9
proposals, refinement every 250 steps, with the reference's bands (max
|d log g| < 0.35, <E> within 2 % and var E within 12 % at beta 0.2,
0.4407 and 1.0, every walker's log f < 0.01).  It averages 32 walkers, not
4: with 4 walkers and 4,000 steps one of the three seeds tried put <E> at
beta 0.2 2.6 % off (the walkers' log f had reached 1e-4; the error is the
estimate's, from its early large-f stages), and a step costs nearly the
same for 32 walkers as for 4.  The full 4 x 4 gate runs on the card
(``chip_smoke.py`` phase 12d).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlo_tpu as mc
import montecarlo_tpu_torch as tmc
from montecarlo_tpu.core import wanglandau as ref_wl
from montecarlo_tpu.models import ising2d as ref_i2
from montecarlo_tpu_torch import interop
from montecarlo_tpu_torch.core.wanglandau import (_flatness, mean_log_g,
                                                  refine, reweight, wl_step)
from montecarlo_tpu_torch.models import ising2d
from torch_ecmc_helpers import T
from torch_lattice_helpers import (TINY, _one_torch_thread,  # noqa: F401
                                   carry, warm_up_transcendentals)

warm_up_transcendentals()


def _ref_walker(m, size, moves, seed, log_f_min=1e-4):
    like = types.SimpleNamespace(n_chains=m)
    walker = ref_wl.WangLandau(like, model=ref_i2.wl_model(size),
                               moves_per_step=moves, seed=seed)
    refiner = ref_wl.WangLandauRefine(like, flatness=0.8,
                                      log_f_min=log_f_min,
                                      dependencies=(walker,))
    return walker, refiner


def _ref_draws(keys, t, moves, n):
    """The sites and uniforms the reference's step ``t`` draws."""
    step = jax.vmap(jax.random.fold_in, (0, None))(keys, jnp.uint32(t))
    per = jax.vmap(lambda k: jax.random.split(k, moves))(step)
    pa = jax.vmap(jax.vmap(jax.random.split))(per)
    site = jax.vmap(jax.vmap(lambda k: jax.random.randint(k, (), 0, n)))(
        pa[:, :, 0])
    u = jax.vmap(jax.vmap(lambda k: jax.random.uniform(
        k, (), jnp.float32, minval=TINY)))(pa[:, :, 1])
    return T(site).long(), T(u)


def _same(got, want, names=("log_g", "hist", "visited", "log_f")):
    for k in names:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_wl_steps_equal_the_reference():
    m, size, moves = 6, 4, 16
    walker, _ = _ref_walker(m, size, moves, seed=3)
    ref_sys = ref_i2.init_chains(m, size, beta=1.0, seed=3)
    slc = walker.init_state(None)
    # log f 1 for three walkers, smaller for the others: the acceptances
    # then test sums of unequal powers of two
    slc = {**slc, "log_f": jnp.asarray([1.0, 1.0, 1.0, 0.5, 0.125, 0.03125],
                                       jnp.float32)}
    model = ising2d.wl_model(size)
    st = carry(ref_sys, ising2d.Ising2DState)
    mine = interop.slice_from_reference(
        "wang_landau", {k: np.asarray(v) for k, v in slc.items()
                        if k != "keys"},
        {"log_g": torch.zeros(m, size * size + 1),
         "hist": torch.zeros(m, size * size + 1, dtype=torch.int32),
         "visited": torch.zeros(m, size * size + 1, dtype=torch.int32),
         "log_f": torch.zeros(m)})
    ds = {"sys": ref_sys, "wang_landau": slc}
    accepted = 0
    for t in range(1, 6):
        sites, u = _ref_draws(slc["keys"], t, moves, size * size)
        ds = walker.step(ds, jnp.int32(t))
        before = st.spins.clone()
        st, log_g, hist, visited = wl_step(
            model, st, mine["log_g"], mine["hist"], mine["visited"],
            mine["log_f"], sites, u)
        accepted += int((st.spins != before).sum())
        mine = {**mine, "log_g": log_g, "hist": hist, "visited": visited}
        _same(mine, ds["wang_landau"])
        np.testing.assert_array_equal(st.spins.numpy(),
                                      np.asarray(ds["sys"].spins))
        np.testing.assert_array_equal(st.energy.numpy(),
                                      np.asarray(ds["sys"].energy))
    assert 0 < accepted < 5 * moves * m
    back = interop.slice_to_reference("wang_landau", mine)
    assert set(back) == {"log_g", "hist", "visited", "log_f"}
    assert back["hist"].dtype == np.int32


def test_refine_equals_the_reference():
    m, nb = 6, 17
    _, refiner = _ref_walker(m, 4, 16, seed=1, log_f_min=1e-3)
    hist = np.zeros((m, nb), np.int32)
    visited = np.zeros((m, nb), np.int32)
    hist[0, :4] = [100, 95, 105, 99]           # flat
    hist[1, :4] = [100, 5, 100, 100]           # not flat
    hist[2, :2] = [100, 100]                   # flat, but misses a bin
    visited[2, :3] = 1
    hist[3, 5:8] = [10, 9, 11]                 # flat, log f at the floor
    hist[5, :3] = [80, 100, 120]               # min/mean 0.8 exactly
    visited = np.maximum(visited, hist)
    slc = {"log_g": np.zeros((m, nb), np.float32), "hist": hist,
           "visited": visited,
           "log_f": np.asarray([1.0, 1.0, 1.0, 1.5e-3, 0.5, 0.25],
                               np.float32)}
    want = refiner._refine({k: jnp.asarray(v) for k, v in slc.items()})
    got = refine({k: torch.as_tensor(v) for k, v in slc.items()}, 0.8, 1e-3)
    _same(got, want)
    np.testing.assert_array_equal(
        got["log_f"].numpy(),
        np.float32([0.5, 1.0, 1.0, 1e-3, 0.5, 0.125]))


def test_estimators_equal_the_reference():
    rng = np.random.default_rng(4)
    slc = {"log_g": rng.normal(size=(5, 17)).astype(np.float32),
           "visited": rng.integers(0, 3, size=(5, 17)).astype(np.int32)}
    slc["visited"][:, 0] = [1, 0, 2, 1, 0]
    got = mean_log_g({k: torch.as_tensor(v) for k, v in slc.items()}, 0,
                     np.log(2.0))
    want = ref_wl.mean_log_g(slc, 0, np.log(2.0))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    energies = ising2d.wl_bin_energies(4)
    exact = ising2d.exact_log_g(4)
    for beta in (0.2, 0.44, 1.0):
        assert reweight(exact, energies, beta) == ref_wl.reweight(
            exact, energies, beta)
    with pytest.raises(ValueError, match="anchor bin"):
        mean_log_g({"log_g": torch.zeros(2, 3),
                    "visited": torch.zeros(2, 3, dtype=torch.int32)}, 0)


def test_bin_index_and_proposal_equal_the_reference():
    m, size = 8, 4
    ref = ref_i2.init_chains(m, size, beta=1.0, seed=9)
    ref_model, model = ref_i2.wl_model(size), ising2d.wl_model(size)
    want = jax.vmap(lambda s, k: ref_model.propose(s, k))(
        ref, jax.random.split(jax.random.key(0), m))
    # the reference draws its site inside; recover it from its flip
    flipped = np.argwhere((np.asarray(want.spins) != np.asarray(ref.spins))
                          .reshape(m, -1))
    site = flipped[np.argsort(flipped[:, 0]), 1]
    got = model.propose(carry(ref, ising2d.Ising2DState),
                        torch.as_tensor(site))
    np.testing.assert_array_equal(got.spins.numpy(), np.asarray(want.spins))
    np.testing.assert_array_equal(got.energy.numpy(), np.asarray(want.energy))
    np.testing.assert_array_equal(
        model.bin_index(got).numpy(),
        np.asarray(jax.vmap(ref_model.bin_index)(want)))
    assert model.n_bins == ref_model.n_bins == size * size + 1
    half = ising2d.Ising2DState(
        spins=got.spins, beta=got.beta, j=got.j,
        energy=torch.full((m,), -2.0 * size * size + 2.0))
    # E + 2 N j = 2: the bin 0.5 rounds half to even, as jnp.round does
    assert (model.bin_index(half) == 0).all()


# -- mirrored gates: tests/test_wanglandau.py -----------------------------------

def test_flatness_ignores_unvisited_bins():
    h = torch.as_tensor([[100, 0, 90, 110, 0]], dtype=torch.int32)
    assert np.isclose(_flatness(h).numpy()[0], 90.0 / 100.0)


def test_flatness_zero_when_empty():
    assert np.allclose(_flatness(torch.zeros((2, 5), dtype=torch.int32))
                       .numpy(), 0.0)


def _make_sim(steps, n_chains, path, size=4, seed=3, interval=250):
    chains = ising2d.init_chains(n_chains, size=size, beta=1.0, seed=seed,
                                 device="cpu")
    refine_sched = np.arange(interval, steps + 1, interval, dtype=np.int64)
    return tmc.Simulation(
        ising2d.make_system(), chains,
        [dict(algorithm=tmc.WangLandau, model=ising2d.wl_model(size),
              moves_per_step=size * size, seed=seed),
         dict(algorithm=tmc.WangLandauRefine, flatness=0.8, log_f_min=1e-4,
              dependencies=(tmc.WangLandau,),
              scheduler=refine_sched if len(refine_sched) else None),
         dict(algorithm=tmc.StoreCallbacks,
              callbacks=(tmc.callback_wl_log_f, tmc.callback_wl_flatness),
              scheduler=tmc.build_schedule(steps, 0, interval))],
        steps, path=str(path))


def test_refine_halves_only_flat_chains(tmp_path):
    sim = _make_sim(steps=1, n_chains=2, path=tmp_path)
    walker, refiner = sim.algorithms[0], sim.algorithms[1]
    slc = walker.init_state(sim)
    hist = torch.zeros((2, walker.model.n_bins), dtype=torch.int32)
    hist[0, :3] = torch.as_tensor([100, 95, 105])
    hist[1, :3] = torch.as_tensor([100, 5, 100])
    sim.device_state = {**sim.init_device_state(),
                        "wang_landau": {**slc, "hist": hist}}
    refiner.make_step(sim, 1)
    out = sim.device_state["wang_landau"]
    assert np.allclose(out["log_f"].numpy(), [0.5, 1.0])
    assert int(out["hist"][0].sum()) == 0 and int(out["hist"][1].sum()) == 205


def test_wl_matches_exact_density_of_states(tmp_path):
    size, steps = 3, 3000
    sim = _make_sim(steps=steps, n_chains=32, path=tmp_path, size=size)
    sim.run()
    slc = sim.device_state["wang_landau"]
    assert float(slc["log_f"].max()) < 0.01
    log_g, support = mean_log_g(slc, anchor_bin=0, anchor_log_g=np.log(2.0))
    exact = ising2d.exact_log_g(size)
    assert np.array_equal(support, np.isfinite(exact))
    err = np.abs(log_g[support] - exact[support])
    assert err.max() < 0.35, f"max |dlog g| = {err.max()}"
    energies = ising2d.wl_bin_energies(size)
    for beta in (0.2, 0.4406868, 1.0):
        _, e_wl, var_wl = reweight(log_g, energies, beta)
        _, e_ex, var_ex = reweight(exact, energies, beta)
        assert abs(e_wl - e_ex) / abs(e_ex) < 0.02
        assert abs(var_wl - var_ex) / max(var_ex, 1.0) < 0.12
    log_f = np.loadtxt(tmp_path / "wl_log_f.dat")
    assert log_f[0, 1] == 1.0 and log_f[-1, 1] < 0.01
    assert (tmp_path / "wl_flatness.dat").exists()


def test_wl_summary_written(tmp_path):
    sim = _make_sim(steps=250, n_chains=2, path=tmp_path, interval=250)
    sim.run()
    text = (tmp_path / "summary.log").read_text()
    assert "WangLandau" in text and "WangLandauRefine" in text
    assert "Flatness criterion" in text and "Final log f floor" in text


def test_callbacks_follow_the_reference():
    for key in ("wang_landau", "wang_landau_1"):
        mine = tmc.wl_callbacks(key)
        ref = mc.wl_callbacks(key)
        assert [f.__name__ for f in mine] == [f.__name__ for f in ref]
    assert tmc.callback_wl_log_f.__name__ == "callback_wl_log_f"
    with pytest.raises(ValueError, match="dependencies"):
        tmc.WangLandauRefine(None)


def test_wl_resumes_bit_for_bit(tmp_path):
    """A run cut after a backup and resumed in a fresh ``Simulation``
    equals the uncut run: walkers, histograms, spins and the keys."""
    def build(path, steps=60):
        chains = ising2d.init_chains(4, 3, beta=1.0, seed=3, device="cpu")
        return tmc.Simulation(ising2d.make_system(), chains, [
            dict(algorithm=tmc.WangLandau, model=ising2d.wl_model(3),
                 moves_per_step=9, seed=3),
            dict(algorithm=tmc.WangLandauRefine,
                 dependencies=(tmc.WangLandau,),
                 scheduler=np.arange(20, steps + 1, 20)),
            dict(algorithm=tmc.StoreBackups, scheduler=[30])],
            steps, path=str(path))

    whole = build(tmp_path / "whole")
    whole.run()
    resumed = build(tmp_path / "resumed")
    tmc.checkpoint.resume_state(
        resumed, str(tmp_path / "whole" / "checkpoints" / "ckpt_t30.npz"))
    assert resumed.t == 30
    resumed.run()
    a, b = whole.device_state, resumed.device_state
    for k in ("log_g", "hist", "visited", "log_f"):
        assert torch.equal(a["wang_landau"][k], b["wang_landau"][k]), k
    assert torch.equal(a["sys"].spins, b["sys"].spins)
    assert torch.equal(a["wang_landau"]["keys"], b["wang_landau"]["keys"])
