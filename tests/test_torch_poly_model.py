"""The port's 2-D polydisperse soft-sphere model against the JAX package's,
on the same chains (carried over by ``interop``) and the same actions.

Energies: elementwise float32 arithmetic in the reference's order, summed
in torch's order instead of XLA's, so rtol 1e-6.  The generic path
(``fused='off'``) draws from a ``torch.Generator``, not the reference's
threefry keys, so it is held to the reference's generic path by statistics:
acceptance per move and mean energy per particle within Monte Carlo error.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlo_tpu as mc
import montecarlo_tpu_torch as tmc
from montecarlo_tpu.models import polydisperse as ref_poly
from montecarlo_tpu_torch import interop
from montecarlo_tpu_torch.models import polydisperse as poly

RTOL = 1e-6


@functools.lru_cache(maxsize=None)
def _state(m=6, n=32, seed=5, rho=0.9, beta=1.3):
    ref = ref_poly.init_chains(m, n, rho=rho, beta=beta, seed=seed)
    return ref, interop.chains_from_reference(ref, device="cpu")


def test_smoothing_coefficients_and_diameters_equal_reference():
    for xc in (1.25, 1.5, 2.0):
        assert poly._smoothing_coeffs(xc) == ref_poly._smoothing_coeffs(xc)
    p, ref_p = poly.PolyParams(), ref_poly.PolyParams()
    assert p.coeffs() == ref_p.coeffs()
    other = poly.PolyParams(d_min=0.8, d_max=1.4)
    ref_other = ref_poly.PolyParams(d_min=0.8, d_max=1.4)
    for n, seed in ((1, 0), (32, 6), (1000, 11)):
        for params, ref_params in ((p, ref_p), (other, ref_other)):
            got = poly.sample_diameters(n, params, seed=seed)
            want = ref_poly.sample_diameters(n, ref_params, seed=seed)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32))
    d = poly.sample_diameters(10000, p, seed=1)
    assert d.min() >= p.d_min and d.max() <= p.d_max


@pytest.mark.parametrize("row_batch", [None, 5, 32])
@pytest.mark.parametrize("n,rho", [(32, 0.9), (50, 1.1)])
def test_total_energy_matches_reference(row_batch, n, rho):
    ref, st = _state(n=n, rho=rho)
    params, ref_params = poly.PolyParams(), ref_poly.PolyParams()
    want = np.asarray(jax.vmap(lambda s: ref_poly.total_energy(
        s, ref_params, row_batch=row_batch))(ref))
    got = poly.total_energy(st, params, row_batch=row_batch)
    assert got.shape == (st.pos.shape[0],) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    np.testing.assert_allclose(st.energy.numpy(), want, rtol=RTOL)


def test_refresh_is_chain_batched_and_matches_total_energy():
    _, st = _state(m=12, n=40)
    params = poly.PolyParams()
    dense = poly.total_energy(st, params)
    stale = dataclasses.replace(st, energy=torch.zeros_like(st.energy))
    np.testing.assert_allclose(
        poly.make_system(params).refresh(stale).energy.numpy(),
        dense.numpy(), rtol=RTOL)
    # a pair budget of 3 chains per batch gives 4 batches; same energies
    np.testing.assert_allclose(
        poly._energies(st, params, 8, 3 * 8 * 40).numpy(), dense.numpy(),
        rtol=RTOL)


def _action(m, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, m).astype(np.int32),
            rng.normal(0, 0.2, (m, 2)).astype(np.float32))


def test_displacement_move_matches_reference():
    ref, st = _state()
    m, n, _ = st.pos.shape
    i, delta = _action(m, n, 1)
    ref_move = ref_poly.displacement_move(0.2)
    move = poly.displacement_move(0.2)
    ref_new, ref_dlogp = jax.vmap(ref_move.move.apply)(
        ref, {"i": jnp.asarray(i), "delta": jnp.asarray(delta)})
    action = {"i": torch.from_numpy(i).long(),
              "delta": torch.from_numpy(delta)}
    new, dlogp = move.move.apply(st, action)
    np.testing.assert_allclose(new.pos.numpy(), np.asarray(ref_new.pos),
                               rtol=RTOL, atol=1e-6)
    np.testing.assert_array_equal(new.diam.numpy(), np.asarray(ref_new.diam))
    np.testing.assert_allclose(new.energy.numpy(),
                               np.asarray(ref_new.energy), rtol=RTOL)
    np.testing.assert_allclose(dlogp.numpy(), np.asarray(ref_dlogp),
                               rtol=1e-5, atol=1e-5)
    # the cache stays the full energy
    np.testing.assert_allclose(new.energy.numpy(),
                               poly.total_energy(new).numpy(), rtol=1e-5,
                               atol=1e-4)
    inv = move.move.invert(action, new)
    assert torch.equal(inv["delta"], -action["delta"])
    p = {"sigma": torch.tensor(0.2)}
    got = move.move.policy.log_density(p, action, st)
    want = jax.vmap(lambda a, s: ref_move.move.policy.log_density(
        {"sigma": jnp.float32(0.2)}, a, s))(
        {"i": jnp.asarray(i), "delta": jnp.asarray(delta)}, ref)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(move.move.reward(action, new).numpy(),
                               (delta ** 2).sum(1), rtol=1e-6)
    assert (move.move.kind, move.move.name, move.move.aux) == (
        ref_move.move.kind, ref_move.move.name, poly.PolyParams())


def test_swap_move_matches_reference():
    ref, st = _state()
    m, n = st.diam.shape
    rng = np.random.default_rng(2)
    i = rng.integers(0, n, m).astype(np.int32)
    j = ((i + rng.integers(1, n, m)) % n).astype(np.int32)     # j != i
    ref_move = ref_poly.swap_move()
    move = poly.swap_move()
    ref_new, ref_dlogp = jax.vmap(ref_move.move.apply)(
        ref, {"i": jnp.asarray(i), "j": jnp.asarray(j)})
    action = {"i": torch.from_numpy(i).long(), "j": torch.from_numpy(j).long()}
    new, dlogp = move.move.apply(st, action)
    np.testing.assert_array_equal(new.diam.numpy(), np.asarray(ref_new.diam))
    assert torch.equal(new.pos, st.pos)
    np.testing.assert_allclose(new.energy.numpy(),
                               np.asarray(ref_new.energy), rtol=RTOL)
    np.testing.assert_allclose(dlogp.numpy(), np.asarray(ref_dlogp),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(new.energy.numpy(),
                               poly.total_energy(new).numpy(), rtol=1e-5,
                               atol=1e-4)
    got = move.move.policy.log_density({}, action, st)
    want = jax.vmap(lambda a, s: ref_move.move.policy.log_density(
        {}, a, s))({"i": jnp.asarray(i), "j": jnp.asarray(j)}, ref)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert move.move.invert(action, new) is action
    assert (move.move.kind, move.move.name) == (ref_move.move.kind,
                                                ref_move.move.name)


def test_uniform_pair_gives_distinct_uniform_pairs():
    _, st = _state(m=4, n=12)
    st = dataclasses.replace(st, diam=st.diam[:1].expand(6000, -1),
                             pos=st.pos[:1].expand(6000, -1, -1))
    gen = torch.Generator().manual_seed(0)
    action = poly.UniformPair().sample({}, gen, st)
    i, j = action["i"], action["j"]
    assert torch.all(i != j) and int(i.min()) >= 0 and int(j.max()) < 12
    # 6000 draws over 12 slots each: within 5 binomial sigmas of uniform
    expect = 6000 / 12
    for idx in (i, j):
        counts = torch.bincount(idx, minlength=12).double()
        assert torch.all((counts - expect).abs() < 5 * expect ** 0.5)
    # and j is uniform over the other 11 slots given i
    pairs = torch.bincount(i * 12 + j, minlength=144).view(12, 12).double()
    assert torch.all(pairs.diagonal() == 0)
    off = pairs[~torch.eye(12, dtype=torch.bool)]
    assert (off - 6000 / 132).abs().max() < 5 * (6000 / 132) ** 0.5


def test_system_frame_and_callback_match_reference():
    ref, st = _state()
    ref_sys, sys_ = ref_poly.make_system(), poly.make_system()
    assert sys_.name == ref_sys.name
    np.testing.assert_allclose(
        sys_.log_target(st).numpy(),
        np.asarray(jax.vmap(ref_sys.log_target)(ref)), rtol=RTOL)
    frame = {k: v[2].numpy() for k, v in sys_.frame(st).items()}
    ref_frame = {k: np.asarray(v)[2]
                 for k, v in jax.vmap(ref_sys.frame)(ref).items()}
    assert sys_.format_frame(40, frame) == ref_sys.format_frame(40, ref_frame)
    view = tmc.SimView(sys=st, params=(), t=0, state={})
    ref_view = mc.SimView(sys=ref, params=(), t=0, state={})
    assert float(poly.callback_energy_per_particle(view)) == pytest.approx(
        float(ref_poly.callback_energy_per_particle(ref_view)), rel=RTOL)


def test_init_chains_and_interop_round_trip():
    st = poly.init_chains(5, 30, rho=0.9, beta=2.0, seed=3, device="cpu")
    ref = ref_poly.init_chains(5, 30, rho=0.9, beta=2.0, seed=3)
    assert st.pos.shape == (5, 30, 2) and st.diam.dtype == torch.float32
    np.testing.assert_array_equal(st.diam.numpy(), np.asarray(ref.diam))
    np.testing.assert_array_equal(st.box.numpy(), np.asarray(ref.box))
    np.testing.assert_array_equal(st.beta.numpy(), np.asarray(ref.beta))
    assert float(st.pos.min()) >= 0 and float(st.pos.max()) < float(st.box[0])
    np.testing.assert_allclose(st.energy.numpy(),
                               poly.total_energy(st).numpy(), rtol=RTOL)
    # the same lattice, each site jittered by at most 0.1 spacing
    box, spacing = float(st.box[0]), float(st.box[0]) / 6
    d = st.pos.numpy() - np.asarray(ref.pos)
    d -= box * np.round(d / box)
    assert np.abs(d).max() <= 0.2 * spacing + 1e-5
    back = interop.chains_to_reference(
        interop.chains_from_reference(ref, device="cpu"))
    assert set(back) == {"pos", "diam", "beta", "energy", "box"}
    for k, v in back.items():
        assert v.dtype == np.float32
        np.testing.assert_array_equal(v, np.asarray(getattr(ref, k)))
    again = ref_poly.PolyState(**{k: jnp.asarray(v) for k, v in back.items()})
    assert again.pos.shape == ref.pos.shape
    # a mapping with the same fields is told apart by its diam
    assert isinstance(interop.chains_from_reference(back, device="cpu"),
                      poly.PolyState)


def test_params_are_hashable_and_equal_by_value():
    a, b = poly.PolyParams(), poly.PolyParams()
    assert a == b and hash(a) == hash(b) and a is not b
    assert poly.PolyParams(eps=0.1) != a
    with pytest.raises(dataclasses.FrozenInstanceError):
        a.eps = 0.3
    assert dataclasses.asdict(a) == dataclasses.asdict(ref_poly.PolyParams())


def _generic_run(pkg, mod, chains, path, steps=40):
    """The swap-MC pool on the generic path; returns (per-move acceptance,
    mean energy per particle over the second half, simulation)."""
    pool = (mod.displacement_move(0.1, weight=0.8),
            mod.swap_move(weight=0.2))
    sched = np.arange(2, steps + 1, 2)
    sim = pkg.Simulation(mod.make_system(), chains, [
        dict(algorithm=pkg.Metropolis, pool=pool, seed=11, sweepstep=8,
             fused="off"),
        dict(algorithm=pkg.StoreCallbacks,
             callbacks=(mod.callback_energy_per_particle,),
             scheduler=sched)], steps, path=path)
    sim.run()
    cnt = np.asarray(sim.device_state["metropolis"]["counters"]).sum(0)
    e = np.loadtxt(os.path.join(path, "energy_per_particle.dat"))
    return cnt[:, 0] / cnt[:, 1], e[len(e) // 2:, 1].mean(), sim


def test_generic_path_matches_reference_statistics(tmp_path):
    """16 chains x 320 attempts of the swap-MC pool at rho 0.9, beta 2:
    acceptance per move within MC error of the reference's generic run, and
    the mean energy per particle too."""
    ref, st = _state(m=16, n=32, rho=0.9, beta=2.0, seed=9)
    rate, e, sim = _generic_run(tmc, poly, st, str(tmp_path / "port"))
    assert not sim.device_algos[0].supports_fused
    ref_rate, ref_e, _ = _generic_run(mc, ref_poly, ref,
                                      str(tmp_path / "ref"))
    # over six seeds of the port's generator these spread by 0.0047
    # (displacement), 0.019 (swap) and 0.090 (energy per particle, std; the
    # chains are still relaxing from the lattice); the bounds are ~3.5 std
    # of the difference of two runs
    assert abs(rate[0] - ref_rate[0]) < 0.03
    assert abs(rate[1] - ref_rate[1]) < 0.10
    assert abs(e - ref_e) < 0.45
    final = sim.device_state["sys"]
    np.testing.assert_allclose(final.energy.numpy(),
                               poly.total_energy(final).numpy(), rtol=1e-4,
                               atol=1e-3)
    assert torch.equal(final.diam.sort(1).values, st.diam.sort(1).values)
