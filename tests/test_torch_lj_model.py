"""The port's 2-D Lennard-Jones model against the JAX package's, on the
same chains (carried over by ``interop``) and the same actions.

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
from montecarlo_tpu.models import lennard_jones as ref_lj
from montecarlo_tpu_torch import interop
from montecarlo_tpu_torch.models import lennard_jones as lj

RTOL = 1e-6


@functools.lru_cache(maxsize=None)
def _state(m=6, n=32, frac_b=0.25, seed=5, rho=0.6):
    ref = ref_lj.init_chains(m, n, rho=rho, beta=1.3, frac_b=frac_b,
                             seed=seed)
    return ref, interop.chains_from_reference(ref, device="cpu")


@pytest.mark.parametrize("row_batch", [None, 5, 32])
@pytest.mark.parametrize("n,rho", [(32, 0.6), (50, 0.9)])
def test_total_energy_matches_reference(row_batch, n, rho):
    ref, st = _state(n=n, rho=rho)
    params, ref_params = lj.LJParams(), ref_lj.LJParams()
    want = np.asarray(jax.vmap(lambda s: ref_lj.total_energy(
        s, ref_params, row_batch=row_batch))(ref))
    got = lj.total_energy(st, params, row_batch=row_batch)
    assert got.shape == (st.pos.shape[0],) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    np.testing.assert_allclose(st.energy.numpy(), want, rtol=RTOL)


def test_refresh_is_chain_batched_and_matches_total_energy():
    ref, st = _state(m=12, n=40)
    params = lj.LJParams()
    dense = lj.total_energy(st, params)
    stale = dataclasses.replace(st, energy=torch.zeros_like(st.energy))
    np.testing.assert_allclose(
        lj.make_system(params).refresh(stale).energy.numpy(), dense.numpy(),
        rtol=RTOL)
    # a pair budget of 3 chains per batch gives 4 batches; same energies
    np.testing.assert_allclose(
        lj._energies(st, params, 8, 3 * 8 * 40).numpy(), dense.numpy(),
        rtol=RTOL)


def _action(m, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, m).astype(np.int32),
            rng.normal(0, 0.3, (m, 2)).astype(np.float32))


def test_displacement_move_matches_reference():
    ref, st = _state()
    m, n, _ = st.pos.shape
    i, delta = _action(m, n, 1)
    ref_move = ref_lj.lj_displacement_move(0.3)
    move = lj.lj_displacement_move(0.3)
    ref_new, ref_dlogp = jax.vmap(ref_move.move.apply)(
        ref, {"i": jnp.asarray(i), "delta": jnp.asarray(delta)})
    action = {"i": torch.from_numpy(i).long(),
              "delta": torch.from_numpy(delta)}
    new, dlogp = move.move.apply(st, action)
    np.testing.assert_allclose(new.pos.numpy(), np.asarray(ref_new.pos),
                               rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(new.energy.numpy(),
                               np.asarray(ref_new.energy), rtol=RTOL)
    np.testing.assert_allclose(dlogp.numpy(), np.asarray(ref_dlogp),
                               rtol=1e-5, atol=1e-5)
    # the cache stays the full energy
    np.testing.assert_allclose(new.energy.numpy(),
                               lj.total_energy(new, lj.LJParams()).numpy(),
                               rtol=1e-5, atol=1e-4)
    inv = move.move.invert(action, new)
    assert torch.equal(inv["delta"], -action["delta"])
    for pol, ref_pol in ((move.move.policy, ref_move.move.policy),):
        p = {"sigma": torch.tensor(0.3)}
        got = pol.log_density(p, action, st)
        want = jax.vmap(lambda a, s: ref_pol.log_density(
            {"sigma": jnp.float32(0.3)}, a, s))(
            {"i": jnp.asarray(i), "delta": jnp.asarray(delta)}, ref)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(move.move.reward(action, new).numpy(),
                               (delta ** 2).sum(1), rtol=1e-6)
    assert (move.move.kind, move.move.name) == (ref_move.move.kind,
                                                ref_move.move.name)


def test_swap_move_matches_reference():
    ref, st = _state()
    m, n = st.species.shape
    is_b = st.species.numpy() == 1
    rng = np.random.default_rng(2)
    i = np.asarray([rng.choice(np.flatnonzero(~r)) for r in is_b], np.int32)
    j = np.asarray([rng.choice(np.flatnonzero(r)) for r in is_b], np.int32)
    ref_move = ref_lj.lj_swap_move()
    move = lj.lj_swap_move()
    ref_new, ref_dlogp = jax.vmap(ref_move.move.apply)(
        ref, {"i": jnp.asarray(i), "j": jnp.asarray(j)})
    action = {"i": torch.from_numpy(i).long(), "j": torch.from_numpy(j).long()}
    new, dlogp = move.move.apply(st, action)
    np.testing.assert_array_equal(new.species.numpy(),
                                  np.asarray(ref_new.species))
    assert new.species.dtype == torch.int32
    np.testing.assert_allclose(new.energy.numpy(),
                               np.asarray(ref_new.energy), rtol=RTOL)
    np.testing.assert_allclose(dlogp.numpy(), np.asarray(ref_dlogp),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(new.energy.numpy(),
                               lj.total_energy(new, lj.LJParams()).numpy(),
                               rtol=1e-5, atol=1e-4)
    got = move.move.policy.log_density({}, action, st)
    want = jax.vmap(lambda a, s: ref_move.move.policy.log_density(
        {}, a, s))({"i": jnp.asarray(i), "j": jnp.asarray(j)}, ref)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert move.move.invert(action, new) is action


def test_swap_policy_picks_a_uniform_ab_pair():
    _, st = _state(m=4, n=20)
    st = dataclasses.replace(st, species=st.species[:1].expand(4000, -1),
                             pos=st.pos[:1].expand(4000, -1, -1))
    gen = torch.Generator().manual_seed(0)
    action = lj.UniformPairSwap().sample({}, gen, st)
    spc = st.species[0]
    assert torch.all(spc[action["i"]] == 0) and torch.all(
        spc[action["j"]] == 1)
    n_a = int((spc == 0).sum())
    counts = torch.bincount(action["i"], minlength=20)[spc == 0].double()
    # 4000 draws over n_a slots: within 5 binomial sigmas of uniform
    expect = 4000 / n_a
    assert torch.all((counts - expect).abs() < 5 * expect ** 0.5)


def test_system_frame_and_callback_match_reference():
    ref, st = _state()
    ref_sys, sys_ = ref_lj.make_system(), lj.make_system()
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
    assert float(lj.callback_energy_per_particle(view)) == pytest.approx(
        float(ref_lj.callback_energy_per_particle(ref_view)), rel=RTOL)


def test_init_chains_and_interop_round_trip():
    st = lj.init_chains(5, 30, rho=0.7, beta=1.0, frac_b=0.2, seed=3,
                        device="cpu")
    ref = ref_lj.init_chains(5, 30, rho=0.7, beta=1.0, frac_b=0.2, seed=3)
    assert st.pos.shape == (5, 30, 2) and st.species.dtype == torch.int32
    np.testing.assert_array_equal(st.species.numpy(), np.asarray(ref.species))
    np.testing.assert_array_equal(st.box.numpy(), np.asarray(ref.box))
    assert float(st.pos.min()) >= 0 and float(st.pos.max()) < float(st.box[0])
    np.testing.assert_allclose(st.energy.numpy(),
                               lj.total_energy(st, lj.LJParams()).numpy(),
                               rtol=RTOL)
    # the same lattice, each site jittered by at most 0.1 spacing
    box, spacing = float(st.box[0]), float(st.box[0]) / 6
    d = st.pos.numpy() - np.asarray(ref.pos)
    d -= box * np.round(d / box)
    assert np.abs(d).max() <= 0.2 * spacing + 1e-5
    assert np.all(st.energy.numpy() < 0)
    back = interop.chains_to_reference(
        interop.chains_from_reference(ref, device="cpu"))
    assert set(back) == {"pos", "species", "beta", "energy", "box"}
    for k, v in back.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(ref, k)))
    assert back["species"].dtype == np.int32
    again = ref_lj.LJState(**{k: jnp.asarray(v) for k, v in back.items()})
    assert again.pos.shape == ref.pos.shape


def test_params_are_hashable_and_equal_by_value():
    a, b = lj.LJParams(), lj.LJParams()
    assert a == b and hash(a) == hash(b) and a is not b
    assert lj.LJParams(rcut=3.0) != a
    with pytest.raises(dataclasses.FrozenInstanceError):
        a.rcut = 2.0
    s_i = torch.tensor([0, 0, 1, 1])
    s_j = torch.tensor([0, 1, 0, 1])
    eps, sig = a.coeffs(s_i, s_j)
    ref_eps, ref_sig = ref_lj.LJParams().coeffs(jnp.asarray(s_i.numpy()),
                                                jnp.asarray(s_j.numpy()))
    np.testing.assert_array_equal(eps.numpy(), np.asarray(ref_eps))
    np.testing.assert_array_equal(sig.numpy(), np.asarray(ref_sig))
    assert eps.dtype == sig.dtype == torch.float32


def _generic_run(pkg, mod, chains, path, steps=40):
    """The config-5 pool on the generic path; returns (per-move
    acceptance, mean energy per particle over the second half)."""
    pool = (mod.lj_displacement_move(0.1, weight=0.8),
            mod.lj_swap_move(weight=0.2))
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
    """16 chains x 320 attempts of the config-5 pool: acceptance per move
    within MC error of the reference's generic run, and the mean energy per
    particle too."""
    ref, st = _state(m=16, n=32, rho=0.7, frac_b=0.2, seed=9)
    rate, e, sim = _generic_run(tmc, lj, st, str(tmp_path / "port"))
    assert not sim.device_algos[0].supports_fused
    ref_rate, ref_e, _ = _generic_run(mc, ref_lj, ref,
                                      str(tmp_path / "ref"))
    # over six seeds of the port's generator these spread by 0.005
    # (displacement), 0.019 (swap) and 0.018 (energy per particle, std);
    # the bounds are ~3.5 std of the difference of two runs
    assert abs(rate[0] - ref_rate[0]) < 0.03
    assert abs(rate[1] - ref_rate[1]) < 0.10
    assert abs(e - ref_e) < 0.09
    final = sim.device_state["sys"]
    np.testing.assert_allclose(
        final.energy.numpy(), lj.total_energy(final, lj.LJParams()).numpy(),
        rtol=1e-4, atol=1e-3)
    assert torch.equal(final.species.sum(1), st.species.sum(1))
