"""The port's particle-1d model, move protocol and schedules against the
JAX package's, on the same numpy inputs.

Elementwise float32 arithmetic in the same order: equal to float32 ulps of
XLA's and torch's log (rtol 1e-6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlo_tpu as mc
import montecarlo_tpu_torch as tmc
from montecarlo_tpu.core.schedule import compress_runs as ref_compress_runs
from montecarlo_tpu.models import particle1d as ref_p1d
from montecarlo_tpu_torch import interop
from montecarlo_tpu_torch.core.schedule import compress_runs
from montecarlo_tpu_torch.models import particle1d as p1d
from montecarlo_tpu_torch.utils import prng

RTOL = 1e-6


def _state(m=257, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2.5, 2.5, m).astype(np.float32)
    beta = rng.uniform(0.5, 3.0, m).astype(np.float32)
    np_state = {"x": x, "beta": beta, "e": np.asarray(x * x, np.float32)}
    ref = ref_p1d.Particle1DState(**{k: jnp.asarray(v)
                                     for k, v in np_state.items()})
    return np_state, ref, interop.chains_from_reference(np_state, device="cpu")


@pytest.mark.parametrize("name", ["harmonic", "double_well"])
def test_potentials_match_reference(name):
    x = np.random.default_rng(1).uniform(-3, 3, 1000).astype(np.float32)
    want = np.asarray(getattr(ref_p1d, name)(jnp.asarray(x)))
    got = getattr(p1d, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("sigma", [0.1, 0.5, 2.0])
def test_standard_gaussian_log_density_matches_reference(sigma):
    a = np.random.default_rng(2).normal(0, sigma, 500).astype(np.float32)
    params = {"sigma": np.float32(sigma)}
    want = np.asarray(jax.vmap(
        lambda ai: ref_p1d.StandardGaussian().log_density(
            {"sigma": jnp.float32(sigma)}, ai, None))(jnp.asarray(a)))
    got = p1d.StandardGaussian().log_density(
        {"sigma": torch.tensor(params["sigma"])}, torch.from_numpy(a), None)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-6)


def test_standard_gaussian_samples_have_sigma():
    """One draw per chain from its own key: the reference's draws from the
    same keys (within the normal's float32 ulps), and the moments."""
    _, ref, state = _state(m=20000)
    keys = prng.split(prng.key(3, "cpu"), 20000)
    a = p1d.StandardGaussian().sample({"sigma": torch.tensor(0.7)}, keys,
                                      state)
    assert a.shape == state.x.shape
    assert abs(float(a.mean())) < 0.02 and abs(float(a.std()) - 0.7) < 0.02
    want = jax.vmap(ref_p1d.StandardGaussian().sample, (None, 0, 0))(
        {"sigma": jnp.float32(0.7)},
        jax.random.wrap_key_data(jnp.asarray(keys.numpy())), ref)
    np.testing.assert_allclose(a.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("pot", ["harmonic", "double_well"])
def test_displacement_move_matches_reference(pot):
    np_state, ref_state, state = _state()
    delta = np.random.default_rng(4).normal(0, 0.5, 257).astype(np.float32)
    ref_move = ref_p1d.displacement_move(0.5, potential=getattr(ref_p1d, pot))
    move = p1d.displacement_move(0.5, potential=getattr(p1d, pot))
    ref_new, ref_dlogp = jax.vmap(ref_move.move.apply)(ref_state,
                                                       jnp.asarray(delta))
    new, dlogp = move.move.apply(state, torch.from_numpy(delta))
    for k in ("x", "beta", "e"):
        np.testing.assert_allclose(getattr(new, k).numpy(),
                                   np.asarray(getattr(ref_new, k)),
                                   rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(dlogp.numpy(), np.asarray(ref_dlogp),
                               rtol=1e-5, atol=1e-5)
    d = torch.from_numpy(delta)
    assert torch.equal(move.move.invert(d, new), -d)
    assert torch.equal(move.move.reward(d, new), d * d)
    assert move.move.kind == ref_move.move.kind
    assert move.move.name == ref_move.move.name
    assert float(move.params["sigma"]) == float(ref_move.params["sigma"])


def test_system_and_callback_energy_match_reference():
    np_state, ref_state, state = _state()
    ref_sys, sys_ = ref_p1d.make_system(), p1d.make_system()
    assert sys_.name == ref_sys.name
    np.testing.assert_allclose(
        sys_.log_target(state).numpy(),
        np.asarray(jax.vmap(ref_sys.log_target)(ref_state)), rtol=RTOL)
    assert torch.equal(sys_.frame(state), state.x)
    for v in (0.125, np.float32(-1.3), 1e-7):
        assert sys_.format_frame(17, v) == ref_sys.format_frame(17, v)
        line = sys_.format_frame(17, v)
        assert sys_.parse_frame(line) == ref_sys.parse_frame(line)
    view = tmc.SimView(sys=state, params=(), t=0, state={})
    ref_view = mc.SimView(sys=ref_state, params=(), t=0, state={})
    np.testing.assert_allclose(
        float(p1d.callback_energy(view)),
        float(ref_p1d.callback_energy(ref_view)), rtol=RTOL)


def test_generic_apply_matches_reference():
    """A move built from a plain transform + the system's log target gives
    the cached-energy move's delta, in both packages."""
    np_state, ref_state, state = _state()
    delta = np.random.default_rng(6).normal(0, 0.5, 257).astype(np.float32)

    def perform(u):
        return lambda st, d: dataclasses.replace(st, x=st.x + d,
                                                 e=u(st.x + d))

    ref_apply = mc.generic_apply(perform(ref_p1d.harmonic),
                                 ref_p1d.make_system().log_target)
    apply = tmc.generic_apply(perform(p1d.harmonic),
                              p1d.make_system().log_target)
    _, want = jax.vmap(ref_apply)(ref_state, jnp.asarray(delta))
    _, got = apply(state, torch.from_numpy(delta))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    _, cached = p1d.displacement_move(0.5).move.apply(
        state, torch.from_numpy(delta))
    np.testing.assert_allclose(got.numpy(), cached.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_init_chains_and_interop_round_trip():
    state = p1d.init_chains(1000, beta=2.0, seed=5, device="cpu")
    assert state.x.dtype == torch.float32
    assert float(state.x.min()) >= -2.0 and float(state.x.max()) < 2.0
    assert torch.equal(state.e, state.x * state.x)
    assert torch.equal(state.beta, torch.full((1000,), 2.0))
    ref_state = ref_p1d.init_chains(64, beta=1.5, seed=2)
    np_state = interop.chains_to_reference(
        interop.chains_from_reference(ref_state, device="cpu"))
    for k in ("x", "beta", "e"):
        np.testing.assert_array_equal(np_state[k],
                                      np.asarray(getattr(ref_state, k)))


def test_tree_select_and_stack_chains_match_reference():
    np_state, ref_state, state = _state(m=64)
    pred = np.arange(64) % 3 == 0
    other = tmc.tree_select(torch.from_numpy(pred), state,
                            interop.chains_from_reference(
                                {k: -v for k, v in np_state.items()},
                                device="cpu"))
    ref_other = jax.tree_util.tree_map(
        lambda a, b: jnp.where(jnp.asarray(pred), a, b), ref_state,
        jax.tree_util.tree_map(lambda v: -v, ref_state))
    for k in ("x", "beta", "e"):
        np.testing.assert_array_equal(getattr(other, k).numpy(),
                                      np.asarray(getattr(ref_other, k)))
    stacked = tmc.stack_chains([{"x": torch.tensor(1.0)},
                                {"x": torch.tensor(2.0)}])
    assert torch.equal(stacked["x"], torch.tensor([1.0, 2.0]))


@pytest.mark.parametrize("steps,burn,spec", [
    (1000, 0, 10), (1000, 100, 7), (10 ** 5, 1000, 10),
    (1000, 0, 2.0), (12345, 10, 1.5), (1000, 100, [0, 10]),
    (1000, 0, [1, 3, 10, 50]), (97, 5, [0, 1, 2, 40])])
def test_build_schedule_equals_reference(steps, burn, spec):
    want = mc.build_schedule(steps, burn, spec)
    got = tmc.build_schedule(steps, burn, spec)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert compress_runs(got) == ref_compress_runs(want)


def test_schedule_rejects_bad_specs():
    for bad in (True, "10", None):
        with pytest.raises(TypeError):
            tmc.build_schedule(100, 0, bad)
    with pytest.raises(ValueError):
        tmc.build_schedule(100, 0, 1.0)
