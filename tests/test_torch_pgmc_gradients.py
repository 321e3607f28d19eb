"""PGMC's numerical core held to the JAX package on the CPU: the tree order
(dict keys sorted, as ``jax.tree_util`` walks them) and ``ravel``, the
per-chain log densities and their parameter gradients, ``pgmc_estimate``,
the ``GradientData`` monoid and the seven optimisers.

Inputs are made from a numpy seed and go through both packages.  The JAX
side is ``jax.vmap`` over chains of its per-chain functions; the port's
functions take all chains at once.  Tolerances: float32 rtol 1e-5 (the
optimisers 1e-6), float64 1e-10 (the optimisers 1e-12), with an absolute
floor of the same size relative to a field's largest entry, for entries
that cancel to near zero.
"""

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import montecarlo_tpu as mc
import montecarlo_tpu_torch as tmc
from montecarlo_tpu import policy_guided as ref_pg
from montecarlo_tpu.models import lennard_jones as ref_lj
from montecarlo_tpu.models import particle1d as ref_p1d
from montecarlo_tpu_torch import interop
from montecarlo_tpu_torch import policy_guided as pg
from montecarlo_tpu_torch.models import lennard_jones as lj
from montecarlo_tpu_torch.models import particle1d as p1d
from montecarlo_tpu_torch.policy_guided import gradients
from montecarlo_tpu_torch.utils.tree import ravel, tree_leaves, tree_map

M = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test runner runs several files at once, and
    the many small ops here slow down sharply when threads contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    atol = rtol * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


# -- tree order and ravel ------------------------------------------------------

def test_tree_walks_dict_keys_in_jax_order():
    tree = {"sigma": 1.0, "alpha": 2.0,
            "nested": ({"b": 3.0, "a": 4.0}, [5.0, {"z": 6.0, "y": 7.0}])}
    assert tree_leaves(tree) == jax.tree_util.tree_leaves(tree)
    assert tree_leaves({"sigma": 1.0, "alpha": 2.0}) == [2.0, 1.0]
    rebuilt = tree_map(lambda x: x, tree)
    assert list(rebuilt) == ["alpha", "nested", "sigma"]
    assert list(rebuilt) == list(jax.tree_util.tree_map(lambda x: x, tree))


def test_ravel_matches_ravel_pytree():
    rng = np.random.default_rng(0)
    tree = {"sigma": rng.normal(size=(2, 3)).astype(np.float32),
            "alpha": np.float32(rng.normal()),
            "mid": rng.normal(size=(4,)).astype(np.float32)}
    want, _ = ravel_pytree(tree)
    flat, unravel = ravel(tree_map(torch.as_tensor, tree))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(want))
    back = unravel(flat * 2.0)
    for k, v in tree.items():
        assert back[k].shape == v.shape and back[k].dtype == torch.float32
        assert back[k].is_contiguous()
        np.testing.assert_array_equal(back[k].numpy(), 2.0 * v)
    # leading axes of the flat vector are kept in front: per-chain trees
    batch = unravel(torch.stack([flat, 3.0 * flat]))
    assert batch["sigma"].shape == (2, 2, 3) and batch["alpha"].shape == (2,)
    assert batch["sigma"].is_contiguous()
    np.testing.assert_array_equal(batch["mid"][1].numpy(), 3.0 * tree["mid"])
    # one dtype: unravel keeps the vector's dtype, as ravel_pytree's does
    assert unravel(flat.double())["alpha"].dtype == torch.float64


class _Fixed(ref_p1d.StandardGaussian, tmc.Policy):
    """A two-parameter policy: ``sigma`` as the standard Gaussian's, plus an
    ``alpha`` it ignores."""


def _two_key_move(pkg_mod, policy_cls):
    base = pkg_mod.displacement_move(0.5)
    params = {"sigma": base.params["sigma"], "alpha": 2.0 * base.params[
        "sigma"] * 1.5}
    md = dataclasses.replace(base.move, policy=policy_cls(), kind="")
    return type(base)(move=md, params=params, weight=1.0)


def test_two_key_move_writes_the_reference_parameters_line(tmp_path):
    """A move whose parameters have two keys writes the same
    ``parameters.dat`` lines and ``summary.log`` ``Parameters:`` line in
    both packages: values in sorted-key order, ``alpha`` before ``sigma``."""
    ref_chains = ref_p1d.init_chains(4, beta=2.0, seed=1)
    texts = []
    for name, pkg, mod, pol, chains in (
            ("ref", mc, ref_p1d, ref_p1d.StandardGaussian, ref_chains),
            ("port", tmc, p1d, p1d.StandardGaussian,
             interop.chains_from_reference(ref_chains))):
        sim = pkg.Simulation(mod.make_system(), chains, [
            dict(algorithm=pkg.Metropolis, pool=(_two_key_move(mod, pol),),
                 seed=1, fused="off"),
            dict(algorithm=pkg.StoreParameters,
                 dependencies=(pkg.Metropolis,), scheduler=[1, 2]),
        ], 2, path=str(tmp_path / name))
        sim.run()
        params = open(tmp_path / name / "parameters" / "1" /
                      "parameters.dat").read()
        summary = [ln for ln in open(tmp_path / name / "summary.log")
                   if "Parameters:" in ln]
        texts.append((params, summary))
    assert texts[0] == texts[1]
    assert texts[1][0].splitlines()[0] == "0 [1.5, 0.5]"


# -- per-chain log densities and gradients -------------------------------------

def _p1d_states(rng, dtype):
    x = rng.uniform(-1.5, 1.5, M)
    beta = rng.uniform(0.5, 3.0, M)
    np_state = {k: np.asarray(v, dtype)
                for k, v in {"x": x, "beta": beta, "e": x * x}.items()}
    port = p1d.Particle1DState(**{k: torch.from_numpy(v)
                                  for k, v in np_state.items()})
    if dtype == np.float64:     # the float64 tests build theirs under x64
        return None, port
    ref = ref_p1d.Particle1DState(**{k: jnp.asarray(v)
                                     for k, v in np_state.items()})
    return ref, port


def _lj_states(rng):
    ref = ref_lj.init_chains(M, 64, 0.7, 1.0, frac_b=0.2, seed=3)
    return ref, interop.chains_from_reference(ref)


def _case(name, rng, dtype=np.float32):
    """(reference move, port move, reference state, port state, reference
    action, port action, parameters as numpy) for one of the three
    policies, with the action drawn by numpy."""
    if name == "lj":
        ref_st, st = _lj_states(rng)
        i = rng.integers(0, 64, M)
        delta = (0.1 * rng.normal(size=(M, 2))).astype(dtype)
        ref_a = {"i": jnp.asarray(i, jnp.int32), "delta": jnp.asarray(delta)}
        a = {"i": torch.as_tensor(i), "delta": torch.as_tensor(delta)}
        return (ref_lj.lj_displacement_move(0.1), lj.lj_displacement_move(0.1),
                ref_st, st, ref_a, a, {"sigma": np.asarray(0.1, dtype)})
    ref_st, st = _p1d_states(rng, dtype)
    delta = (0.6 * rng.normal(size=M)).astype(dtype)
    if name == "gaussian":
        ref_mv, mv = ref_p1d.displacement_move(0.6), p1d.displacement_move(0.6)
        params = {"sigma": np.asarray(0.6, dtype)}
    else:
        ref_mv, mv = ref_p1d.mala_move(0.2), p1d.mala_move(0.2)
        params = {"step": np.asarray(0.2, dtype)}
    return (ref_mv, mv, ref_st, st, jnp.asarray(delta), torch.as_tensor(delta),
            params)


def _flat(params, dtype):
    ref_flat, ref_unravel = ravel_pytree(
        {k: jnp.asarray(v) for k, v in params.items()})
    flat, unravel = ravel({k: torch.as_tensor(v) for k, v in params.items()})
    return ref_flat, ref_unravel, flat, unravel


POLICIES = ("gaussian", "mala", "lj")


@pytest.mark.parametrize("name", POLICIES)
def test_per_chain_log_density_gradients_match_reference(name):
    rng = np.random.default_rng(11)
    ref_mv, mv, ref_st, st, ref_a, a, params = _case(name, rng)
    ref_flat, ref_unravel, flat, unravel = _flat(params, np.float32)
    pol = ref_mv.move.policy

    def one(s, act):
        return jax.value_and_grad(
            lambda fp: pol.log_density(ref_unravel(fp), act, s))(ref_flat)

    want_q, want_g = jax.vmap(one)(ref_st, ref_a)
    p_rep = gradients._per_sample(flat, M)
    got_q, got_g = gradients._withgrad_log_density(mv.move.policy, p_rep,
                                                   unravel, a, st)
    assert got_g.shape == (M, 1) and not got_q.requires_grad
    _close(got_q, want_q, 1e-5)
    _close(got_g, want_g, 1e-5)
    # each row is its own chain's gradient: chains differ
    assert float(got_g.std()) > 0


@pytest.mark.parametrize("name", POLICIES)
def test_pgmc_estimate_matches_reference(name):
    rng = np.random.default_rng(12)
    ref_mv, mv, ref_st, st, ref_a, a, params = _case(name, rng)
    ref_flat, ref_unravel, flat, unravel = _flat(params, np.float32)
    want = jax.vmap(lambda s, act: ref_pg.pgmc_estimate(
        ref_mv.move, ref_flat, ref_unravel, s, act))(ref_st, ref_a)
    got = pg.pgmc_estimate(mv.move, flat, unravel, st, a)
    for field in ("j", "grad_j", "grad_logq_forward", "g"):
        _close(getattr(got, field), getattr(want, field), 1e-5)
    np.testing.assert_array_equal(got.n.numpy(), np.asarray(want.n))
    assert got.n.dtype == torch.int32
    assert float(got.j.max()) > 0
    # the sum over chains, as the estimator takes it
    total = tree_map(lambda x: x.sum(0).to(x.dtype), got)
    _close(total.grad_j, np.asarray(want.grad_j).sum(0), 1e-5)
    assert int(total.n) == M


def test_pgmc_estimate_needs_a_reward():
    mv = p1d.displacement_move(0.5)
    md = dataclasses.replace(mv.move, reward=None)
    flat, unravel = ravel(mv.params)
    st = p1d.init_chains(4, beta=1.0)
    with pytest.raises(ValueError, match="reward"):
        pg.pgmc_estimate(md, flat, unravel, st, torch.zeros(4))


class _AnalyticGaussian(p1d.StandardGaussian):
    """The standard Gaussian with its analytic parameter gradient, the
    escape hatch past autograd."""

    def grad_log_density(self, params, action, state):
        s = params["sigma"]
        return {"sigma": action * action / (s * s * s) - 1.0 / s}


def test_analytic_gradient_escape_hatch_matches_autograd():
    rng = np.random.default_rng(13)
    _, mv, _, st, _, a, params = _case("gaussian", rng, np.float64)
    flat, unravel = ravel({k: torch.as_tensor(v) for k, v in params.items()})
    p_rep = gradients._per_sample(flat, M)
    q_ad, g_ad = gradients._withgrad_log_density(mv.move.policy, p_rep,
                                                 unravel, a, st)
    q_an, g_an = gradients._withgrad_log_density(_AnalyticGaussian(), p_rep,
                                                 unravel, a, st)
    _close(q_an, q_ad, 1e-12)
    _close(g_an, g_ad, 1e-12)


# -- float64: AD vs analytic vs finite differences, and vs JAX -----------------

TOL = 1e-10


def _ad_grad64(policy, key, value, action, state):
    flat, unravel = ravel({key: torch.tensor(value, dtype=torch.float64)})
    q, g = gradients._withgrad_log_density(
        policy, gradients._per_sample(flat, action.shape[0]), unravel,
        action, state)
    return float(q[0]), float(g[0, 0])


def _fd_grad64(policy, key, value, action, state, h=1e-6):
    up = policy.log_density({key: torch.tensor(value + h, dtype=torch.float64)},
                            action, state)
    dn = policy.log_density({key: torch.tensor(value - h, dtype=torch.float64)},
                            action, state)
    return float(up[0] - dn[0]) / (2.0 * h)


def _jax_grad64(policy, key, value, action, state):
    with jax.enable_x64():
        flat, unravel = ravel_pytree({key: jnp.asarray(value, jnp.float64)})
        q, g = jax.value_and_grad(
            lambda fp: policy.log_density(unravel(fp), action(), state()))(
                flat)
        return float(q), float(g[0])


@pytest.mark.parametrize("sigma,delta", [(0.2, -1.3), (0.7, 0.05),
                                         (1.5, 2.0)])
def test_standard_gaussian_three_way_x64(sigma, delta):
    policy = p1d.StandardGaussian()
    a = torch.tensor([delta], dtype=torch.float64)
    logq, g_ad = _ad_grad64(policy, "sigma", sigma, a, None)
    logq_an = (-delta ** 2 / (2 * sigma ** 2)
               - 0.5 * np.log(2 * np.pi * sigma ** 2))
    g_an = delta ** 2 / sigma ** 3 - 1.0 / sigma
    g_fd = _fd_grad64(policy, "sigma", sigma, a, None)
    assert abs(logq - logq_an) <= TOL * max(1.0, abs(logq_an))
    assert abs(g_ad - g_an) <= TOL * max(1.0, abs(g_an))
    assert abs(g_fd - g_an) <= 1e-8 * max(1.0, abs(g_an))
    ref_q, ref_g = _jax_grad64(
        ref_p1d.StandardGaussian(), "sigma", sigma,
        lambda: jnp.asarray(delta, jnp.float64), lambda: None)
    assert abs(logq - ref_q) <= TOL * max(1.0, abs(ref_q))
    assert abs(g_ad - ref_g) <= TOL * max(1.0, abs(ref_g))


@pytest.mark.parametrize("eps,beta,x,delta", [(0.3, 2.0, 0.7, 0.5),
                                              (0.05, 2.5, -1.2, -0.3),
                                              (1.1, 1.0, 0.0, 0.9)])
def test_langevin_gaussian_three_way_x64(eps, beta, x, delta):
    """The gradient through the MALA drift: with U = x^2,
    d = a + 2 eps beta x and dlogq/deps = -(d * 2 beta x)/(2 eps)
    + d^2/(4 eps^2) - 1/(2 eps)."""
    policy = p1d.LangevinGaussian(p1d.harmonic)
    f64 = lambda v: torch.tensor([v], dtype=torch.float64)
    state = p1d.Particle1DState(x=f64(x), beta=f64(beta), e=f64(x * x))
    logq, g_ad = _ad_grad64(policy, "step", eps, f64(delta), state)
    d = delta + 2.0 * eps * beta * x
    dd = 2.0 * beta * x
    logq_an = -d * d / (4 * eps) - 0.5 * np.log(4 * np.pi * eps)
    g_an = -(d * dd) / (2 * eps) + d * d / (4 * eps ** 2) - 1 / (2 * eps)
    g_fd = _fd_grad64(policy, "step", eps, f64(delta), state)
    assert abs(logq - logq_an) <= TOL * max(1.0, abs(logq_an))
    assert abs(g_ad - g_an) <= TOL * max(1.0, abs(g_an))
    assert abs(g_fd - g_an) <= 1e-6 * max(1.0, abs(g_an))
    ref_q, ref_g = _jax_grad64(
        ref_p1d.LangevinGaussian(ref_p1d.harmonic), "step", eps,
        lambda: jnp.asarray(delta, jnp.float64),
        lambda: ref_p1d.Particle1DState(
            x=jnp.asarray(x, jnp.float64), beta=jnp.asarray(beta, jnp.float64),
            e=jnp.asarray(x * x, jnp.float64)))
    assert abs(logq - ref_q) <= TOL * max(1.0, abs(ref_q))
    assert abs(g_ad - ref_g) <= TOL * max(1.0, abs(ref_g))


@pytest.mark.parametrize("name", ("gaussian", "mala"))
def test_pgmc_estimate_matches_reference_x64(name):
    rng = np.random.default_rng(14)
    ref_mv, mv, _, st, _, a, params = _case(name, rng, np.float64)
    flat, unravel = ravel({k: torch.as_tensor(v) for k, v in params.items()})
    got = pg.pgmc_estimate(mv.move, flat, unravel, st, a)
    with jax.enable_x64():
        ref_st = ref_p1d.Particle1DState(
            **{k: jnp.asarray(getattr(st, k).numpy()) for k in ("x", "beta",
                                                                "e")})
        ref_flat, ref_unravel = ravel_pytree(
            {k: jnp.asarray(v) for k, v in params.items()})
        want = jax.vmap(lambda s, act: ref_pg.pgmc_estimate(
            ref_mv.move, ref_flat, ref_unravel, s, act))(
                ref_st, jnp.asarray(a.numpy()))
        want = jax.tree_util.tree_map(np.asarray, want)
    assert got.j.dtype == torch.float64
    for field in ("j", "grad_j", "grad_logq_forward", "g"):
        _close(getattr(got, field), getattr(want, field), TOL)


def test_pgmc_estimate_x64_internal_consistency():
    """pgmc_estimate in float64 for the MALA move against independently
    recomputed pieces (ref ``pgmc_estimate``, ``gradients.jl:93-109``)."""
    move = p1d.mala_move(step=0.3)
    beta, x0, delta = 2.0, 0.9, -0.4
    f64 = lambda v: torch.tensor([v], dtype=torch.float64)
    state = p1d.Particle1DState(x=f64(x0), beta=f64(beta), e=f64(x0 ** 2))
    flat, unravel = ravel({"step": torch.tensor(0.3, dtype=torch.float64)})
    gd = pg.pgmc_estimate(move.move, flat, unravel, state, f64(delta))
    policy = move.move.policy
    xn = x0 + delta
    st1 = p1d.Particle1DState(x=f64(xn), beta=f64(beta), e=f64(xn ** 2))
    logq_f, g_f = _ad_grad64(policy, "step", 0.3, f64(delta), state)
    logq_b, g_b = _ad_grad64(policy, "step", 0.3, f64(-delta), st1)
    log_ratio = -beta * (xn ** 2 - x0 ** 2) + logq_b - logq_f
    alpha = min(1.0, np.exp(log_ratio))
    j = delta ** 2 * alpha
    g_used = g_f if log_ratio >= 0 else g_b
    assert abs(float(gd.j[0]) - j) <= TOL * max(1.0, abs(j))
    assert abs(float(gd.grad_j[0, 0]) - j * g_used) <= 1e-9
    assert abs(float(gd.grad_logq_forward[0, 0]) - g_f) <= 1e-9
    assert abs(float(gd.g[0, 0, 0]) - g_f ** 2) <= 1e-9


def test_mala_backward_density_uses_new_state():
    """The asymmetry of MALA's proposal, spot-checked analytically."""
    pol = p1d.LangevinGaussian(p1d.harmonic)
    params = {"step": torch.tensor(0.2)}
    f = lambda v: torch.tensor([v])
    st = p1d.Particle1DState(x=f(1.0), beta=f(2.0), e=f(1.0))
    new = p1d.Particle1DState(x=f(1.3), beta=f(2.0), e=f(1.69))
    fwd = float(pol.log_density(params, f(0.3), st)[0])
    bwd = float(pol.log_density(params, f(-0.3), new)[0])
    mu_f, mu_b = -0.2 * 2.0 * 2 * 1.0, -0.2 * 2.0 * 2 * 1.3
    assert abs(fwd - (-((0.3 - mu_f) ** 2) / 0.8
                      - 0.5 * math.log(0.8 * math.pi))) < 1e-5
    assert abs(bwd - (-((-0.3 - mu_b) ** 2) / 0.8
                      - 0.5 * math.log(0.8 * math.pi))) < 1e-5
    assert abs(fwd - bwd) > 0.1


# -- the monoid and the optimisers ---------------------------------------------

def _gd_np(rng, p, dtype):
    a = rng.normal(size=(p, p))
    g = a @ a.T + 0.5 * np.eye(p)         # symmetric positive definite
    return {"j": np.asarray(abs(rng.normal()) + 0.1, dtype),
            "grad_j": rng.normal(size=p).astype(dtype),
            "grad_logq_forward": rng.normal(size=p).astype(dtype),
            "g": g.astype(dtype), "n": np.asarray(7, np.int32)}


def test_gradient_data_monoid_matches_reference():
    rng = np.random.default_rng(15)
    a, b = _gd_np(rng, 2, np.float32), _gd_np(rng, 2, np.float32)
    ref = ref_pg.average(ref_pg.add(
        ref_pg.GradientData(**{k: jnp.asarray(v) for k, v in a.items()}),
        ref_pg.GradientData(**{k: jnp.asarray(v) for k, v in b.items()})))
    got = pg.average(pg.add(
        pg.GradientData(**{k: torch.as_tensor(v) for k, v in a.items()}),
        pg.GradientData(**{k: torch.as_tensor(v) for k, v in b.items()})))
    for f in ("j", "grad_j", "grad_logq_forward", "g", "n"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)))
    zero = pg.init_gradient_data(3)
    want = ref_pg.init_gradient_data(3)
    for f in ("j", "grad_j", "grad_logq_forward", "g", "n"):
        x = getattr(zero, f)
        assert x.shape == getattr(want, f).shape
        assert str(x.dtype).replace("torch.", "") == str(getattr(want,
                                                                 f).dtype)


OPTIMISERS = (("Static", ()), ("VPG", (0.01,)), ("BLPG", (0.01,)),
              ("BLAPG", (1e-4, 1e-6)), ("NPG", (1e-2, 1e-6)),
              ("ANPG", (1e-4, 1e-6)), ("BLANPG", (1e-4, 1e-6)))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("name,args", OPTIMISERS)
def test_optimisers_match_reference(name, args, p, dtype):
    """Each optimiser on the same GradientData, at P = 1 (the scalar path of
    ``_inv_reg``) and P = 2 (an SPD g, anisotropic parameters: the matrix
    inverse the reference never runs end to end)."""
    rng = np.random.default_rng(16 + p)
    np_dt = np.dtype(dtype)
    gd = _gd_np(rng, p, np_dt)
    theta = np.asarray([0.3, 1.7][:p], np_dt)
    tol = 1e-6 if dtype == "float32" else 1e-12
    with jax.enable_x64(dtype == "float64"):
        ref_gd = ref_pg.GradientData(**{k: jnp.asarray(v)
                                        for k, v in gd.items()})
        want = np.asarray(ref_pg.learning_step(
            getattr(ref_pg, name)(*args), jnp.asarray(theta), ref_gd))
    got = pg.learning_step(
        getattr(pg, name)(*args), torch.as_tensor(theta),
        pg.GradientData(**{k: torch.as_tensor(v) for k, v in gd.items()}))
    assert got.dtype == getattr(torch, dtype) and want.dtype == np_dt
    _close(got.numpy(), want, tol)
    if name == "Static":
        np.testing.assert_array_equal(got.numpy(), theta)
    else:
        assert not np.array_equal(got.numpy(), theta)
