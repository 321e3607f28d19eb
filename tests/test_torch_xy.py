"""The XY model in the port (``models/xy.py``) against the JAX package's.

Value for value, the reference's draws fed in (derived from each chain's
key as the reference's sweep derives them): one checkerboard sweep (angles
equal where both accept alike, which an accepted rotation's plain
arithmetic makes exact; energies within rtol 1e-5, the sum order differing)
and each over-relaxation half-sweep (angles within 2e-6 + 2e-6 / |h| on
the circle: the field's ulps through ``atan2``), one generic rotation of
each policy on the same action,
and the policies' log densities and the Gaussian's score through
``torch.autograd``.

Mirrored gates of ``tests/test_xy.py`` run the port alone, each at its
reference test's size and in its band.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlo_tpu_torch as tmc
from montecarlo_tpu.models import xy as ref_xy
from montecarlo_tpu_torch import interop
from montecarlo_tpu_torch.models import xy
from torch_lattice_helpers import (_one_torch_thread, carry,  # noqa: F401
                                   ref_keys, vsplit, vuniform,
                                   warm_up_transcendentals)

warm_up_transcendentals()
FIELDS = ("theta", "beta", "j", "energy")
BETA = 0.8


def _carry(ref):
    return carry(ref, xy.XYState, FIELDS)


def _circle_err(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return np.abs(np.angle(np.exp(1j * d))).max()


# -- interop and init -----------------------------------------------------------

def test_state_roundtrip_and_init():
    ref = ref_xy.init_chains(3, 4, beta=0.5, seed=1)
    st = interop.chains_from_reference(
        {k: np.asarray(getattr(ref, k)) for k in FIELDS}, device="cpu")
    assert type(st) is xy.XYState and st.theta.dtype == torch.float32
    back = ref_xy.XYState(**interop.chains_to_reference(st))
    for k in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(back, k)),
                                      np.asarray(getattr(ref, k)))
    mine = xy.init_chains(4, 6, beta=0.5, seed=2, device="cpu")
    assert mine.theta.device.type == "cpu"
    assert float(mine.theta.min()) >= 0 and float(mine.theta.max()) < 2 * np.pi
    want = jax.vmap(lambda s: ref_xy._bond_energy(s.theta, s.j))(
        ref_xy.XYState(**{k: jnp.asarray(v) for k, v in
                          interop.chains_to_reference(mine).items()}))
    np.testing.assert_allclose(mine.energy.numpy(), np.asarray(want),
                               rtol=1e-5)


def test_mod_two_pi_matches_the_reference_at_the_boundary():
    """``torch.remainder`` and ``jnp.mod`` round a tiny negative angle to
    exactly 2 pi alike (and every other value of the grid equal)."""
    x = np.array([-1e-30, -1e-12, -1e-8, -3e-7, 0.0, 1e-8, 6.2831850,
                  6.2831855, 6.2831860, 2 * np.pi, 12.566371, -6.2831855,
                  -6.3], np.float32)
    want = np.asarray(jnp.mod(jnp.asarray(x), ref_xy.TWO_PI))
    got = torch.remainder(torch.as_tensor(x), xy.TWO_PI).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == np.float32(2 * np.pi)


# -- value for value, the reference's draws fed in ------------------------------

def _sweep_draws(keys, size):
    draws = []
    for half in vsplit(keys, 2):
        k_ang, k_acc = vsplit(half, 2)
        draws += [vuniform(k_ang, (size, size)), vuniform(k_acc, (size, size))]
    return draws


def test_checkerboard_sweep_value_for_value():
    m, size = 16, 6
    ref = ref_xy.init_chains(m, size, beta=0.9, seed=5)
    keys = ref_keys(1, m)
    want, acc = jax.vmap(ref_xy.checkerboard_sweep, (0, None, 0))(
        ref, jnp.float32(1.0), keys)
    got, a = xy.checkerboard_sweep(_carry(ref), 1.0,
                                   *_sweep_draws(keys, size))
    np.testing.assert_array_equal(a.numpy(), np.asarray(acc))
    np.testing.assert_array_equal(got.theta.numpy(), np.asarray(want.theta))
    np.testing.assert_allclose(got.energy.numpy(), np.asarray(want.energy),
                               rtol=1e-5)


def _field_norm(theta):
    th = np.asarray(theta, np.float64)
    hx, hy = (sum(np.roll(f(th), s, a) for s in (1, -1) for a in (1, 2))
              for f in (np.cos, np.sin))
    return np.hypot(hx, hy)


@pytest.mark.parametrize("parity", [0, 1])
def test_overrelax_half_sweep_value_for_value(parity):
    """Each half-sweep from the reference's own input: the reflected angle
    ``2 atan2(hy, hx) - theta`` within 2e-6 + 2e-6 / |h| on the circle (the
    field's float32 ulps, over |h| through ``atan2``), the energy
    untouched."""
    m, size = 16, 6
    ref = ref_xy.init_chains(m, size, beta=0.9, seed=6)
    if parity:
        ref = jax.vmap(lambda s: ref_xy.overrelax_half_sweep(s, 0))(ref)
    want = jax.vmap(lambda s: ref_xy.overrelax_half_sweep(s, parity))(ref)
    got = xy.overrelax_half_sweep(_carry(ref), parity)
    d = np.asarray(got.theta.numpy(), np.float64) - np.asarray(want.theta)
    err = np.abs(np.angle(np.exp(1j * d)))
    assert (err <= 2e-6 + 2e-6 / _field_norm(ref.theta)).all(), err.max()
    np.testing.assert_array_equal(got.energy.numpy(), np.asarray(want.energy))


def test_overrelax_near_zero_field_value_for_value():
    """Sites whose neighbours are at 0 and pi: a field of float32 round-off
    alone, reflected alike by both packages."""
    size = 4
    ii, kk = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    theta = np.where((ii + kk) % 2 == 0, 0.3, np.where(kk % 2, 0.0, np.pi))
    theta = np.broadcast_to(theta, (2, size, size)).astype(np.float32)
    ref = ref_xy.XYState(theta=jnp.asarray(theta),
                         beta=jnp.ones(2, jnp.float32),
                         j=jnp.ones(2, jnp.float32),
                         energy=jnp.zeros(2, jnp.float32))
    want = jax.vmap(lambda s: ref_xy.overrelax_half_sweep(s, 0))(ref)
    got = xy.overrelax_half_sweep(_carry(ref), 0)
    assert _circle_err(got.theta.numpy(), want.theta) < 2e-6
    assert float(torch.atan2(torch.zeros(()), torch.zeros(()))) == 0.0 \
        == float(jnp.arctan2(0.0, 0.0))


@pytest.mark.parametrize("policy", ["uniform", "gaussian"])
def test_rotation_move_value_for_value(policy):
    m, size = 8, 4
    ref = ref_xy.init_chains(m, size, beta=0.7, seed=3)
    site = np.arange(m) * 5 % (size * size)
    dtheta = np.linspace(-1.4, 1.4, m).astype(np.float32)
    ref_move = ref_xy.rotation_move(0.7, policy=policy)
    move = xy.rotation_move(0.7, policy=policy)
    ref_act = {"site": jnp.asarray(site), "dtheta": jnp.asarray(dtheta)}
    act = {"site": torch.as_tensor(site), "dtheta": torch.as_tensor(dtheta)}
    want, dlogp = jax.vmap(ref_move.move.apply)(ref, ref_act)
    got, d = move.move.apply(_carry(ref), act)
    np.testing.assert_array_equal(got.theta.numpy(), np.asarray(want.theta))
    np.testing.assert_allclose(got.energy.numpy(), np.asarray(want.energy),
                               rtol=1e-5)
    np.testing.assert_allclose(d.numpy(), np.asarray(dlogp), rtol=1e-4,
                               atol=1e-5)
    params = {k: torch.tensor(float(v)) for k, v in ref_move.params.items()}
    logq = move.move.policy.log_density(params, act, _carry(ref))
    ref_logq = jax.vmap(lambda a: ref_move.move.policy.log_density(
        ref_move.params, a, jax.tree_util.tree_map(lambda x: x[0], ref)))(
        ref_act)
    np.testing.assert_allclose(logq.numpy(), np.asarray(ref_logq), rtol=1e-6)


def test_gaussian_score_reaches_autograd():
    """``d log q / d sigma = dtheta^2 / sigma^3 - 1 / sigma``."""
    st = xy.init_chains(5, 4, beta=0.6, seed=1, device="cpu")
    sigma = torch.tensor(0.3, requires_grad=True)
    d = torch.tensor([-0.5, -0.1, 0.0, 0.2, 0.9])
    act = {"site": torch.zeros(5, dtype=torch.int64), "dtheta": d}
    pol = xy.GaussianRotation()
    (g,) = torch.autograd.grad(pol.log_density({"sigma": sigma}, act,
                                               st).sum(), sigma)
    want = float(((d ** 2) / 0.3 ** 3 - 1 / 0.3).sum())
    assert abs(float(g) - want) < 1e-4 * abs(want)
    with pytest.raises(ValueError, match="unknown rotation policy"):
        xy.rotation_move(0.5, policy="cauchy")


# -- mirrored gates: tests/test_xy.py -----------------------------------------

@pytest.fixture(scope="module")
def exact():
    return xy.exact_moments(BETA)


def _run_and_read(tmp_path, algo_spec, size, n_chains, steps, burn, seed,
                  beta=BETA):
    chains = xy.init_chains(n_chains, size, beta=beta, seed=seed,
                            device="cpu")
    sim = tmc.Simulation(
        xy.make_system(), chains,
        [algo_spec,
         dict(algorithm=tmc.StoreCallbacks,
              callbacks=[xy.callback_energy_per_spin,
                         xy.callback_magnetisation],
              scheduler=tmc.build_schedule(steps, burn, 1))],
        steps, path=str(tmp_path))
    sim.run()
    e = np.loadtxt(tmp_path / "energy_per_spin.dat")[:, 1]
    m = np.loadtxt(tmp_path / "magnetisation.dat")[:, 1]
    return e.mean(), m.mean(), sim


def test_quadrature_converged(exact):
    e48, m48 = exact
    e32, m32 = xy.exact_moments(BETA, n_quad=32)
    assert abs(e48 - e32) < 1e-10 and abs(m48 - m32) < 1e-5
    assert xy.exact_moments(BETA, n_quad=16) == ref_xy.exact_moments(
        BETA, n_quad=16)


def test_checkerboard_matches_quadrature(tmp_path, exact):
    e_exact, m_exact = exact
    e, m, sim = _run_and_read(
        tmp_path,
        dict(algorithm=xy.CheckerboardXY, seed=3, delta=1.5, overrelax=1),
        size=2, n_chains=256, steps=1200, burn=200, seed=7)
    assert abs(e - e_exact) < 0.03
    assert abs(m - m_exact) < 0.03
    cnt = sim.device_state["checkerboard_xy"]["counters"].numpy()
    assert cnt[..., 1].min() == 1200 * 4          # Metropolis attempts only
    assert "CheckerboardXY" in (tmp_path / "summary.log").read_text()


def test_single_rotation_matches_quadrature(tmp_path, exact):
    e_exact, m_exact = exact
    e, m, _ = _run_and_read(
        tmp_path,
        dict(algorithm=tmc.Metropolis, pool=(xy.rotation_move(1.5),),
             sweepstep=4, seed=3),
        size=2, n_chains=256, steps=2000, burn=400, seed=11)
    assert abs(e - e_exact) < 0.04
    assert abs(m - m_exact) < 0.04


def test_overrelaxation_preserves_energy_exactly():
    chains = xy.init_chains(16, 8, beta=1.1, seed=5, device="cpu")
    out = chains
    for _ in range(10):
        out = xy.overrelax_sweep(out)
    np.testing.assert_allclose(out.energy.numpy(), chains.energy.numpy(),
                               rtol=0, atol=1e-3)
    th = out.theta.numpy().astype(np.float64)
    fresh = -(np.cos(th - np.roll(th, 1, 1))
              + np.cos(th - np.roll(th, 1, 2))).sum((1, 2))
    np.testing.assert_allclose(out.energy.numpy(), fresh, atol=1e-2)
    assert np.abs(out.theta.numpy() - chains.theta.numpy()).max() > 0.1


def test_energy_cache_consistent_checkerboard():
    st = xy.init_chains(8, 6, beta=0.9, seed=3, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for _ in range(40):
        st, _ = xy.checkerboard_sweep(
            st, 1.0, *(torch.rand((8, 6, 6), generator=gen)
                       for _ in range(4)))
    th = st.theta.numpy().astype(np.float64)
    fresh = -(np.cos(th - np.roll(th, 1, 1))
              + np.cos(th - np.roll(th, 1, 2))).sum((1, 2))
    np.testing.assert_allclose(st.energy.numpy(), fresh, atol=1e-2)


def test_checkerboard_rejects_odd_lattice(tmp_path):
    chains = xy.init_chains(4, 3, beta=0.5, seed=1, device="cpu")
    with pytest.raises(ValueError, match="even lattice"):
        tmc.Simulation(xy.make_system(), chains,
                       [dict(algorithm=xy.CheckerboardXY, seed=2)], 10,
                       path=str(tmp_path))
    with pytest.raises(ValueError, match="even lattice"):
        xy.checkerboard_half_sweep(chains, 0, 1.0, chains.theta, chains.theta)


def test_low_temperature_orders(tmp_path):
    e, m, _ = _run_and_read(
        tmp_path,
        dict(algorithm=xy.CheckerboardXY, seed=2, delta=0.6, overrelax=2),
        size=8, n_chains=8, steps=600, burn=300, seed=5, beta=5.0)
    assert m > 0.9
    assert e < -1.8


def test_rotation_sigma_learnable_by_pgmc(tmp_path):
    """PGMC drives the Gaussian rotation width up from 0.05 past 0.12, the
    reference test's run through the port's estimator (autograd score)."""
    from montecarlo_tpu_torch import policy_guided as pg
    chains = xy.init_chains(64, 4, beta=0.6, seed=3, device="cpu")
    steps = 1500
    sim = tmc.Simulation(
        xy.make_system(), chains,
        [dict(algorithm=tmc.Metropolis,
              pool=(xy.rotation_move(0.05, policy="gaussian"),),
              sweepstep=4, seed=4),
         dict(algorithm=pg.PolicyGradientEstimator,
              dependencies=(tmc.Metropolis,),
              optimisers=(pg.VPG(5e-4),), q_batch_size=8),
         dict(algorithm=pg.PolicyGradientUpdate,
              dependencies=(pg.PolicyGradientEstimator,)),
         dict(algorithm=tmc.StoreParameters, dependencies=(tmc.Metropolis,),
              scheduler=tmc.build_schedule(steps, 0, 100))],
        steps, path=str(tmp_path))
    sim.run()
    lines = (tmp_path / "parameters" / "1" /
             "parameters.dat").read_text().strip().splitlines()
    final_delta = float(lines[-1].split()[1].strip("[],"))
    assert final_delta > 0.12


def test_frame_and_callbacks():
    st = xy.init_chains(3, 4, beta=0.5, seed=4, device="cpu")
    fr = xy.make_system().frame(st)
    ref = ref_xy.XYState(**{k: jnp.asarray(v) for k, v in
                            interop.chains_to_reference(st).items()})
    np.testing.assert_allclose(fr["m"].numpy(), np.asarray(
        jax.vmap(lambda s: ref_xy._magnetisation(s.theta))(ref)), rtol=1e-5)
    view = dataclasses.make_dataclass("V", ["sys"])(st)
    assert abs(float(xy.callback_energy_per_spin(view))
               - float(ref_xy.callback_energy_per_spin(
                   dataclasses.make_dataclass("V", ["sys"])(ref)))) < 1e-5
