"""The Heisenberg model in the port (``models/heisenberg.py``) against the
JAX package's.

Value for value, the reference's draws fed in (derived from each chain's
key as the reference's sweep derives them: the axes' normals, the angles'
and the acceptances' uniforms): one checkerboard sweep (components within
2e-6, energies within rtol 1e-5: ``cos``, ``sin``, ``cross`` and ``norm``
differ by ulps), each over-relaxation half-sweep (components within
2e-6 + 2e-6 / |h|), a zero-field site left as it is, and one generic
rotation on the same action.

Mirrored gates of ``tests/test_heisenberg.py`` run the port alone, each at
its reference test's size and in its band.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlo_tpu_torch as tmc
from montecarlo_tpu.models import heisenberg as ref_hb
from montecarlo_tpu_torch import interop
from montecarlo_tpu_torch.models import heisenberg as hb
from torch_lattice_helpers import (_one_torch_thread, carry,  # noqa: F401
                                   ref_keys, vnormal, vsplit, vuniform,
                                   warm_up_transcendentals)

warm_up_transcendentals()
BETA = 0.7
COMPONENT_ATOL = 2e-6


def _carry(ref):
    return carry(ref, hb.HeisenbergState)


def _sweep_draws(keys, size):
    draws = []
    for half in vsplit(keys, 2):
        k_axis, k_ang, k_acc = vsplit(half, 3)
        draws += [vnormal(k_axis, (size, size, 3)),
                  vuniform(k_ang, (size, size)), vuniform(k_acc, (size, size))]
    return draws


def _fresh(sp):
    sp = np.asarray(sp, np.float64)
    return -(sp * (np.roll(sp, 1, 1) + np.roll(sp, 1, 2))).sum((1, 2, 3))


# -- interop and init -----------------------------------------------------------

def test_state_roundtrip_with_the_class_named():
    ref = ref_hb.init_chains(3, 4, beta=0.5, seed=1)
    st = _carry(ref)
    assert type(st) is hb.HeisenbergState and st.spins.dtype == torch.float32
    back = ref_hb.HeisenbergState(**interop.chains_to_reference(st))
    for k in ("spins", "beta", "j", "energy"):
        np.testing.assert_array_equal(np.asarray(getattr(back, k)),
                                      np.asarray(getattr(ref, k)))
    with pytest.raises(ValueError, match="name the class"):
        interop.chains_from_reference(interop.chains_to_reference(st),
                                      device="cpu")
    mine = hb.init_chains(4, 6, beta=0.5, seed=2, device="cpu")
    np.testing.assert_allclose(np.linalg.norm(mine.spins.numpy(), axis=-1),
                               1.0, atol=1e-6)
    np.testing.assert_allclose(mine.energy.numpy(), _fresh(mine.spins),
                               rtol=1e-5, atol=1e-4)


# -- value for value, the reference's draws fed in ------------------------------

def test_checkerboard_sweep_value_for_value():
    m, size = 16, 6
    ref = ref_hb.init_chains(m, size, beta=0.9, seed=5)
    keys = ref_keys(1, m)
    want, acc = jax.vmap(ref_hb.checkerboard_sweep, (0, None, 0))(
        ref, jnp.float32(1.0), keys)
    got, a = hb.checkerboard_sweep(_carry(ref), 1.0,
                                   *_sweep_draws(keys, size))
    np.testing.assert_array_equal(a.numpy(), np.asarray(acc))
    np.testing.assert_allclose(got.spins.numpy(), np.asarray(want.spins),
                               rtol=0, atol=COMPONENT_ATOL)
    np.testing.assert_allclose(got.energy.numpy(), np.asarray(want.energy),
                               rtol=1e-5)


@pytest.mark.parametrize("parity", [0, 1])
def test_overrelax_half_sweep_value_for_value(parity):
    m, size = 16, 6
    ref = ref_hb.init_chains(m, size, beta=0.9, seed=6)
    if parity:
        ref = jax.vmap(lambda s: ref_hb.overrelax_half_sweep(s, 0))(ref)
    want = jax.vmap(lambda s: ref_hb.overrelax_half_sweep(s, parity))(ref)
    got = hb.overrelax_half_sweep(_carry(ref), parity)
    sp = np.asarray(ref.spins, np.float64)
    h = sum(np.roll(sp, s, a) for s in (1, -1) for a in (1, 2))
    bound = COMPONENT_ATOL + COMPONENT_ATOL / np.linalg.norm(h, axis=-1)
    err = np.abs(got.spins.numpy() - np.asarray(want.spins)).max(-1)
    assert (err <= bound).all(), err.max()
    np.testing.assert_array_equal(got.energy.numpy(), np.asarray(want.energy))


def test_overrelax_skips_a_zero_field_site():
    """A site whose neighbours cancel exactly (|h|^2 = 0 <= 1e-12) keeps its
    spin in both packages; its neighbours still reflect."""
    size = 4
    sp = np.zeros((1, size, size, 3), np.float32)
    sp[..., 2] = 1.0
    # the four neighbours of (1, 1): two +x, two -x
    sp[0, 0, 1] = sp[0, 1, 0] = (1.0, 0.0, 0.0)
    sp[0, 2, 1] = sp[0, 1, 2] = (-1.0, 0.0, 0.0)
    sp[0, 1, 1] = (0.6, 0.0, 0.8)
    ref = ref_hb.HeisenbergState(spins=jnp.asarray(sp),
                                 beta=jnp.ones(1, jnp.float32),
                                 j=jnp.ones(1, jnp.float32),
                                 energy=jnp.zeros(1, jnp.float32))
    want = jax.vmap(lambda s: ref_hb.overrelax_half_sweep(s, 0))(ref)
    got = hb.overrelax_half_sweep(_carry(ref), 0)
    np.testing.assert_array_equal(got.spins[0, 1, 1].numpy(), sp[0, 1, 1])
    np.testing.assert_allclose(got.spins.numpy(), np.asarray(want.spins),
                               rtol=0, atol=COMPONENT_ATOL)
    assert not np.array_equal(got.spins.numpy(), sp)


def test_rotation_move_value_for_value():
    m, size = 8, 4
    ref = ref_hb.init_chains(m, size, beta=0.7, seed=3)
    rng = np.random.default_rng(0)
    axis = rng.normal(size=(m, 3)).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    act = {"site": np.arange(m) * 5 % (size * size),
           "axis": axis,
           "alpha": np.linspace(-1.4, 1.4, m).astype(np.float32)}
    ref_move, move = ref_hb.rotation_move(0.7), hb.rotation_move(0.7)
    want, dlogp = jax.vmap(ref_move.move.apply)(
        ref, {k: jnp.asarray(v) for k, v in act.items()})
    t_act = {k: torch.as_tensor(v) for k, v in act.items()}
    got, d = move.move.apply(_carry(ref), t_act)
    np.testing.assert_allclose(got.spins.numpy(), np.asarray(want.spins),
                               rtol=0, atol=COMPONENT_ATOL)
    np.testing.assert_allclose(got.energy.numpy(), np.asarray(want.energy),
                               rtol=1e-5)
    np.testing.assert_allclose(d.numpy(), np.asarray(dlogp), rtol=1e-4,
                               atol=1e-5)
    inv = move.move.invert(t_act, got)
    assert torch.equal(inv["alpha"], -t_act["alpha"])
    logq = move.move.policy.log_density({"delta": torch.tensor(0.7)}, t_act,
                                        got)
    want_logq = -np.log(np.float32(16)) - np.log(np.float32(1.4))
    np.testing.assert_allclose(logq.numpy(), want_logq, rtol=1e-6)


# -- mirrored gates: tests/test_heisenberg.py ---------------------------------

def _run_and_read(tmp_path, algo_spec, size, n_chains, steps, burn, seed,
                  beta=BETA):
    chains = hb.init_chains(n_chains, size, beta=beta, seed=seed,
                            device="cpu")
    sim = tmc.Simulation(
        hb.make_system(), chains,
        [algo_spec,
         dict(algorithm=tmc.StoreCallbacks,
              callbacks=[hb.callback_energy_per_spin,
                         hb.callback_magnetisation],
              scheduler=tmc.build_schedule(steps, burn, 1))],
        steps, path=str(tmp_path))
    sim.run()
    e = np.loadtxt(tmp_path / "energy_per_spin.dat")[:, 1]
    m = np.loadtxt(tmp_path / "magnetisation.dat")[:, 1]
    return e.mean(), m.mean(), sim


def test_exact_solution_truncation_converged():
    e60 = hb.exact_energy_2x2(BETA, l_max=60)
    e30 = hb.exact_energy_2x2(BETA, l_max=30)
    assert abs(e60 - e30) < 1e-12
    assert abs(hb.exact_energy_2x2(1e-6)) < 1e-4
    assert e60 == ref_hb.exact_energy_2x2(BETA, l_max=60)


def test_checkerboard_matches_exact_ring(tmp_path):
    e, _, sim = _run_and_read(
        tmp_path,
        dict(algorithm=hb.CheckerboardHeisenberg, seed=3, delta=1.5,
             overrelax=1),
        size=2, n_chains=256, steps=1200, burn=200, seed=7)
    assert abs(e - hb.exact_energy_2x2(BETA)) < 0.03
    cnt = sim.device_state["checkerboard_heisenberg"]["counters"].numpy()
    assert cnt[..., 1].min() == 1200 * 4
    assert "CheckerboardHeisenberg" in (tmp_path / "summary.log").read_text()


def test_single_rotation_matches_exact_ring(tmp_path):
    e, _, _ = _run_and_read(
        tmp_path,
        dict(algorithm=tmc.Metropolis, pool=(hb.rotation_move(1.5),),
             sweepstep=4, seed=3),
        size=2, n_chains=256, steps=2000, burn=400, seed=11)
    assert abs(e - hb.exact_energy_2x2(BETA)) < 0.04


def test_overrelaxation_preserves_energy_exactly():
    chains = hb.init_chains(16, 8, beta=1.1, seed=5, device="cpu")
    out = chains
    for _ in range(10):
        out = hb.overrelax_sweep(out)
    np.testing.assert_allclose(out.energy.numpy(), chains.energy.numpy(),
                               rtol=0, atol=1e-3)
    sp = out.spins.numpy()
    np.testing.assert_allclose(out.energy.numpy(), _fresh(sp), atol=1e-2)
    assert np.abs(sp - chains.spins.numpy()).max() > 0.1
    np.testing.assert_allclose(np.linalg.norm(sp, axis=-1), 1.0, atol=1e-4)


def test_energy_cache_consistent_checkerboard():
    st = hb.init_chains(8, 6, beta=0.9, seed=3, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for _ in range(40):
        draws = []
        for _ in range(2):
            draws += [torch.randn((8, 6, 6, 3), generator=gen),
                      torch.rand((8, 6, 6), generator=gen),
                      torch.rand((8, 6, 6), generator=gen)]
        st, _ = hb.checkerboard_sweep(st, 1.0, *draws)
    sp = st.spins.numpy()
    np.testing.assert_allclose(st.energy.numpy(), _fresh(sp), atol=1e-2)
    np.testing.assert_allclose(np.linalg.norm(sp, axis=-1), 1.0, atol=1e-4)


def test_checkerboard_rejects_odd_lattice(tmp_path):
    chains = hb.init_chains(4, 3, beta=0.5, seed=1, device="cpu")
    with pytest.raises(ValueError, match="even lattice"):
        tmc.Simulation(hb.make_system(), chains,
                       [dict(algorithm=hb.CheckerboardHeisenberg, seed=2)],
                       10, path=str(tmp_path))


def test_low_temperature_orders(tmp_path):
    e, m, _ = _run_and_read(
        tmp_path,
        dict(algorithm=hb.CheckerboardHeisenberg, seed=2, delta=0.5,
             overrelax=2),
        size=8, n_chains=8, steps=600, burn=300, seed=5, beta=8.0)
    assert m > 0.85
    assert e < -1.75
