"""The discrete lattice models in the port (``models/ising.py``,
``ising2d.py``, ``potts.py``) against the JAX package's.

Value for value: one checkerboard sweep, one Wolff step and one
Swendsen-Wang step of ``ising2d`` and of ``potts``, and one generic spin
flip, on the same chains with the reference's own draws fed in (each
derived from a chain's key as the reference's step derives them): spins
and energies equal.  The state carried both ways by ``interop``, with the
class named.

Mirrored gates of ``tests/test_ising.py``, ``test_ising2d.py``,
``test_wolff.py`` and ``test_potts.py`` run the port alone, each in its
reference test's band.  Cut from the reference's sizes (the generic path's
Python loop runs every single-site attempt as a few tensor operations):
the 1-D ring's transfer-matrix gate runs 200 steps, not 3000 (the ring
equilibrates within a few sweeps at beta 0.6), the 2-D single-flip gate
800 steps with a burn of 300, not 2000 and 500, and the Potts single
recolour gate 800 and 300 for 2000 and 500.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlo_tpu_torch as tmc
from montecarlo_tpu.models import ising as ref_ising
from montecarlo_tpu.models import ising2d as ref_i2
from montecarlo_tpu.models import potts as ref_potts
from montecarlo_tpu_torch import interop
from montecarlo_tpu_torch.models import ising, ising2d, potts
from torch_lattice_helpers import (_one_torch_thread, carry,  # noqa: F401
                                   ref_keys, vrandint, vsplit, vuniform)
from torch_ecmc_helpers import T


def _same(port_state, ref_state):
    np.testing.assert_array_equal(port_state.spins.numpy(),
                                  np.asarray(ref_state.spins))
    np.testing.assert_array_equal(port_state.energy.numpy(),
                                  np.asarray(ref_state.energy))


# -- interop -----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["ising", "ising2d", "potts"])
def test_lattice_states_roundtrip_with_the_class_named(name):
    ref, cls = {"ising": (ref_ising.init_chains(3, 10, beta=0.5, seed=1),
                          ising.IsingState),
                "ising2d": (ref_i2.init_chains(3, 4, beta=0.5, seed=1),
                            ising2d.Ising2DState),
                "potts": (ref_potts.init_chains(3, 4, q=3, beta=0.5, seed=1),
                          potts.PottsState)}[name]
    st = carry(ref, cls)
    assert type(st) is cls and st.spins.dtype == torch.int8
    assert st.energy.dtype == torch.float32
    _same(st, ref)
    back = interop.chains_to_reference(st)
    ref2 = type(ref)(**back)
    for k in ("spins", "beta", "j", "energy"):
        np.testing.assert_array_equal(np.asarray(getattr(ref2, k)),
                                      np.asarray(getattr(ref, k)))
    with pytest.raises(ValueError, match="name the class"):
        interop.chains_from_reference(back, device="cpu")


def test_init_chains_energy_and_device():
    for st in (ising.init_chains(4, 16, beta=0.5, device="cpu"),
               ising2d.init_chains(4, 6, beta=0.5, device="cpu"),
               potts.init_chains(4, 6, q=3, beta=0.5, device="cpu")):
        assert st.spins.dtype == torch.int8 and st.spins.device.type == "cpu"
    s = ising2d.init_chains(4, 6, beta=0.5, seed=2, device="cpu")
    ref = ref_i2.Ising2DState(**{k: jnp.asarray(v) for k, v in
                                 interop.chains_to_reference(s).items()})
    want = jax.vmap(lambda st: ref_i2._total_energy(st.spins, st.j))(ref)
    np.testing.assert_array_equal(s.energy.numpy(), np.asarray(want))
    p = potts.init_chains(4, 6, q=4, beta=0.5, seed=2, device="cpu")
    assert set(np.unique(p.spins.numpy())) <= {0, 1, 2, 3}


# -- value for value, the reference's draws fed in ------------------------------

def test_ising2d_checkerboard_sweep_value_for_value():
    m, size = 8, 6
    ref = ref_i2.init_chains(m, size, beta=0.44, seed=5)
    keys = ref_keys(1, m)
    want, acc = jax.vmap(ref_i2.checkerboard_sweep)(ref, keys)
    k0, k1 = vsplit(keys, 2)
    got, a = ising2d.checkerboard_sweep(
        carry(ref, ising2d.Ising2DState),
        vuniform(k0, (size, size)), vuniform(k1, (size, size)))
    _same(got, want)
    np.testing.assert_array_equal(a.numpy(), np.asarray(acc))


def test_ising2d_wolff_step_value_for_value():
    m, size = 8, 6
    ref = ref_i2.init_chains(m, size, beta=0.44, seed=6)
    keys = ref_keys(2, m)
    want, n = jax.vmap(ref_i2.wolff_step)(ref, keys)
    k_seed, k_right, k_down = vsplit(keys, 3)
    got, size_ = ising2d.wolff_step(
        carry(ref, ising2d.Ising2DState), vuniform(k_right, (size, size)),
        vuniform(k_down, (size, size)),
        vrandint(k_seed, (), 0, size * size).long())
    _same(got, want)
    np.testing.assert_array_equal(size_.numpy(), np.asarray(n))


def test_ising2d_swendsen_wang_step_value_for_value():
    m, size = 8, 5                 # odd: SW needs no 2-colouring
    ref = ref_i2.init_chains(m, size, beta=0.44, seed=7)
    keys = ref_keys(3, m)
    want, n = jax.vmap(ref_i2.swendsen_wang_step)(ref, keys)
    k_right, k_down, k_spin = vsplit(keys, 3)
    fresh = T(jax.vmap(lambda k: 2 * jax.random.bernoulli(
        k, 0.5, (size * size,)).astype(jnp.int8) - 1)(k_spin))
    got, nc = ising2d.swendsen_wang_step(
        carry(ref, ising2d.Ising2DState), vuniform(k_right, (size, size)),
        vuniform(k_down, (size, size)), fresh)
    _same(got, want)
    np.testing.assert_array_equal(nc.numpy(), np.asarray(n))


def test_potts_checkerboard_sweep_value_for_value():
    m, size, q = 8, 6, 3
    ref = ref_potts.init_chains(m, size, q=q, beta=0.8, seed=5)
    keys = ref_keys(4, m)
    want, acc = jax.vmap(lambda s, k: ref_potts.checkerboard_sweep(
        s, q, k))(ref, keys)
    draws = []
    for half in vsplit(keys, 2):
        k_col, k_acc = vsplit(half, 2)
        draws += [vrandint(k_col, (size, size), 0, q - 1),
                  vuniform(k_acc, (size, size))]
    got, a = potts.checkerboard_sweep(carry(ref, potts.PottsState), q,
                                      *draws)
    _same(got, want)
    np.testing.assert_array_equal(a.numpy(), np.asarray(acc))


def test_potts_wolff_step_value_for_value():
    m, size, q = 8, 5, 3
    ref = ref_potts.init_chains(m, size, q=q, beta=0.9, seed=6)
    keys = ref_keys(5, m)
    want, n = jax.vmap(lambda s, k: ref_potts.wolff_step(s, q, k))(ref, keys)
    k_seed, k_right, k_down, k_col = vsplit(keys, 4)
    got, size_ = potts.wolff_step(
        carry(ref, potts.PottsState), q, vuniform(k_right, (size, size)),
        vuniform(k_down, (size, size)),
        vrandint(k_seed, (), 0, size * size).long(),
        vrandint(k_col, (), 0, q - 1))
    _same(got, want)
    np.testing.assert_array_equal(size_.numpy(), np.asarray(n))


def test_potts_swendsen_wang_step_value_for_value():
    m, size, q = 8, 5, 4
    ref = ref_potts.init_chains(m, size, q=q, beta=0.9, seed=7)
    keys = ref_keys(6, m)
    want, n = jax.vmap(lambda s, k: ref_potts.swendsen_wang_step(
        s, q, k))(ref, keys)
    k_right, k_down, k_col = vsplit(keys, 3)
    got, nc = potts.swendsen_wang_step(
        carry(ref, potts.PottsState), q, vuniform(k_right, (size, size)),
        vuniform(k_down, (size, size)),
        vrandint(k_col, (size * size,), 0, q, dtype=jnp.int8))
    _same(got, want)
    np.testing.assert_array_equal(nc.numpy(), np.asarray(n))


@pytest.mark.parametrize("name", ["ising", "ising2d", "potts"])
def test_generic_move_value_for_value(name):
    """One ``apply`` of the generic single-site move on the same action."""
    m = 8
    if name == "ising":
        ref = ref_ising.init_chains(m, 12, beta=0.6, seed=3)
        cls, ref_move, move = (ising.IsingState, ref_ising.spin_flip_move(),
                               ising.spin_flip_move())
        act = np.arange(m) * 5 % 12
        ref_act, act = jnp.asarray(act), torch.as_tensor(act)
    elif name == "ising2d":
        ref = ref_i2.init_chains(m, 4, beta=0.6, seed=3)
        cls, ref_move, move = (ising2d.Ising2DState,
                               ref_i2.spin_flip_move(),
                               ising2d.spin_flip_move())
        act = np.arange(m) * 7 % 16
        ref_act, act = jnp.asarray(act), torch.as_tensor(act)
    else:
        ref = ref_potts.init_chains(m, 3, q=3, beta=0.6, seed=3)
        cls, ref_move, move = (potts.PottsState, ref_potts.color_flip_move(3),
                               potts.color_flip_move(3))
        site = np.arange(m) * 4 % 9
        old = np.asarray(ref.spins).reshape(m, -1)[np.arange(m), site]
        color = ((old + 1 + np.arange(m) % 2) % 3).astype(np.int8)
        ref_act = {"site": jnp.asarray(site), "color": jnp.asarray(color)}
        act = {"site": torch.as_tensor(site), "color": torch.as_tensor(color)}
    want, dlogp = jax.vmap(ref_move.move.apply)(ref, ref_act)
    got, d = move.move.apply(carry(ref, cls), act)
    _same(got, want)
    np.testing.assert_array_equal(d.numpy(), np.asarray(dlogp))


# -- mirrored gates: tests/test_ising.py ----------------------------------------

def _generic_run(system, chains, pool, steps, sweepstep, seed, path,
                 callbacks=(), burn=0):
    algos = [dict(algorithm=tmc.Metropolis, pool=pool, seed=seed,
                  sweepstep=sweepstep)]
    if callbacks:
        algos.append(dict(algorithm=tmc.StoreCallbacks, callbacks=callbacks,
                          scheduler=tmc.build_schedule(steps, burn, 1)))
    sim = tmc.Simulation(system, chains, algos, steps, path=str(path))
    sim.run()
    return sim


def test_ising_energy_cache_consistent(tmp_path):
    chains = ising.init_chains(8, 64, beta=0.5, seed=3, device="cpu")
    sim = _generic_run(ising.make_system(), chains,
                       (ising.spin_flip_move(),), 50, 64, 3, tmp_path)
    sys = sim.device_state["sys"]
    spins = sys.spins.numpy().astype(np.float32)
    full = -np.sum(spins * np.roll(spins, 1, axis=1), axis=1)
    np.testing.assert_allclose(sys.energy.numpy(), full, atol=1e-3)
    assert set(np.unique(sys.spins.numpy())) <= {-1, 1}


def test_ising_matches_exact_transfer_matrix(tmp_path):
    beta, n = 0.6, 64
    chains = ising.init_chains(256, n, beta=beta, seed=11, device="cpu")
    sim = _generic_run(ising.make_system(), chains,
                       (ising.spin_flip_move(),), 200, n, 11, tmp_path)
    e_per_spin = float(sim.device_state["sys"].energy.mean()) / n
    exact = ising.exact_energy_per_spin(beta, n)
    assert exact == ref_ising.exact_energy_per_spin(beta, n)
    assert abs(e_per_spin - exact) < 0.03, (e_per_spin, exact)


# -- mirrored gates: tests/test_ising2d.py ----------------------------------------

L, BETA = 4, 0.3


def _run_and_read(tmp_path, algo_spec, n_chains, steps, burn, seed,
                  module=ising2d, q=None, size=L, beta=BETA):
    if module is potts:
        chains = potts.init_chains(n_chains, size, q=q, beta=beta, seed=seed,
                                   device="cpu")
        system = potts.make_system(q)
        cbs = [potts.callback_energy_per_spin,
               potts.callback_order_parameter(q)]
        second = "order_parameter"
    else:
        chains = ising2d.init_chains(n_chains, size, beta=beta, seed=seed,
                                     device="cpu")
        system = ising2d.make_system()
        cbs = [ising2d.callback_energy_per_spin,
               ising2d.callback_magnetisation]
        second = "magnetisation"
    sim = tmc.Simulation(system, chains, [
        algo_spec,
        dict(algorithm=tmc.StoreCallbacks, callbacks=cbs,
             scheduler=tmc.build_schedule(steps, burn, 1))],
        steps, path=str(tmp_path))
    sim.run()
    e = np.loadtxt(tmp_path / "energy_per_spin.dat")[:, 1]
    m = np.loadtxt(tmp_path / f"{second}.dat")[:, 1]
    return e.mean(), m.mean(), sim


def test_ising2d_checkerboard_matches_exact_enumeration(tmp_path):
    e_exact, m_exact = ising2d.exact_moments(L, BETA)
    e, m, sim = _run_and_read(
        tmp_path, dict(algorithm=ising2d.CheckerboardMetropolis, seed=11),
        n_chains=128, steps=1500, burn=200, seed=7)
    assert abs(e - e_exact) < 0.02
    assert abs(m - m_exact) < 0.02
    counters = sim.device_state["checkerboard"]["counters"].numpy()
    assert counters[..., 1].min() == 1500 * L * L
    rate = counters[..., 0].sum() / counters[..., 1].sum()
    assert 0.05 < rate < 0.95
    summary = (tmp_path / "summary.log").read_text()
    assert "CheckerboardMetropolis" in summary and "Lattice: (4, 4)" in summary


def test_ising2d_single_flip_matches_exact_enumeration(tmp_path):
    e_exact, m_exact = ising2d.exact_moments(L, BETA)
    e, m, _ = _run_and_read(
        tmp_path,
        dict(algorithm=tmc.Metropolis, pool=(ising2d.spin_flip_move(),),
             sweepstep=L * L, seed=11),
        n_chains=128, steps=800, burn=300, seed=9)
    assert abs(e - e_exact) < 0.03
    assert abs(m - m_exact) < 0.03


def test_ising2d_energy_cache_consistent_checkerboard():
    st = ising2d.init_chains(16, 8, beta=0.6, seed=3, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for _ in range(50):
        st, _ = ising2d.checkerboard_sweep(
            st, torch.rand((16, 8, 8), generator=gen),
            torch.rand((16, 8, 8), generator=gen))
    s = st.spins.numpy().astype(np.float32)
    full = -np.sum(s * (np.roll(s, 1, axis=1) + np.roll(s, 1, axis=2)),
                   axis=(1, 2))
    np.testing.assert_allclose(st.energy.numpy(), full, atol=1e-3)


def test_ising2d_low_temperature_orders(tmp_path):
    chains = ising2d.init_chains(8, 8, beta=1.0, seed=5, device="cpu")
    sim = tmc.Simulation(ising2d.make_system(), chains, [
        dict(algorithm=ising2d.CheckerboardMetropolis, seed=2)],
        400, path=str(tmp_path))
    sim.run()
    s = sim.device_state["sys"].spins.numpy().astype(np.float32)
    assert np.abs(s.mean(axis=(1, 2))).mean() > 0.9


def test_ising2d_exact_moments_and_log_g_equal_the_reference():
    for size, beta in ((4, 1e-8), (3, 6.0), (4, 0.3), (3, 0.4)):
        assert ising2d.exact_moments(size, beta) == \
            ref_i2.exact_moments(size, beta)
    e0, m0 = ising2d.exact_moments(4, 1e-8)
    assert abs(e0) < 1e-6 and abs(m0 - np.sqrt(2 / (np.pi * 16))) < 0.02
    e1, m1 = ising2d.exact_moments(3, 6.0)
    assert abs(e1 + 2.0) < 1e-2 and abs(m1 - 1.0) < 1e-2
    np.testing.assert_array_equal(ising2d.exact_log_g(4),
                                  ref_i2.exact_log_g(4))
    np.testing.assert_array_equal(ising2d.wl_bin_energies(5),
                                  ref_i2.wl_bin_energies(5))


def test_checkerboard_rejects_odd_lattice(tmp_path):
    chains = ising2d.init_chains(4, 5, beta=0.5, seed=1, device="cpu")
    with pytest.raises(ValueError, match="even lattice"):
        tmc.Simulation(ising2d.make_system(), chains,
                       [dict(algorithm=ising2d.CheckerboardMetropolis)],
                       10, path=str(tmp_path))
    chains = potts.init_chains(8, 3, q=3, beta=BETA, seed=1, device="cpu")
    with pytest.raises(ValueError, match="even lattice"):
        tmc.Simulation(potts.make_system(3), chains,
                       [dict(algorithm=potts.CheckerboardPotts(3), seed=2)],
                       10, path=str(tmp_path))


# -- mirrored gates: tests/test_wolff.py ------------------------------------------

def _wolff(tmp_path, beta, seed, clusters=1):
    return _run_and_read(
        tmp_path, dict(algorithm=ising2d.WolffCluster, seed=seed + 1,
                       clusters=clusters),
        n_chains=128, steps=1200, burn=200, seed=seed, beta=beta)


def test_wolff_matches_exact_enumeration(tmp_path):
    e_exact, m_exact = ising2d.exact_moments(L, 0.3)
    e, m, sim = _wolff(tmp_path, 0.3, 13)
    assert abs(e - e_exact) < 0.02
    assert abs(m - m_exact) < 0.02
    counters = sim.device_state["wolff"]["counters"].numpy()
    sizes = counters[..., 0] / counters[..., 1]
    assert np.all(sizes >= 1.0) and np.all(sizes <= L * L)


def test_wolff_near_critical(tmp_path):
    e_exact, m_exact = ising2d.exact_moments(L, 0.44)
    e, m, _ = _wolff(tmp_path, 0.44, 29, clusters=2)
    assert abs(e - e_exact) < 0.03
    assert abs(m - m_exact) < 0.03


def test_wolff_energy_cache_consistent():
    st = ising2d.init_chains(8, 8, beta=0.5, seed=3, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for _ in range(30):
        st, _ = ising2d.wolff_step(
            st, torch.rand((8, 8, 8), generator=gen),
            torch.rand((8, 8, 8), generator=gen),
            torch.randint(0, 64, (8,), generator=gen))
    s = st.spins.numpy().astype(np.float32)
    full = -np.sum(s * (np.roll(s, 1, axis=1) + np.roll(s, 1, axis=2)),
                   axis=(1, 2))
    np.testing.assert_allclose(st.energy.numpy(), full, atol=1e-3)


def test_wolff_cluster_spans_at_low_temperature():
    chains = ising2d.init_chains(4, 6, beta=3.0, seed=1, device="cpu")
    chains = dataclasses.replace(
        chains, spins=torch.ones_like(chains.spins),
        energy=torch.full_like(chains.energy, -2.0 * 36))
    gen = torch.Generator().manual_seed(7)
    st, size = ising2d.wolff_step(
        chains, torch.rand((4, 6, 6), generator=gen),
        torch.rand((4, 6, 6), generator=gen),
        torch.randint(0, 36, (4,), generator=gen))
    assert bool((size == 36).all()) and bool((st.spins == -1).all())


def test_cluster_samplers_reject_antiferromagnetic_coupling(tmp_path):
    chains = ising2d.init_chains(4, L, beta=0.5, j=-1.0, seed=1,
                                 device="cpu")
    for algo in (ising2d.WolffCluster, ising2d.SwendsenWang):
        with pytest.raises(ValueError, match="J > 0"):
            tmc.Simulation(ising2d.make_system(), chains,
                           [dict(algorithm=algo, seed=2)], 10,
                           path=str(tmp_path))
    chains = potts.init_chains(4, 3, q=3, beta=0.5, j=-1.0, seed=1,
                               device="cpu")
    for algo in (potts.WolffPotts(3), potts.SwendsenWangPotts(3)):
        with pytest.raises(ValueError, match="J > 0"):
            tmc.Simulation(potts.make_system(3), chains,
                           [dict(algorithm=algo, seed=2)], 10,
                           path=str(tmp_path))


# -- mirrored gates: tests/test_potts.py ------------------------------------------

def test_potts_checkerboard_matches_exact_enumeration(tmp_path):
    q, size = 2, 4
    e_exact, m_exact = potts.exact_moments(size, q, 0.5)
    e, m, _ = _run_and_read(
        tmp_path, dict(algorithm=potts.CheckerboardPotts(q), seed=11),
        n_chains=128, steps=1500, burn=300, seed=7, module=potts, q=q,
        size=size, beta=0.5)
    assert abs(e - e_exact) < 0.03
    assert abs(m - m_exact) < 0.03


def test_potts_single_recolor_matches_exact_enumeration(tmp_path):
    q, size, beta = 3, 3, 0.5
    e_exact, m_exact = potts.exact_moments(size, q, beta)
    e, m, _ = _run_and_read(
        tmp_path,
        dict(algorithm=tmc.Metropolis, pool=(potts.color_flip_move(q),),
             sweepstep=size * size, seed=11),
        n_chains=128, steps=800, burn=300, seed=9, module=potts, q=q,
        size=size, beta=beta)
    assert abs(e - e_exact) < 0.04
    assert abs(m - m_exact) < 0.04


def test_potts_energy_cache_consistent_checkerboard():
    st = potts.init_chains(16, 8, q=4, beta=0.8, seed=3, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for _ in range(50):
        draws = []
        for _ in range(2):
            draws += [torch.randint(0, 3, (16, 8, 8), generator=gen),
                      torch.rand((16, 8, 8), generator=gen)]
        st, _ = potts.checkerboard_sweep(st, 4, *draws)
    s = st.spins.numpy()
    full = -((s == np.roll(s, 1, axis=1)).astype(np.float64)
             + (s == np.roll(s, 1, axis=2)).astype(np.float64)
             ).sum(axis=(1, 2))
    np.testing.assert_allclose(st.energy.numpy(), full, atol=1e-3)


def test_potts_q2_reduces_to_ising():
    beta = 0.4
    e_p, _ = potts.exact_moments(3, 2, beta, j=1.0)
    e_i, _ = ising2d.exact_moments(3, beta / 2, j=1.0)
    np.testing.assert_allclose(e_p, -1.0 + e_i / 2.0, atol=1e-6)
    assert potts.exact_moments(3, 3, 0.6) == ref_potts.exact_moments(3, 3,
                                                                     0.6)


def test_potts_low_temperature_orders(tmp_path):
    chains = potts.init_chains(8, 6, q=3, beta=3.0, seed=5, device="cpu")
    sim = tmc.Simulation(potts.make_system(3), chains, [
        dict(algorithm=potts.CheckerboardPotts(3), seed=2)],
        500, path=str(tmp_path))
    sim.run()
    s = sim.device_state["sys"].spins.numpy()
    n = s.shape[-1] * s.shape[-2]
    counts = np.stack([(s == c).sum(axis=(1, 2)) for c in range(3)], axis=-1)
    m = (3 * counts.max(axis=-1) / n - 1.0) / 2.0
    assert m.mean() > 0.9
