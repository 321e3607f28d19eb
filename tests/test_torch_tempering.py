"""Replica exchange in the port (``core/tempering.py``) against the JAX
package's.

Value for value: one ``ReplicaExchange`` call on the same ladder-major
chains with the reference's uniforms fed in swaps the same configurations
and adds the same counters.  Mirrored gates of ``tests/test_tempering.py``
in its bands: each temperature's variance at 1/(2 beta) while swaps are
accepted, configurations moving without their ensembles, the misuse
errors, and the composition with the fused path (its plain version here)
through the hybrid stepper.  On a chain mesh emulated by threads
(``parallel.run_emulated``, S = 8, M 24, T 4: every ladder straddles a
rank boundary) the swaps equal the one-process run's bit for bit.  A
cut-and-resumed run equals the uncut one, and the ``replica_exchange``
slice is carried both ways by ``interop``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlo_tpu as mc
import montecarlo_tpu_torch as tmc
from montecarlo_tpu.models import particle1d as ref_p1d
from montecarlo_tpu_torch import checkpoint, interop
from montecarlo_tpu_torch.core.simulation import _select_advance
from montecarlo_tpu_torch.core.tempering import swap
from montecarlo_tpu_torch.models import particle1d as p1d
from montecarlo_tpu_torch.parallel import fetch, run_emulated
from torch_cell_helpers import assert_same_state

BETAS = [0.5, 1.0, 2.0, 4.0]
N_LADDERS = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test runner runs several files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _var_callback(k, n_temps):
    def cb(view):
        return torch.mean(view.sys.x[k::n_temps] ** 2)
    cb.__name__ = f"callback_var{k}"
    return cb


def test_tile_ladder_follows_the_reference():
    got = tmc.tile_ladder(BETAS, 3, device="cpu")
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(mc.tile_ladder(BETAS, 3)))
    assert got.dtype == torch.float32
    chains = p1d.init_chains(12, beta=got, seed=1, device="cpu")
    np.testing.assert_array_equal(chains.beta.numpy(), got.numpy())


@pytest.mark.parametrize("calls", [0, 1])
def test_swap_value_for_value(calls, tmp_path):
    """One call, the even (calls 0) or the odd pairing (calls 1)."""
    t, n_temps = 9, 4
    ref_chains = ref_p1d.init_chains(24, beta=mc.tile_ladder(BETAS, 6),
                                     seed=3)
    ref_sim = mc.Simulation(ref_p1d.make_system(), ref_chains, [
        dict(algorithm=mc.ReplicaExchange, n_temps=n_temps, seed=5)],
        10, path=str(tmp_path / "ref"))
    ds = ref_sim.init_device_state()
    ds = {**ds, "replica_exchange": {**ds["replica_exchange"],
                                     "calls": jnp.asarray(calls, jnp.int32)}}
    out = ref_sim.device_algos[0].step(ds, jnp.asarray(t, jnp.int32))
    u = jax.random.uniform(jax.random.fold_in(jax.random.key(5), t), (24,),
                           jnp.float32)

    chains = interop.chains_from_reference(
        {k: np.asarray(getattr(ref_chains, k)) for k in ("x", "beta", "e")},
        device="cpu")
    sim = tmc.Simulation(p1d.make_system(), chains, [
        dict(algorithm=tmc.ReplicaExchange, n_temps=n_temps, seed=5)],
        10, path=str(tmp_path / "port"))
    re = sim.device_algos[0]
    new, inc = swap(chains, re._perms[calls], torch.as_tensor(np.array(u)),
                    re.log_target, re.ensemble_fields, n_temps)
    for k in ("x", "beta", "e"):
        np.testing.assert_array_equal(getattr(new, k).numpy(),
                                      np.asarray(getattr(out["sys"], k)))
    np.testing.assert_array_equal(
        inc.numpy(), np.asarray(out["replica_exchange"]["counters"]))
    assert int(inc[:, 1].sum()) > 0


def test_replica_exchange_preserves_marginals(tmp_path):
    T = len(BETAS)
    chains = p1d.init_chains(T * N_LADDERS, beta=tmc.tile_ladder(
        BETAS, N_LADDERS, device="cpu"), seed=42, device="cpu")
    steps, burn = 4000, 1000
    sim = tmc.Simulation(p1d.make_system(), chains, [
        dict(algorithm=tmc.Metropolis,
             pool=(p1d.displacement_move(sigma=1.0),), seed=42),
        dict(algorithm=tmc.ReplicaExchange, n_temps=T, seed=5,
             scheduler=tmc.build_schedule(steps, 0, 2)),
        dict(algorithm=tmc.StoreCallbacks,
             callbacks=[_var_callback(k, T) for k in range(T)]
             + [tmc.callback_swap_rate],
             scheduler=tmc.build_schedule(steps, burn, 1))],
        steps, path=str(tmp_path))
    sim.run()
    for k, beta in enumerate(BETAS):
        var = np.loadtxt(tmp_path / f"var{k}.dat")[:, 1].mean()
        assert abs(var - 1 / (2 * beta)) < 0.08 / (2 * beta), (k, beta, var)
    counters = sim.device_state["replica_exchange"]["counters"].numpy()
    assert counters.shape == (T - 1, 2)
    # 2000 calls alternate parity: each link attempted on 1000, per ladder
    np.testing.assert_array_equal(counters[:, 1], 1000 * N_LADDERS)
    rate = counters[:, 0] / counters[:, 1]
    assert np.all(rate > 0.05) and np.all(rate < 0.999), rate
    sw = np.loadtxt(tmp_path / "swap_rate.dat")[:, 1]
    assert 0.05 < sw[-1] < 0.999
    summary = (tmp_path / "summary.log").read_text()
    assert "ReplicaExchange" in summary and "Ladders: 64" in summary


def test_swap_moves_configurations_not_ensembles(tmp_path):
    betas = tmc.tile_ladder([1.0, 3.0], 8, device="cpu")
    chains = p1d.init_chains(16, beta=betas, seed=1, device="cpu")
    sim = tmc.Simulation(p1d.make_system(), chains, [
        dict(algorithm=tmc.Metropolis,
             pool=(p1d.displacement_move(sigma=0.8),), seed=1),
        dict(algorithm=tmc.ReplicaExchange, n_temps=2, seed=2)],
        50, path=str(tmp_path))
    sim.run()
    out = sim.device_state["sys"]
    np.testing.assert_array_equal(out.beta.numpy(), betas.numpy())
    np.testing.assert_allclose(out.e.numpy(), (out.x ** 2).numpy(),
                               rtol=1e-5)
    counters = sim.device_state["replica_exchange"]["counters"]
    assert int(counters[:, 1].sum()) > 0 and int(counters[:, 0].sum()) > 0


def test_validation(tmp_path):
    chains = p1d.init_chains(10, beta=2.0, seed=1, device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        tmc.Simulation(p1d.make_system(), chains,
                       [dict(algorithm=tmc.ReplicaExchange, n_temps=4)],
                       10, path=str(tmp_path))
    with pytest.raises(ValueError, match="log_target"):
        sysdef = dataclasses.replace(p1d.make_system(), log_target=None)
        tmc.Simulation(sysdef, p1d.init_chains(8, beta=2.0, device="cpu"),
                       [dict(algorithm=tmc.ReplicaExchange, n_temps=4)],
                       10, path=str(tmp_path))
    with pytest.raises(ValueError, match="n_temps"):
        tmc.Simulation(p1d.make_system(), chains,
                       [dict(algorithm=tmc.ReplicaExchange, n_temps=1)],
                       10, path=str(tmp_path))


def _swap_only_sim(path, mesh, backups=()):
    """Replica exchange alone on 24 chains, T 4: its swaps are the only
    randomness, so every rank count gives the same chains."""
    chains = p1d.init_chains(24, beta=tmc.tile_ladder(BETAS, 6, device="cpu"),
                             seed=3, device="cpu")
    algos = [dict(algorithm=tmc.ReplicaExchange, n_temps=4, seed=4)]
    if backups:
        algos.append(dict(algorithm=tmc.StoreBackups,
                          scheduler=np.asarray(backups)))
    return tmc.Simulation(p1d.make_system(), chains, algos, 40,
                          path=str(path), mesh=mesh)


def test_swaps_across_rank_boundaries_equal_one_process(tmp_path):
    """S = 8 ranks of 3 chains, ladders of 4: a swap's partner often lives
    on another rank."""
    one = _swap_only_sim(tmp_path / "one", None)
    one.run()

    def rank(mesh):
        sim = _swap_only_sim(tmp_path / "mesh", mesh)
        sim.run()
        return fetch(sim.device_state, mesh)

    outs = run_emulated(rank, 8, "cpu")
    want = one.device_state
    assert int(want["replica_exchange"]["counters"][:, 0].sum()) > 0
    for got in outs:
        for k in ("x", "beta", "e"):
            assert torch.equal(getattr(got["sys"], k),
                               getattr(want["sys"], k)), k
        assert torch.equal(got["replica_exchange"]["counters"],
                           want["replica_exchange"]["counters"])


def test_composes_with_the_fused_path(tmp_path):
    """Replica exchange rides the hybrid stepper between fused segments of
    the Gaussian sweep's plain version; the marginals stay right."""
    T = len(BETAS)
    chains = p1d.init_chains(T * N_LADDERS, beta=tmc.tile_ladder(
        BETAS, N_LADDERS, device="cpu"), seed=42, device="cpu")
    steps, burn = 3000, 1000
    sim = tmc.Simulation(p1d.make_system(), chains, [
        dict(algorithm=tmc.Metropolis,
             pool=(p1d.displacement_move(sigma=1.0),), seed=42,
             fused="interpret"),
        dict(algorithm=tmc.ReplicaExchange, n_temps=T, seed=5,
             scheduler=tmc.build_schedule(steps, 0, 4)),
        dict(algorithm=tmc.StoreCallbacks,
             callbacks=[_var_callback(k, T) for k in range(T)],
             scheduler=tmc.build_schedule(steps, burn, 10))],
        steps, path=str(tmp_path))
    assert "hybrid" in _select_advance(sim).__qualname__
    sim.run()
    for k, beta in enumerate(BETAS):
        var = np.loadtxt(tmp_path / f"var{k}.dat")[:, 1].mean()
        assert abs(var - 1 / (2 * beta)) < 0.12 / (2 * beta), (k, beta, var)
    counters = sim.device_state["replica_exchange"]["counters"].numpy()
    assert np.all(counters[:, 0] / counters[:, 1] > 0.05), counters


def test_cut_and_resumed_run_equals_the_uncut_run(tmp_path):
    def build(path, backups=()):
        chains = p1d.init_chains(
            16, beta=tmc.tile_ladder(BETAS, 4, device="cpu"), seed=2,
            device="cpu")
        algos = [dict(algorithm=tmc.Metropolis,
                      pool=(p1d.displacement_move(sigma=1.0),), seed=6),
                 dict(algorithm=tmc.ReplicaExchange, n_temps=4, seed=8,
                      scheduler=np.arange(3, 31, 3))]
        if backups:
            algos.append(dict(algorithm=tmc.StoreBackups,
                              scheduler=np.asarray(backups)))
        return tmc.Simulation(p1d.make_system(), chains, algos, 30,
                              path=str(path))

    whole = build(tmp_path / "whole", backups=[14])
    whole.run()
    resumed = build(tmp_path / "resumed")
    checkpoint.resume_state(
        resumed, str(tmp_path / "whole" / "checkpoints" / "ckpt_t14.npz"))
    resumed.run()
    assert_same_state(whole.device_state, resumed.device_state)
    assert int(whole.device_state["replica_exchange"]["calls"]) == 10


def test_replica_exchange_slice_carried_both_ways(tmp_path):
    ref_chains = ref_p1d.init_chains(8, beta=mc.tile_ladder([1.0, 2.0], 4),
                                     seed=1)
    ref_sim = mc.Simulation(ref_p1d.make_system(), ref_chains, [
        dict(algorithm=mc.ReplicaExchange, n_temps=2, seed=5)], 10,
        path=str(tmp_path / "ref"))
    ref_slc = ref_sim.init_device_state()["replica_exchange"]
    ref_np = {"calls": np.asarray(3, np.int32),
              "counters": np.asarray(ref_slc["counters"]) + 7}
    chains = interop.chains_from_reference(
        {k: np.asarray(getattr(ref_chains, k)) for k in ("x", "beta", "e")},
        device="cpu")
    sim = tmc.Simulation(p1d.make_system(), chains, [
        dict(algorithm=tmc.ReplicaExchange, n_temps=2, seed=5)], 10,
        path=str(tmp_path / "port"))
    like = sim.init_device_state()["replica_exchange"]
    slc = interop.slice_from_reference("replica_exchange", ref_np, like)
    assert slc["key"] is like["key"]
    assert int(slc["calls"]) == 3 and slc["counters"].dtype == torch.int32
    back = interop.slice_to_reference("replica_exchange", slc)
    assert set(back) == {"calls", "counters"}
    np.testing.assert_array_equal(back["counters"], ref_np["counters"])
    with pytest.raises(ValueError, match="no carried slice"):
        interop.slice_to_reference("metropolis", slc)
