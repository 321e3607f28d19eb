"""The transverse-field Ising model in the port (``models/tfim.py``) against
the JAX package's.

Value for value, the reference's draws fed in (``split`` of each chain's
key into the two half-sweeps, each a ``uniform`` from the smallest normal
float32 up): one checkerboard sweep with the spins and the acceptances
equal outright and the cached action within rtol 1e-6 (the sum order
differs); the couplings, the initial action and the ED observables equal;
the state carried both ways with its class named.

Mirrored gates of ``tests/test_tfim.py`` run the port alone, at the
reference test's size (256 chains x N 6 x M 48, 150 steps of 15 sweeps)
and in its bands.
"""

import jax
import numpy as np
import pytest
import torch

import montecarlo_tpu_torch as tmc
from montecarlo_tpu.models import tfim as ref_tfim
from montecarlo_tpu_torch import interop
from montecarlo_tpu_torch.models import tfim
from montecarlo_tpu_torch.utils import prng
from torch_lattice_helpers import (TINY, _one_torch_thread,  # noqa: F401
                                   carry, ref_keys, vsplit, vuniform,
                                   warm_up_transcendentals)

warm_up_transcendentals()
N, M_SLICES, BETA, J = 6, 48, 1.0, 1.0
FIELDS = ("spins", "kx", "ktau", "energy")


def _carry(ref):
    return carry(ref, tfim.TFIMState, FIELDS)


def test_couplings_state_and_action_equal_the_reference():
    assert tfim.couplings(2.0, 1.0, 0.7, 64) == ref_tfim.couplings(
        2.0, 1.0, 0.7, 64)
    ref = ref_tfim.init_chains(3, N, M_SLICES, BETA, j=J, h=0.8, seed=1)
    st = _carry(ref)
    assert type(st) is tfim.TFIMState and st.spins.dtype == torch.int8
    back = ref_tfim.TFIMState(**interop.chains_to_reference(st))
    for k in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(back, k)),
                                      np.asarray(getattr(ref, k)))
    np.testing.assert_array_equal(
        tfim._action_energy(st.spins, st.kx, st.ktau).numpy(),
        np.asarray(ref.energy))
    mine = tfim.init_chains(4, N, M_SLICES, BETA, h=0.8, seed=2,
                            device="cpu")
    assert set(np.unique(mine.spins.numpy())) == {-1, 1}
    np.testing.assert_array_equal(
        mine.energy.numpy(),
        tfim._action_energy(mine.spins, mine.kx, mine.ktau).numpy())
    for n, h, beta in ((4, 0.5, 1.5), (6, 1.3, 0.7)):
        assert tfim.ed_observables(n, beta, J, h) == \
            ref_tfim.ed_observables(n, beta, J, h)


@pytest.mark.parametrize("h", [0.6, 1.2])
def test_checkerboard_sweep_value_for_value(h):
    m = 16
    ref = ref_tfim.init_chains(m, N, M_SLICES, BETA, j=J, h=h, seed=5)
    keys = ref_keys(2, m)
    want, acc = jax.vmap(ref_tfim.checkerboard_sweep)(ref, keys)
    u0, u1 = (vuniform(k, (N, M_SLICES), minval=TINY)
              for k in vsplit(keys, 2))
    got, a = tfim.checkerboard_sweep(_carry(ref), u0, u1)
    np.testing.assert_array_equal(a.numpy(), np.asarray(acc))
    np.testing.assert_array_equal(got.spins.numpy(), np.asarray(want.spins))
    np.testing.assert_allclose(got.energy.numpy(), np.asarray(want.energy),
                               rtol=1e-6)


def test_sampler_stream_differs_from_the_initial_spins(tmp_path):
    """init_chains and TFIMCheckerboard given one seed draw apart: the
    sampler's keys have the reference's tag 0x7F1 folded into ``key(seed)``
    before the chain ids, so its first sweep's uniforms are not the ones
    ``init_chains`` drew the spins from."""
    chains = tfim.init_chains(2, N, M_SLICES, BETA, seed=4, device="cpu")
    sim = tmc.Simulation(tfim.make_system(), chains,
                         [dict(algorithm=tfim.TFIMCheckerboard, seed=4)], 1,
                         path=str(tmp_path))
    alg = sim.device_algos[0]
    slc = alg.init_state(sim)
    base = prng.fold_in(prng.key(4, "cpu"), 0x7F1)
    assert torch.equal(slc["keys"],
                       prng.fold_in(base[None], torch.arange(2)))
    u = prng.uniform(prng.split(alg.unit_keys(slc, 0, 1)[:, 0]),
                     chains.spins.shape[1:])[:, 0]
    first = prng.uniform(prng.key(4, "cpu"), chains.spins.shape)
    assert not torch.equal(u, first)
    assert torch.equal(chains.spins, 2 * (first < 0.5).to(torch.int8) - 1)


def _run(tmp_path, h, n_chains=256, steps=150, sweeps=15, seed=4,
         record=False):
    chains = tfim.init_chains(n_chains, N, M_SLICES, BETA, j=J, h=h,
                              seed=seed, device="cpu")
    algos = [dict(algorithm=tfim.TFIMCheckerboard, sweeps=sweeps, seed=seed)]
    if record:
        algos.append(dict(
            algorithm=tmc.StoreCallbacks,
            callbacks=(tfim.make_sx_callback(BETA, h, M_SLICES),
                       tfim.callback_szsz, tfim.callback_sz2),
            scheduler=tmc.build_schedule(steps, 0, 2)))
    sim = tmc.Simulation(tfim.make_system(), chains, algos, steps,
                         path=str(tmp_path))
    sim.run()
    return sim


# -- mirrored gates: tests/test_tfim.py ----------------------------------------

def test_action_energy_cache_consistent(tmp_path):
    sim = _run(tmp_path, h=1.0, n_chains=16, steps=10, sweeps=2)
    st = sim.device_state["sys"]
    fresh = tfim._action_energy(st.spins, st.kx, st.ktau)
    np.testing.assert_allclose(st.energy.numpy(), fresh.numpy(), rtol=1e-4,
                               atol=1e-2)
    cnt = sim.device_state["tfim_cb"]["counters"].numpy()
    acc = cnt[..., 0].sum() / cnt[..., 1].sum()
    assert 0.05 < acc < 0.95
    assert cnt[..., 1].min() == 10 * 2 * N * M_SLICES


@pytest.mark.parametrize("h", [0.6, 1.2])
def test_pimc_matches_exact_diagonalization(tmp_path, h):
    """Trajectory averages from step 70 on against dense ED, in the
    reference test's bands."""
    _run(tmp_path, h, record=True)
    burn = 70
    got = {}
    for key, name in (("sx", "sx"), ("szsz", "szsz"), ("mz2", "sz2")):
        d = np.loadtxt(tmp_path / f"{name}.dat")
        got[key] = d[d[:, 0] >= burn, 1].mean()
    exact = tfim.ed_observables(N, BETA, J, h)
    for key, tol in (("sx", 0.025), ("szsz", 0.025), ("mz2", 0.035)):
        assert abs(got[key] - exact[key]) < tol, (
            f"h={h} {key}: pimc={got[key]:.4f} exact={exact[key]:.4f}")


def test_couplings_reject_zero_field():
    with pytest.raises(ValueError):
        tfim.couplings(1.0, 1.0, 0.0, 16)
    with pytest.raises(ValueError):
        tfim.init_chains(2, 5, 16, 1.0, device="cpu")   # odd N
    with pytest.raises(ValueError):
        tfim.init_chains(2, 6, 15, 1.0, device="cpu")   # odd M
