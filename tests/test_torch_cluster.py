"""The port's cluster labelling (``ops/cluster.py``) and its cluster
samplers against the JAX package's.

``component_labels`` and ``seed_component_mask`` equal the reference's
exactly on the same bonds, batched over chains and one lattice at a time,
at every fixpoint-check interval; and the host union-find of
``tests/test_cluster.py``.  Mirrored gates of ``tests/test_cluster.py``:
Swendsen-Wang Ising on even and odd lattices and the Potts Wolff and
Swendsen-Wang samplers against exact enumeration in its bands, and the
cached energies after many cluster steps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlo_tpu_torch as tmc
from montecarlo_tpu.ops import cluster as ref_cluster
from montecarlo_tpu_torch.models import ising2d, potts
from montecarlo_tpu_torch.ops.cluster import (component_labels,
                                              seed_component_mask)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test runner runs several files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _labels_np(act_right, act_down):
    """Reference labelling by union-find on the host."""
    lx, ly = act_right.shape
    parent = list(range(lx * ly))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)

    for i in range(lx):
        for j in range(ly):
            if act_right[i, j]:
                union(i * ly + j, i * ly + (j + 1) % ly)
            if act_down[i, j]:
                union(i * ly + j, ((i + 1) % lx) * ly + j)
    return np.array([find(a) for a in range(lx * ly)]).reshape(lx, ly)


@pytest.mark.parametrize("check_every", [1, 4])
@pytest.mark.parametrize("shape", [(4, 4), (5, 7), (8, 3), (6, 6)])
def test_component_labels_equal_the_reference(shape, check_every):
    rng = np.random.default_rng(0)
    lx, ly = shape
    ar = np.stack([rng.random((lx, ly)) < d for d in (0.2, 0.5, 0.8)])
    ad = np.stack([rng.random((lx, ly)) < d for d in (0.2, 0.5, 0.8)])
    got = component_labels(torch.as_tensor(ar), torch.as_tensor(ad),
                           check_every=check_every)
    assert got.dtype == torch.int32 and got.shape == (3, lx, ly)
    for c in range(3):
        want = np.asarray(ref_cluster.component_labels(
            jnp.asarray(ar[c]), jnp.asarray(ad[c])))
        np.testing.assert_array_equal(got[c].numpy(), want)
        np.testing.assert_array_equal(want, _labels_np(ar[c], ad[c]))
        one = component_labels(torch.as_tensor(ar[c]),
                               torch.as_tensor(ad[c]))
        np.testing.assert_array_equal(one.numpy(), want)


def test_seed_component_mask_equals_the_reference():
    rng = np.random.default_rng(1)
    ar = rng.random((3, 6, 6)) < 0.5
    ad = rng.random((3, 6, 6)) < 0.5
    sites = np.array([0, 7, 35])
    got = seed_component_mask(torch.as_tensor(ar), torch.as_tensor(ad),
                              torch.as_tensor(sites))
    labels = component_labels(torch.as_tensor(ar), torch.as_tensor(ad))
    for c, site in enumerate(sites):
        want = np.asarray(ref_cluster.seed_component_mask(
            jnp.asarray(ar[c]), jnp.asarray(ad[c]), int(site)))
        np.testing.assert_array_equal(got[c].numpy(), want)
        lab = labels[c].numpy()
        np.testing.assert_array_equal(want, lab == lab.reshape(-1)[site])
        one = seed_component_mask(torch.as_tensor(ar[c]),
                                  torch.as_tensor(ad[c]), int(site))
        np.testing.assert_array_equal(one.numpy(), want)


def _run(tmp_path, algo_spec, size, beta, n_chains, steps, burn, seed,
         q=None):
    if q is None:
        chains = ising2d.init_chains(n_chains, size, beta=beta, seed=seed,
                                     device="cpu")
        system, cbs, second = ising2d.make_system(), [
            ising2d.callback_energy_per_spin,
            ising2d.callback_magnetisation], "magnetisation"
    else:
        chains = potts.init_chains(n_chains, size, q=q, beta=beta, seed=seed,
                                   device="cpu")
        system, cbs, second = potts.make_system(q), [
            potts.callback_energy_per_spin,
            potts.callback_order_parameter(q)], "order_parameter"
    sim = tmc.Simulation(system, chains, [
        algo_spec,
        dict(algorithm=tmc.StoreCallbacks, callbacks=cbs,
             scheduler=tmc.build_schedule(steps, burn, 1))],
        steps, path=str(tmp_path))
    sim.run()
    e = np.loadtxt(tmp_path / "energy_per_spin.dat")[:, 1]
    m = np.loadtxt(tmp_path / f"{second}.dat")[:, 1]
    return e.mean(), m.mean(), sim


@pytest.mark.parametrize("size, beta, seed, algo_seed", [
    (4, 0.35, 17, 3),
    (3, 0.4, 19, 5),      # odd: no 2-colouring, FK clusters stay exact
])
def test_swendsen_wang_matches_exact_enumeration(tmp_path, size, beta, seed,
                                                 algo_seed):
    e_exact, m_exact = ising2d.exact_moments(size, beta)
    e, m, sim = _run(tmp_path, dict(algorithm=ising2d.SwendsenWang,
                                    seed=algo_seed),
                     size=size, beta=beta, n_chains=128, steps=900, burn=150,
                     seed=seed)
    assert abs(e - e_exact) < 0.03
    assert abs(m - m_exact) < 0.03
    counters = sim.device_state["swendsen_wang"]["counters"].numpy()
    assert (counters[..., 1] == 900).all()
    assert (counters[..., 0] >= 900).all()


def test_swendsen_wang_energy_cache_consistent():
    st = ising2d.init_chains(8, 6, beta=0.45, seed=3, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for _ in range(30):
        up = torch.rand((8, 36), generator=gen) < 0.5
        st, _ = ising2d.swendsen_wang_step(
            st, torch.rand((8, 6, 6), generator=gen),
            torch.rand((8, 6, 6), generator=gen),
            2 * up.to(torch.int8) - 1)
    s = st.spins.numpy().astype(np.float64)
    full = -(s * (np.roll(s, 1, axis=1) + np.roll(s, 1, axis=2))
             ).sum(axis=(1, 2))
    np.testing.assert_allclose(st.energy.numpy(), full, atol=1e-3)


def test_potts_swendsen_wang_matches_exact(tmp_path):
    q, size, beta = 3, 3, 0.6
    e_exact, m_exact = potts.exact_moments(size, q, beta)
    e, m, _ = _run(tmp_path, dict(algorithm=potts.SwendsenWangPotts(q),
                                  seed=3),
                   size=size, beta=beta, n_chains=128, steps=900, burn=150,
                   seed=23, q=q)
    assert abs(e - e_exact) < 0.03
    assert abs(m - m_exact) < 0.03


def test_potts_wolff_matches_exact(tmp_path):
    q, size, beta = 3, 3, 0.6
    e_exact, m_exact = potts.exact_moments(size, q, beta)
    e, m, sim = _run(tmp_path, dict(algorithm=potts.WolffPotts(q), seed=3,
                                    clusters=4),
                     size=size, beta=beta, n_chains=128, steps=1200,
                     burn=200, seed=29, q=q)
    assert abs(e - e_exact) < 0.03
    assert abs(m - m_exact) < 0.03
    counters = sim.device_state["wolff"]["counters"].numpy()
    assert (counters[..., 1] == 4 * 1200).all()


def test_potts_cluster_energy_cache_consistent():
    st = potts.init_chains(8, 5, q=4, beta=0.7, seed=3, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        st, _ = potts.swendsen_wang_step(
            st, 4, torch.rand((8, 5, 5), generator=gen),
            torch.rand((8, 5, 5), generator=gen),
            torch.randint(0, 4, (8, 25), generator=gen))
        st, _ = potts.wolff_step(
            st, 4, torch.rand((8, 5, 5), generator=gen),
            torch.rand((8, 5, 5), generator=gen),
            torch.randint(0, 25, (8,), generator=gen),
            torch.randint(0, 3, (8,), generator=gen))
    s = st.spins.numpy()
    full = -((s == np.roll(s, 1, axis=1)).astype(np.float64)
             + (s == np.roll(s, 1, axis=2)).astype(np.float64)
             ).sum(axis=(1, 2))
    np.testing.assert_allclose(st.energy.numpy(), full, atol=1e-3)
