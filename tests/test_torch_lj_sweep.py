"""The port's fused LJ sweeps against the JAX package's Pallas kernels.

On the CPU the port's ``fused_lj_sweep`` and ``fused_lj_mixed_sweep`` take
their plain torch versions; the reference runs its Pallas kernels in
interpret mode, with the same counter-hash stream and block geometry.

Tolerances: equal accept and attempt counts and equal species; positions
within atol 1e-5 and energies within rtol 1e-5.  The two differ by the
float32 ulps of XLA's and torch's log/cos/sin and by the order of the row
sums (the port sums in its CUDA kernel's lane order), which leave positions
within ~1e-6 over 250 steps.  An accept decision that flips on such an ulp
would send a chain its own way; the seeds here are ones where none does.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlo_tpu_torch as tmc
from montecarlo_tpu.models import lennard_jones as ref_lj
from montecarlo_tpu.ops import lj_sweep as ref_ops
from montecarlo_tpu_torch import interop
from montecarlo_tpu_torch.models import lennard_jones as lj
from montecarlo_tpu_torch.ops import lj_sweep as ops

ATOL, RTOL = 1e-5, 1e-5
SIGMA, SEED, T0 = 0.12, 7, 3
# (M, block_chains): one block, and a 3-block grid that folds pid into the
# seed (and, mixed, draws a kind per block)
LAYOUTS = {"single": (8, 256), "gridded": (20, 8)}


@functools.lru_cache(maxsize=None)
def _state(m, n=32, frac_b=0.25, seed=5, rho=0.6):
    """The reference's initial chains and the same chains in the port."""
    ref = ref_lj.init_chains(m, n, rho=rho, beta=1.0, frac_b=frac_b,
                             seed=seed)
    return ref, interop.chains_from_reference(ref)


def _box(st):
    return float(np.asarray(st.box)[0])


def _ref_sweep(st, n_steps, w_disp=None, bc=256, t0=T0):
    args = (st.pos, st.species, st.beta, st.energy, _box(st), SIGMA)
    if w_disp is None:
        return [np.asarray(a) for a in ref_ops.fused_lj_sweep(
            *args, SEED, t0, n_steps, params=ref_lj.LJParams(),
            interpret=True, block_chains=bc)]
    return [np.asarray(a) for a in ref_ops.fused_lj_mixed_sweep(
        *args, w_disp, SEED, t0, n_steps, params=ref_lj.LJParams(),
        interpret=True, block_chains=bc)]


def _sweep(st, n_steps, w_disp=None, bc=256, t0=T0, pos=None, species=None,
           energy=None):
    args = (st.pos if pos is None else pos,
            st.species if species is None else species, st.beta,
            st.energy if energy is None else energy, _box(st), SIGMA)
    if w_disp is None:
        return ops.fused_lj_sweep(*args, SEED, t0, n_steps,
                                  params=lj.LJParams(), block_chains=bc)
    return ops.fused_lj_mixed_sweep(*args, w_disp, SEED, t0, n_steps,
                                    params=lj.LJParams(), block_chains=bc)


def test_scalar_table_equals_reference_bit_for_bit():
    for params in (ref_lj.LJParams(), ref_lj.LJParams(
            eps=((1.0, 0.7), (0.7, 2.0)), sig=((1.1, 0.9), (0.9, 1.3)),
            rcut=3.1)):
        port = lj.LJParams(eps=params.eps, sig=params.sig, rcut=params.rcut)
        for box, sigma, w in ((7.302967433402215, 0.12, 0.7),
                              (19.12, 0.1, 1.0), (3.0, 0.5, 0.25)):
            want = np.asarray(ref_ops._lj_scalars(params, box, sigma, w))
            got = ops._lj_scalars(port, box, sigma, w)
            assert got.dtype == np.float32 and got.shape == (16,)
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("n_steps", [0, 1, 250])
def test_displacement_sweep_matches_reference(layout, n_steps):
    m, bc = LAYOUTS[layout]
    ref, st = _state(m)
    pos_r, e_r, acc_r = _ref_sweep(ref, n_steps, bc=bc)
    pos, e, acc = _sweep(st, n_steps, bc=bc)
    assert pos.dtype == e.dtype == torch.float32 and acc.dtype == torch.int32
    assert pos.shape == st.pos.shape and acc.shape == (m,)
    np.testing.assert_array_equal(acc.numpy(), acc_r)
    np.testing.assert_allclose(pos.numpy(), pos_r, rtol=0, atol=ATOL)
    np.testing.assert_allclose(e.numpy(), e_r, rtol=RTOL, atol=0)
    if n_steps > 1:
        assert 0 < acc.sum() < m * n_steps


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("n_steps", [0, 1, 250])
def test_mixed_sweep_matches_reference(layout, n_steps):
    m, bc = LAYOUTS[layout]
    ref, st = _state(m)
    pos_r, spc_r, e_r, acc_r, tot_r = _ref_sweep(ref, n_steps, w_disp=0.7,
                                                 bc=bc)
    pos, spc, e, acc, tot = _sweep(st, n_steps, w_disp=0.7, bc=bc)
    assert spc.dtype == torch.int32 and acc.shape == tot.shape == (m, 2)
    np.testing.assert_array_equal(tot.numpy(), tot_r)
    np.testing.assert_array_equal(acc.numpy(), acc_r)
    np.testing.assert_array_equal(spc.numpy(), spc_r)
    np.testing.assert_allclose(pos.numpy(), pos_r, rtol=0, atol=ATOL)
    np.testing.assert_allclose(e.numpy(), e_r, rtol=RTOL, atol=0)
    if n_steps > 1:
        assert (acc[:, 1].sum() > 0) and (tot[:, 1].sum() > 0)


def test_gridded_blocks_draw_their_own_kinds():
    """With 3 blocks of 8 chains, steps where the blocks' kind draws differ
    exist, and each chain's attempts follow its own block."""
    _, st = _state(20)
    *_, tot = _sweep(st, 250, w_disp=0.7, bc=8)
    blocks = tot.numpy()[[0, 8, 16]]
    assert len({tuple(b) for b in blocks}) > 1
    for c, b in enumerate(tot.numpy()):
        np.testing.assert_array_equal(b, blocks[c // 8])


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sweep_is_segmentation_invariant(mixed, layout):
    """One call of n steps equals calls summing to n, bit for bit."""
    m, bc = LAYOUTS[layout]
    _, st = _state(m)

    def run(n, t0, pos, spc, e):            # -> (pos, species, e, accepted)
        out = _sweep(st, n, w_disp=0.7 if mixed else None, bc=bc, t0=t0,
                     pos=pos, species=spc, energy=e)
        return out[:4] if mixed else (out[0], spc, out[1], out[2])

    one = run(161, 5, st.pos, st.species, st.energy)
    pos, spc, e, t = st.pos, st.species, st.energy, 5
    acc = torch.zeros_like(one[3])
    for n in (60, 1, 0, 100):
        pos, spc, e, a = run(n, t, pos, spc, e)
        acc, t = acc + a, t + n
    for got, want in zip((pos, spc, e, acc), one):
        assert torch.equal(got, want)


@pytest.mark.parametrize("mixed", [False, True])
def test_energy_cache_matches_full_recompute(mixed):
    """After hundreds of attempts the incremental energies match the
    port's and the reference's O(N^2) energies within the reference's own
    bounds (rtol 3e-4, atol 5e-2); positions stay in [0, box); swaps keep
    the composition."""
    ref, st = _state(8)
    if mixed:
        pos, spc, e, acc, _ = _sweep(st, 300, w_disp=0.7)
        assert not torch.equal(spc, st.species)
    else:
        (pos, e, acc), spc = _sweep(st, 300), st.species
    new = dataclasses.replace(st, pos=pos, species=spc)
    full = lj.total_energy(new, lj.LJParams()).numpy()
    np.testing.assert_allclose(e.numpy(), full, rtol=3e-4, atol=5e-2)
    ref_new = dataclasses.replace(ref, pos=jnp.asarray(pos.numpy()),
                                  species=jnp.asarray(spc.numpy()))
    ref_full = np.asarray(jax.vmap(
        lambda s: ref_lj.total_energy(s, ref_lj.LJParams()))(ref_new))
    np.testing.assert_allclose(e.numpy(), ref_full, rtol=3e-4, atol=5e-2)
    assert float(pos.min()) >= 0.0 and float(pos.max()) < _box(st)
    assert torch.equal(spc.sum(1), st.species.sum(1))
    rate = float(acc.sum()) / (8 * 300)
    assert 0.05 < rate < 0.98


def test_mono_species_chains_reject_every_swap():
    ref, st = _state(4, n=24, frac_b=0.0, seed=2, rho=0.5)
    pos, spc, e, acc, tot = _sweep(st, 200, w_disp=0.5, bc=4)
    *_, acc_r, tot_r = _ref_sweep(ref, 200, w_disp=0.5, bc=4)
    assert int(spc.sum()) == 0 and torch.equal(spc, st.species)
    assert int(acc[:, 1].sum()) == 0 and int(tot[:, 1].sum()) > 0
    np.testing.assert_array_equal(acc.numpy(), acc_r)
    np.testing.assert_array_equal(tot.numpy(), tot_r)
    full = lj.total_energy(dataclasses.replace(st, pos=pos),
                           lj.LJParams()).numpy()
    np.testing.assert_allclose(e.numpy(), full, rtol=3e-4, atol=5e-2)


def test_mixed_kind_fractions_follow_the_weight():
    _, st = _state(8)
    *_, acc, tot = _sweep(st, 400, w_disp=0.8)
    tot, acc = tot.numpy(), acc.numpy()
    assert np.all(tot.sum(axis=1) == 400)
    assert abs(tot[:, 0].sum() / tot.sum() - 0.8) < 0.06
    assert np.all(acc <= tot)


def _generic_rates(st, pool, steps, path):
    sim = tmc.Simulation(lj.make_system(), st, [
        dict(algorithm=tmc.Metropolis, pool=pool, seed=3, fused="off")],
        steps, path=path)
    met = sim.device_algos[0]
    assert not met.supports_fused
    ds = sim.init_device_state()
    for t in range(1, steps + 1):
        ds = met.step({**ds, "t": t}, t)
    cnt = ds["metropolis"]["counters"].numpy()
    return cnt[..., 0].sum(axis=0) / cnt[..., 1].sum(axis=0)


@pytest.mark.parametrize("mixed", [False, True])
def test_fused_matches_generic_acceptance(mixed, tmp_path):
    """Acceptance per move kind agrees between the fused sweep and the
    port's generic path on the same pool (the reference's bounds: 0.08 for
    the displacement, 0.10 for the swap)."""
    _, st = _state(8)
    steps = 400 if mixed else 250
    if mixed:
        *_, acc, tot = _sweep(st, steps, w_disp=0.7)
        fused = (acc.sum(0) / tot.sum(0)).numpy()
        pool = (lj.lj_displacement_move(SIGMA, weight=0.7),
                lj.lj_swap_move(weight=0.3))
    else:
        _, _, acc = _sweep(st, steps)
        fused = np.asarray([float(acc.sum()) / (8 * steps)])
        pool = (lj.lj_displacement_move(SIGMA),)
    generic = _generic_rates(st, pool, steps, str(tmp_path))
    assert abs(fused[0] - generic[0]) < 0.08
    if mixed:
        assert abs(fused[1] - generic[1]) < 0.10


def test_lane_sum_is_the_kernels_order():
    """The plain version's row sum is the lane-strided partial sums and
    the butterfly, written out in float32 one addition at a time."""
    rng = np.random.default_rng(3)
    for n in (1, 24, 32, 45, 256):
        u = rng.normal(size=(3, n)).astype(np.float32)
        want = np.zeros(3, np.float32)
        for c in range(3):
            lanes = [np.float32(0.0)] * 32
            for j in range(n):
                lanes[j % 32] = np.float32(lanes[j % 32] + u[c, j])
            w = 32
            while w > 1:
                w //= 2
                lanes = [np.float32(lanes[k] + lanes[k + w])
                         for k in range(w)]
            want[c] = lanes[0]
        got = ops._lane_sum(torch.from_numpy(u)).numpy()
        np.testing.assert_array_equal(got, want)


def test_sweep_checks_its_arguments():
    _, st = _state(8)
    with pytest.raises(ValueError):
        _sweep(st, -1)
    with pytest.raises(ValueError):
        ops.fused_lj_sweep(st.pos[..., 0], st.species, st.beta, st.energy,
                           _box(st), SIGMA, SEED, 0, 1, params=lj.LJParams())
