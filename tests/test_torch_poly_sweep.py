"""The port's fused polydisperse swap sweep against the JAX package's Pallas
kernel.

On the CPU the port's ``fused_poly_mixed_sweep`` takes its plain torch
version; the reference runs its Pallas kernel in interpret mode, with the
same counter-hash stream and block geometry.

Tolerances: equal accept and attempt counts and equal diameters; positions
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
from montecarlo_tpu.models import polydisperse as ref_poly
from montecarlo_tpu.ops import poly_sweep as ref_ops
from montecarlo_tpu_torch import interop
from montecarlo_tpu_torch.models import polydisperse as poly
from montecarlo_tpu_torch.ops import poly_sweep as ops

ATOL, RTOL = 1e-5, 1e-5
SIGMA, W_DISP, SEED, T0 = 0.1, 0.7, 7, 3
# (M, block_chains): one block, and a 3-block grid that folds pid into the
# seed and draws a kind per block
LAYOUTS = {"single": (8, 256), "gridded": (20, 8)}


@functools.lru_cache(maxsize=None)
def _state(m, n=32, seed=5, rho=0.9, beta=1.0):
    """The reference's initial chains and the same chains in the port."""
    ref = ref_poly.init_chains(m, n, rho=rho, beta=beta, seed=seed)
    return ref, interop.chains_from_reference(ref, device="cpu")


def _box(st):
    return float(np.asarray(st.box)[0])


def _ref_sweep(st, n_steps, bc=256, t0=T0, w_disp=W_DISP):
    return [np.asarray(a) for a in ref_ops.fused_poly_mixed_sweep(
        st.pos, st.diam, st.beta, st.energy, _box(st), SIGMA, w_disp, SEED,
        t0, n_steps, params=ref_poly.PolyParams(), interpret=True,
        block_chains=bc)]


def _sweep(st, n_steps, bc=256, t0=T0, w_disp=W_DISP, pos=None, diam=None,
           energy=None, interpret=False):
    return ops.fused_poly_mixed_sweep(
        st.pos if pos is None else pos, st.diam if diam is None else diam,
        st.beta, st.energy if energy is None else energy, _box(st), SIGMA,
        w_disp, SEED, t0, n_steps, params=poly.PolyParams(),
        interpret=interpret, block_chains=bc)


def test_scalar_table_equals_reference_bit_for_bit():
    """The 9 floats the reference builds inside its jitted wrapper: sigma,
    box, 1/box in float32, eps, x_c^2, c0, c2, c4 from float64, w_disp."""
    for params in (ref_poly.PolyParams(), ref_poly.PolyParams(eps=0.1,
                                                              xc=1.4)):
        port = poly.PolyParams(eps=params.eps, xc=params.xc)
        c0, c2, c4 = params.coeffs()
        for box, sigma, w in ((16.865, 0.1, 0.8), (5.962847939999439, 0.12,
                                                   0.7), (3.0, 0.5, 0.25)):
            want = np.asarray(jnp.concatenate([
                jnp.stack([jnp.asarray(sigma, jnp.float32),
                           jnp.asarray(box, jnp.float32),
                           1.0 / jnp.asarray(box, jnp.float32)]),
                jnp.asarray([params.eps, params.xc ** 2, c0, c2, c4],
                            jnp.float32),
                jnp.asarray(w, jnp.float32).reshape(1)]))
            got = ops._poly_scalars(port, box, sigma, w)
            assert got.dtype == np.float32 and got.shape == (9,)
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("n_steps", [0, 1, 250])
def test_sweep_matches_reference(layout, n_steps):
    m, bc = LAYOUTS[layout]
    ref, st = _state(m)
    pos_r, dia_r, e_r, acc_r, tot_r = _ref_sweep(ref, n_steps, bc=bc)
    pos, dia, e, acc, tot = _sweep(st, n_steps, bc=bc)
    assert pos.dtype == dia.dtype == e.dtype == torch.float32
    assert acc.dtype == tot.dtype == torch.int32
    assert pos.shape == st.pos.shape and acc.shape == tot.shape == (m, 2)
    np.testing.assert_array_equal(tot.numpy(), tot_r)
    np.testing.assert_array_equal(acc.numpy(), acc_r)
    np.testing.assert_array_equal(dia.numpy(), dia_r)
    np.testing.assert_allclose(pos.numpy(), pos_r, rtol=0, atol=ATOL)
    np.testing.assert_allclose(e.numpy(), e_r, rtol=RTOL, atol=0)
    if n_steps > 1:
        assert (acc[:, 0].sum() > 0) and (acc[:, 1].sum() > 0)
        assert not torch.equal(dia, st.diam)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("n", [64, 100])
def test_sweep_matches_reference_with_several_warps(layout, n):
    """N where the kernel's block has W > 1 warps, so the plain version
    sums the rows in a block's thread order (N 100: no multiple of 32)."""
    assert ops.poly_block_warps(n) > 1
    m, bc = LAYOUTS[layout]
    ref, st = _state(m, n)
    pos_r, dia_r, e_r, acc_r, tot_r = _ref_sweep(ref, 250, bc=bc)
    pos, dia, e, acc, tot = _sweep(st, 250, bc=bc)
    np.testing.assert_array_equal(tot.numpy(), tot_r)
    np.testing.assert_array_equal(acc.numpy(), acc_r)
    np.testing.assert_array_equal(dia.numpy(), dia_r)
    np.testing.assert_allclose(pos.numpy(), pos_r, rtol=0, atol=ATOL)
    np.testing.assert_allclose(e.numpy(), e_r, rtol=RTOL, atol=0)
    assert (acc[:, 0].sum() > 0) and (acc[:, 1].sum() > 0)


def test_gridded_blocks_draw_their_own_kinds():
    """With 3 blocks of 8 chains, steps where the blocks' kind draws differ
    exist, and each chain's attempts follow its own block."""
    _, st = _state(20)
    *_, tot = _sweep(st, 250, bc=8)
    blocks = tot.numpy()[[0, 8, 16]]
    assert len({tuple(b) for b in blocks}) > 1
    for c, b in enumerate(tot.numpy()):
        np.testing.assert_array_equal(b, blocks[c // 8])


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sweep_is_segmentation_invariant(layout):
    """One call of n steps equals calls summing to n, bit for bit."""
    m, bc = LAYOUTS[layout]
    _, st = _state(m)
    one = _sweep(st, 161, bc=bc, t0=5)
    pos, dia, e, t = st.pos, st.diam, st.energy, 5
    acc, tot = torch.zeros_like(one[3]), torch.zeros_like(one[4])
    for n in (60, 1, 0, 100):
        pos, dia, e, a, k = _sweep(st, n, bc=bc, t0=t, pos=pos, diam=dia,
                                   energy=e)
        acc, tot, t = acc + a, tot + k, t + n
    for got, want in zip((pos, dia, e, acc, tot), one):
        assert torch.equal(got, want)


def test_energy_cache_matches_full_recompute():
    """After 300 attempts the incremental energies match the port's and the
    reference's O(N^2) energies within the reference's own bounds (rtol
    3e-3, atol 8e-2, ``tests/test_fused_kernels.py``); positions stay in
    [0, box); swaps keep each chain's diameters and move some."""
    ref, st = _state(8, beta=2.0)
    pos, dia, e, acc, tot = _sweep(st, 300, bc=8)
    new = dataclasses.replace(st, pos=pos, diam=dia)
    full = poly.total_energy(new).numpy()
    np.testing.assert_allclose(e.numpy(), full, rtol=3e-3, atol=8e-2)
    ref_new = dataclasses.replace(ref, pos=jnp.asarray(pos.numpy()),
                                  diam=jnp.asarray(dia.numpy()))
    ref_full = np.asarray(jax.vmap(ref_poly.total_energy)(ref_new))
    np.testing.assert_allclose(e.numpy(), ref_full, rtol=3e-3, atol=8e-2)
    assert float(pos.min()) >= 0.0 and float(pos.max()) < _box(st)
    assert torch.equal(dia.sort(1).values, st.diam.sort(1).values)
    assert not torch.equal(dia, st.diam)
    assert torch.all(tot.sum(1) == 300) and int(acc[:, 1].sum()) > 0


def test_kind_fractions_follow_the_weight():
    _, st = _state(8)
    for w in (0.8, 0.3):
        _, _, _, acc, tot = _sweep(st, 400, w_disp=w)
        tot, acc = tot.numpy(), acc.numpy()
        assert np.all(tot.sum(axis=1) == 400)
        # one block: 400 kind draws, within 3.5 binomial sigmas of w
        assert abs(tot[0, 0] / 400 - w) < 3.5 * (w * (1 - w) / 400) ** 0.5
        assert np.all(acc <= tot)


def test_two_particles_swap_freely():
    """N 2: a swap leaves out both particles' rows, so dE is 0 and every
    swap is accepted; the pair exchanges its diameters each time."""
    ref, st = _state(4, n=2, rho=0.5)
    pos, dia, e, acc, tot = _sweep(st, 100, w_disp=0.5)
    pos_r, dia_r, e_r, acc_r, tot_r = _ref_sweep(ref, 100, w_disp=0.5)
    np.testing.assert_array_equal(acc.numpy(), acc_r)
    np.testing.assert_array_equal(dia.numpy(), dia_r)
    assert torch.equal(acc[:, 1], tot[:, 1]) and int(tot[0, 1]) > 0
    swapped = int(tot[0, 1]) % 2 == 1
    assert torch.equal(dia, st.diam.flip(1) if swapped else st.diam)


def _generic_rates(st, pool, steps, path):
    sim = tmc.Simulation(poly.make_system(), st, [
        dict(algorithm=tmc.Metropolis, pool=pool, seed=3, fused="off")],
        steps, path=path)
    met = sim.device_algos[0]
    assert not met.supports_fused
    ds = sim.init_device_state()
    for t in range(1, steps + 1):
        ds = met.step({**ds, "t": t}, t)
    cnt = ds["metropolis"]["counters"].numpy()
    return cnt[..., 0].sum(axis=0) / cnt[..., 1].sum(axis=0)


def test_fused_matches_generic_acceptance(tmp_path):
    """Acceptance per move kind agrees between the fused sweep and the
    port's generic path on the same pool (the reference's bounds,
    ``tests/test_fused_kernels.py``: 0.08 for the displacement, 0.10 for
    the swap)."""
    _, st = _state(8)
    *_, acc, tot = _sweep(st, 400, bc=8)
    fused = (acc.sum(0) / tot.sum(0)).numpy()
    pool = (poly.displacement_move(SIGMA, weight=W_DISP),
            poly.swap_move(weight=1.0 - W_DISP))
    generic = _generic_rates(st, pool, 400, str(tmp_path))
    assert abs(fused[0] - generic[0]) < 0.08
    assert abs(fused[1] - generic[1]) < 0.10


def test_sweep_checks_its_arguments():
    _, st = _state(8)
    with pytest.raises(ValueError):
        _sweep(st, -1)
    with pytest.raises(ValueError):              # pos not (M, N, 2)
        ops.fused_poly_mixed_sweep(st.pos[..., 0], st.diam, st.beta,
                                   st.energy, _box(st), SIGMA, W_DISP, SEED,
                                   0, 1, params=poly.PolyParams())
    one = dataclasses.replace(st, pos=st.pos[:, :1].contiguous(),
                              diam=st.diam[:, :1].contiguous())
    for interpret in (False, True):              # a swap needs two particles
        with pytest.raises(ValueError, match="N >= 2"):
            _sweep(one, 1, interpret=interpret)
