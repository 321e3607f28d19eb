"""The port's fused Gaussian sweep against the JAX package's Pallas kernel.

On the CPU the port's ``fused_gaussian_sweep`` takes its plain torch
version; the reference runs its Pallas kernel in interpret mode, with the
same counter-hash stream.  Tolerance: atol 1e-5 on x and e, with equal
accept counts.  The two differ only by the float32 ulps of XLA's and
torch's log/cos/sin, which leave positions within ~1e-6 over 101 steps.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.models import particle1d as ref_p1d
from montecarlo_tpu.ops.fused_sweep import fused_gaussian_sweep as ref_sweep
from montecarlo_tpu_torch.models import particle1d as p1d
from montecarlo_tpu_torch.ops.fused_sweep import (fused_gaussian_sweep,
                                                  kernel_potential)
from torch_lattice_helpers import warm_up_transcendentals

ATOL = 1e-5


# The first test of this file to reach ``torch.log``
# (``double_well-4-1-gridded``) can be, in a fresh test worker, the process's
# first vector call of it, which once put x up to 2.6e-5 off; warming every
# transcendental up at import, before any test runs, keeps that away.
warm_up_transcendentals()
POTENTIALS = {"harmonic": (ref_p1d.harmonic, p1d.harmonic),
              "double_well": (ref_p1d.double_well, p1d.double_well)}
# (M, block_rows): one block, and a 3-block grid that folds pid into the seed
LAYOUTS = {"single": (2000, 2048), "gridded": (3000, 8)}


def _inputs(m, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2.0, 2.0, m).astype(np.float32)
    beta = rng.uniform(0.5, 3.0, m).astype(np.float32)
    return x, beta


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("n_steps", [0, 1, 101])
@pytest.mark.parametrize("t0", [4, 3])
@pytest.mark.parametrize("pot", sorted(POTENTIALS))
def test_sweep_matches_reference(pot, t0, n_steps, layout):
    m, block_rows = LAYOUTS[layout]
    ref_u, u = POTENTIALS[pot]
    x, beta = _inputs(m, seed=t0 + n_steps)
    seed, sigma = 11, 0.7
    xr, er, ar = (np.asarray(a) for a in ref_sweep(
        jnp.asarray(x), jnp.asarray(beta), sigma, seed, t0, n_steps,
        potential=ref_u, interpret=True, block_rows=block_rows))
    xp, ep, ap = fused_gaussian_sweep(
        torch.from_numpy(x), torch.from_numpy(beta), sigma, seed, t0,
        n_steps, potential=u, block_rows=block_rows)
    assert xp.dtype == ep.dtype == torch.float32 and ap.dtype == torch.int32
    np.testing.assert_array_equal(ap.numpy(), ar)
    np.testing.assert_allclose(xp.numpy(), xr, rtol=0, atol=ATOL)
    np.testing.assert_allclose(ep.numpy(), er, rtol=0, atol=ATOL)
    if n_steps > 0:
        assert 0 < ap.sum() < m * n_steps


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sweep_is_segmentation_invariant(layout):
    """One call of n steps equals calls summing to n, bit for bit, with
    segment boundaries inside step pairs."""
    m, block_rows = LAYOUTS[layout]
    x, beta = _inputs(m, seed=5)
    x, beta = torch.from_numpy(x), torch.from_numpy(beta)
    kw = dict(potential=p1d.double_well, block_rows=block_rows)
    x1, e1, a1 = fused_gaussian_sweep(x, beta, 0.5, 3, 7, 61, **kw)
    xs, acc, t = x, torch.zeros_like(a1), 7
    for n in (20, 1, 0, 40):
        xs, es, a = fused_gaussian_sweep(xs, beta, 0.5, 3, t, n, **kw)
        acc, t = acc + a, t + n
    assert torch.equal(x1, xs) and torch.equal(e1, es)
    assert torch.equal(a1, acc)


def test_sweep_energy_is_potential_of_positions():
    x, beta = _inputs(1000, seed=9)
    xo, eo, _ = fused_gaussian_sweep(torch.from_numpy(x),
                                     torch.from_numpy(beta), 0.5, 1, 0, 10,
                                     potential=p1d.double_well)
    assert torch.equal(eo, p1d.double_well(xo))


def test_kernel_potential_table():
    assert kernel_potential(p1d.harmonic) == (0, 0.0, 0.0, 0.0)
    assert kernel_potential(p1d.double_well) == (1, 1.0, 1.0, 1.0)
    assert kernel_potential(functools.partial(p1d.double_well, a=2.0,
                                              h=0.5)) == (1, 4.0, 0.5, 16.0)
    assert kernel_potential(functools.partial(p1d.double_well, 2.0)) is None
    assert kernel_potential(lambda x: x * x) is None
    assert kernel_potential(ref_p1d.harmonic) is None


def test_sweep_rejects_negative_steps():
    x = torch.zeros(8)
    with pytest.raises(ValueError):
        fused_gaussian_sweep(x, x + 1, 0.5, 0, 0, -1, potential=p1d.harmonic)
