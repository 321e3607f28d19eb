"""The plain references replay the row kernels' plain versions bit for bit
on the CPU (where both take torch's CPU log, sqrt, cos and sin), and
their O(N^2) energy agrees with the port's; the bfloat16 control does
not."""

import os
import sys

import numpy as np
import pytest
import torch

from montecarlo_tpu_torch.models import lennard_jones as lj
from montecarlo_tpu_torch.models import particle1d as p1d
from montecarlo_tpu_torch.ops.fused_sweep import fused_gaussian_sweep
from montecarlo_tpu_torch.ops.lj_sweep import fused_lj_mixed_sweep

from bench_helpers import HERE

sys.path.insert(0, os.path.join(HERE, "configs"))
import harmonic1d_reference as href  # noqa: E402
import ka2d_reference as kref  # noqa: E402


@pytest.mark.parametrize("t0,n", [(0, 100), (7, 33), (80, 20), (3, 1)])
@pytest.mark.parametrize("m", [64, 3000])
def test_gaussian_replay_equals_plain_version(t0, n, m):
    rng = np.random.default_rng(m + t0)
    x0 = rng.uniform(-2, 2, m).astype(np.float32)
    beta = rng.uniform(0.5, 3.0, m).astype(np.float32)
    xp, ep, ap = fused_gaussian_sweep(
        torch.tensor(x0), torch.tensor(beta), 0.1, 2 ** 31 - 5, t0, n,
        potential=p1d.harmonic, interpret=True)
    s = np.sort(rng.choice(m, 16, replace=False))
    x, e, a = href.replay(x0[s], beta[s], s, m, 0.1, 2 ** 31 - 5, t0, n,
                          "cpu")
    assert np.array_equal(xp.numpy()[s], x)
    assert np.array_equal(ep.numpy()[s], e)
    assert np.array_equal(ap.numpy()[s], a)
    xc, _, _ = href.replay(x0[s], beta[s], s, m, 0.1, 2 ** 31 - 5, t0, n,
                           "cpu", "bfloat16")
    assert not np.array_equal(xc, x)


@pytest.mark.parametrize("m,n,t0,steps", [(8, 64, 5, 300), (8, 100, 64, 257)])
def test_lj_replay_equals_plain_version(m, n, t0, steps):
    st = lj.init_chains(m, n, rho=1.2, beta=1 / 0.45, frac_b=0.35, seed=m + n,
                        device="cpu")
    box = float(st.box[0])
    p = lj.LJParams()
    out = fused_lj_mixed_sweep(st.pos, st.species, st.beta, st.energy, box,
                               0.08, 0.8, 987654321, t0, steps, params=p,
                               interpret=True)
    s = np.array([0, 3, 7])
    tab = kref.pair_table(p.eps, p.sig, p.rcut, box)
    ref = kref.replay(st.pos.numpy()[s], st.species.numpy()[s],
                      st.energy.numpy()[s], st.beta.numpy()[s], s, m, tab,
                      0.08, 0.8, 987654321, t0, steps, "cpu")
    prog = (out[0].numpy()[s], out[1].numpy()[s].astype(np.float32),
            out[2].numpy()[s], out[3].numpy()[s], out[4].numpy()[s])
    for a, b in zip(prog, ref):
        assert np.array_equal(a, b)
    assert out[3].numpy()[s].sum() > 0
    ctl = kref.replay(st.pos.numpy()[s], st.species.numpy()[s],
                      st.energy.numpy()[s], st.beta.numpy()[s], s, m, tab,
                      0.08, 0.8, 987654321, t0, steps, "cpu", "bfloat16")
    assert not np.array_equal(ctl[0], ref[0])


def test_lj_energy_agrees_with_the_port():
    st = lj.init_chains(4, 100, rho=1.2, beta=1 / 0.45, frac_b=0.35, seed=3,
                        device="cpu")
    p = lj.LJParams()
    e = kref.total_energy(st.pos.numpy(), st.species.numpy(),
                          float(st.box[0]), p.eps, p.sig, p.rcut, "cpu",
                          row_batch=37)
    np.testing.assert_allclose(e, lj.total_energy(st, p).double().numpy(),
                               rtol=1e-5)


def test_lane_sum_order():
    u = np.random.default_rng(0).standard_normal((2, 1000)).astype(
        np.float32)
    for w in (1, 2, 8):
        got = kref.lane_sum(u, w)
        slow = kref.lane_sum(u, w, lambda a: a + np.float32(0))
        assert np.array_equal(got, slow)
        np.testing.assert_allclose(got, u.sum(axis=1), rtol=1e-5, atol=1e-5)
