"""The hand-written CUDA sweep kernel against its plain torch version, on the
card.  Marked ``cuda``; each test skips when ``torch.cuda.is_available()``
is false.  Run on a machine with an NVIDIA Hopper GPU and nvcc:

    python -m pytest tests/test_torch_cuda.py -m cuda

Tolerance: atol 1e-5 on x and e and equal accept counts (the kernel and the
plain version use the same CUDA math functions, and agree bit for bit on
the H100).
"""

import functools

import numpy as np
import pytest
import torch

import montecarlo_tpu_torch as tmc
from montecarlo_tpu_torch.models import particle1d as p1d
from montecarlo_tpu_torch.ops.fused_sweep import (SWEEP_KERNEL,
                                                  fused_gaussian_sweep)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _inputs(m, device):
    rng = np.random.default_rng(m)
    x = torch.as_tensor(rng.uniform(-2, 2, m).astype(np.float32),
                        device=device)
    beta = torch.as_tensor(rng.uniform(0.5, 3, m).astype(np.float32),
                           device=device)
    return x, beta


@pytest.mark.parametrize("block_rows", [2048, 8])
@pytest.mark.parametrize("pot", [
    p1d.harmonic, functools.partial(p1d.double_well, a=1.5, h=0.7)])
def test_kernel_matches_plain(cuda, pot, block_rows):
    m = 10 ** 4 + 37
    x, beta = _inputs(m, cuda)
    before = SWEEP_KERNEL.launches
    xk, ek, ak = fused_gaussian_sweep(x, beta, 0.5, 9, 5, 301, potential=pot,
                                      block_rows=block_rows)
    assert SWEEP_KERNEL.launches == before + 1
    xp, ep, ap = fused_gaussian_sweep(x, beta, 0.5, 9, 5, 301, potential=pot,
                                      block_rows=block_rows, interpret=True)
    assert SWEEP_KERNEL.launches == before + 1
    assert xk.is_cuda and ak.dtype == torch.int32
    assert torch.equal(ak, ap)
    torch.testing.assert_close(xk, xp, rtol=0, atol=1e-5)
    torch.testing.assert_close(ek, ep, rtol=0, atol=1e-5)
    torch.testing.assert_close(ek, pot(xk), rtol=0, atol=1e-6)


def test_kernel_raises_instead_of_falling_back(cuda):
    x, beta = _inputs(1000, cuda)
    with pytest.raises(ValueError):
        fused_gaussian_sweep(x, beta, 0.5, 1, 0, 10, potential=lambda v: v * v)
    with pytest.raises(TypeError):
        fused_gaussian_sweep(x.double(), beta, 0.5, 1, 0, 10,
                             potential=p1d.harmonic)
    with pytest.raises(ValueError):
        fused_gaussian_sweep(x[::2], beta[::2], 0.5, 1, 0, 10,
                             potential=p1d.harmonic)


def test_simulation_runs_through_kernel(cuda, tmp_path):
    chains = p1d.init_chains(4096, beta=2.0, seed=1, device=cuda)
    sched = np.arange(1000, 20001, 1000)
    sim = tmc.Simulation(p1d.make_system(), chains, [
        dict(algorithm=tmc.Metropolis, pool=(p1d.displacement_move(0.5),),
             seed=3),
        dict(algorithm=tmc.StoreCallbacks,
             callbacks=(p1d.callback_energy, tmc.callback_acceptance),
             scheduler=sched),
        dict(algorithm=tmc.StoreTrajectories, fmt=tmc.BIN(), scheduler=sched),
    ], 20000, path=str(tmp_path))
    assert sim.device_algos[0].supports_fused
    before = SWEEP_KERNEL.launches
    sim.run()
    assert SWEEP_KERNEL.launches - before == len(sched)
    assert sim.device_state["sys"].x.is_cuda
    e = np.loadtxt(tmp_path / "energy.dat")
    assert abs(e[len(e) // 2:, 1].mean() - 0.25) < 0.01
