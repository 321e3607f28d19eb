"""The ported examples (``examples/torch/``): each script's ``main`` on the
CPU at a tiny size, checked on what it prints and writes; and the scripts
import neither ``jax`` nor the JAX package, nor run anything when
imported."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_lattice_helpers import _one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples", "torch")
NAMES = sorted(f[:-3] for f in os.listdir(os.path.join(ROOT, "examples"))
               if f.endswith(".py"))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_reference_example_is_ported_and_imports_cleanly():
    assert len(NAMES) == 12
    assert sorted(f[:-3] for f in os.listdir(EXAMPLES)
                  if f.endswith(".py")) == NAMES
    code = (
        "import importlib.util, os, sys\n"
        f"d = {EXAMPLES!r}\n"
        "for f in sorted(os.listdir(d)):\n"
        "    spec = importlib.util.spec_from_file_location(f[:-3], "
        "os.path.join(d, f))\n"
        "    mod = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(mod)\n"
        "    assert callable(mod.main), f\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'montecarlo_tpu')]\n"
        "assert not bad, bad\n"
        "assert not os.path.exists('data'), 'an import ran a script'\n")
    proc = subprocess.run([sys.executable, "-c", code],
                          cwd=os.path.join(EXAMPLES), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_cell_mc_large_n(tmp_path, capsys):
    out = _load("cell_mc_large_n").main(
        n_particles=2048, n_chains=2, steps=2, device="cpu",
        path=str(tmp_path))
    assert out["use_cell"]                 # 'auto' on the CPU from N 2048
    assert 0.05 < out["acceptance"] < 0.95
    assert out["rel_err"] < 3e-4
    assert "cell path selected = True" in capsys.readouterr().out


def test_cluster_critical_ising(tmp_path, capsys):
    out = _load("cluster_critical_ising").main(
        size=8, n_chains=4, steps=60, burn=10, device="cpu",
        root=str(tmp_path))
    assert out["tau_cb"] > 0 and out["tau_sw"] > 0
    assert np.all(np.isfinite(out["u4"])) and np.all(out["u4"] < 2 / 3 + 1e-9)
    text = capsys.readouterr().out
    assert "Swendsen-Wang" in text and "WHAM Binder scan" in text


def test_ecmc_hard_disks(tmp_path, capsys):
    out = _load("ecmc_hard_disks").main(
        n_disks=16, n_chains=8, steps=6, etas=(0.05,), device="cpu",
        root=str(tmp_path))
    p, vir = out[0.05]
    assert abs(p - vir) < 0.3            # 8 chains, 6 steps
    assert "bP/rho ECMC" in capsys.readouterr().out


def test_ecmc_lj(tmp_path, capsys):
    out = _load("ecmc_lj").main(n=16, n_chains=4, steps=10, device="cpu",
                                root=str(tmp_path))
    assert all(np.isfinite(v) for v in out.values())
    assert "MKK lifting events" in capsys.readouterr().out


def test_ising2d_checkerboard(tmp_path, capsys):
    out = _load("ising2d_checkerboard").main(
        size=8, n_chains=8, steps=200, burn=50, betas=(0.3, 0.55),
        device="cpu", root=str(tmp_path))
    (e_hot, m_hot), (e_cold, m_cold) = out[0.3], out[0.55]
    assert e_cold < e_hot < 0 and m_cold > m_hot
    assert "e/spin" in capsys.readouterr().out


def test_lj_2d(tmp_path, capsys):
    out = _load("lj_2d").main(n_chains=4, n_particles=32, steps=20,
                              device="cpu", root=str(tmp_path))
    assert 0.05 < out["acceptance"] < 0.98
    assert os.path.exists(os.path.join(out["path"], "parameters", "1",
                                       "parameters.dat"))
    assert "energy/particle" in capsys.readouterr().out


def test_mc_harmonic_oscillator(tmp_path, capsys):
    out = _load("mc_harmonic_oscillator").main(
        n_chains=10, steps=2000, burn=100, device="cpu", root=str(tmp_path))
    assert abs(out["energy"] - 0.25) < 0.15
    assert os.path.isdir(os.path.join(out["path"], "checkpoints"))
    assert "position mean" in capsys.readouterr().out


def test_parallel_tempering(tmp_path, capsys):
    out = _load("parallel_tempering").main(n_ladders=8, steps=2000,
                                           device="cpu", root=str(tmp_path))
    hops_off, hops_on = out[False][0], out[True][0]
    assert hops_on > hops_off
    assert "with exchange" in capsys.readouterr().out


def test_pgmc_harmonic_oscillator(tmp_path, capsys):
    out = _load("pgmc_harmonic_oscillator").main(
        n_chains=10, steps=1000, burn=100, device="cpu", root=str(tmp_path))
    sig0, sig1 = out["sigma"]
    assert sig0 == pytest.approx(0.1, abs=0.01) and sig1 > sig0
    assert "adapted sigma" in capsys.readouterr().out


def test_swap_mc_glass(tmp_path, capsys):
    out = _load("swap_mc_glass").main(n=16, n_chains=4, steps=20,
                                      device="cpu", root=str(tmp_path))
    for e in out.values():
        assert e[-1, 1] < e[0, 1]
    assert "swap equilibrates" in capsys.readouterr().out


def test_tfim_quantum(tmp_path, capsys):
    out = _load("tfim_quantum").main(
        n_sites=4, m_slices=16, n_chains=16, steps=40, sweeps=5,
        fields=(1.0,), device="cpu", root=str(tmp_path))
    qmc, ex = out[1.0]
    assert abs(qmc["szsz"] - ex["szsz"]) < 0.15
    assert "<sx> QMC" in capsys.readouterr().out


def _reference_wang_landau(size, steps, n_chains, refine_every, path):
    """The JAX package's run of the example's configuration: the walkers'
    ``log f`` and their mean ``log g``."""
    import montecarlo_tpu as mc
    from montecarlo_tpu.core.wanglandau import mean_log_g
    from montecarlo_tpu.models import ising2d
    chains = ising2d.init_chains(n_chains, size=size, beta=1.0, seed=1)
    sim = mc.Simulation(ising2d.make_system(), chains, [
        dict(algorithm=mc.WangLandau, model=ising2d.wl_model(size),
             moves_per_step=size * size, seed=1),
        dict(algorithm=mc.WangLandauRefine, flatness=0.8, log_f_min=1e-4,
             dependencies=(mc.WangLandau,),
             scheduler=np.arange(refine_every, steps + 1, refine_every))],
        steps, path=path)
    sim.run()
    slc = sim.device_state["wang_landau"]
    log_g, _ = mean_log_g(slc, anchor_bin=0, anchor_log_g=np.log(2.0))
    return np.asarray(slc["log_f"]), log_g


def test_wang_landau_ising(tmp_path, capsys):
    """The example at L 3, 4 walkers, 1,200 steps: its walkers equal the
    JAX package's run of the same configuration (one seed gives the
    reference's stream), and the density of states has converged (at 600
    steps the reference's own walkers still have log f 0.0625 and miss
    the exact log g by 1.65 at this seed)."""
    out = _load("wang_landau_ising").main(
        size=3, steps=1200, n_chains=4, refine_every=100, device="cpu",
        path=str(tmp_path))
    assert out["log_f"].max() < 1.0 and out["max_err"] < 1.0
    assert (tmp_path / "wl_log_f.dat").exists()
    assert "max |log g - exact|" in capsys.readouterr().out
    log_f, log_g = _reference_wang_landau(3, 1200, 4, 100,
                                          str(tmp_path / "reference"))
    np.testing.assert_array_equal(out["log_f"], log_f)
    np.testing.assert_allclose(out["log_g"], log_g, rtol=1e-6, atol=1e-6)


def test_examples_default_to_the_card(tmp_path):
    """Without ``device=`` a script's chains go to ``cuda``; where there is
    no card the script raises, and never runs on the CPU."""
    run = lambda: _load("tfim_quantum").main(
        n_sites=4, m_slices=16, n_chains=2, steps=1, sweeps=1,
        fields=(1.0,), root=str(tmp_path))
    if torch.cuda.is_available():
        run()
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            run()
