#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives ``montecarlo_tpu_torch`` through its main path on the card and holds
its hand-written CUDA kernel to the kernel's plain PyTorch version:

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit (``nvidia-smi``);
2. build: compiles ``csrc/fused_sweep.cu`` with nvcc;
3. kernel vs plain version, harmonic and double well, at M = 10^4 (one
   block) and 10^6 (four blocks), odd t0 and n_steps;
4. segmentation invariance: one launch of n steps equals three launches
   summing to n, bit for bit;
5. the main path, ``Simulation.run`` on CUDA: config 1 (the README
   example, 10 chains, per-chain DAT files) and config 2 (10^4 chains,
   energy + acceptance callbacks, chain-major BIN trajectories), with
   physics checks;
6. times of the kernel and the plain version, and config 2's end-to-end
   rate, each printed beside the card's name and power limit.

Prints its findings on lines before the last, a ``{"kernels": [...]}``
line, and as the last line ``{"ok": true, "device": {...}}``.  Any failed
check raises, so the script exits non-zero without the last line.

Usage: python3 chip_smoke.py
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

SEED = 12345
SIGMA = 0.5
BETA = 2.0
T0, N_STEPS = 7, 1001            # odd start, odd length: masked half-pairs
SIZES = (10 ** 4, 10 ** 6)       # one Pallas-sized block; four blocks
ATOL = 1e-5                      # x and e: float32 ulps of log/sin/cos
MAX_FLIP_FRACTION = 1e-4         # chains allowed an ulp-level accept flip
CONFIG2_CHAINS = 10 ** 4
CONFIG2_STRIDE = 10 ** 4
CONFIG2_STEPS = 2 * 10 ** 7


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def cuda_time(fn, reps):
    """Mean milliseconds per call of ``fn`` over ``reps`` calls, by CUDA
    events, after one warm-up call."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def inputs(m, device, rng):
    import torch
    x = torch.as_tensor(rng.uniform(-2.0, 2.0, m).astype(np.float32),
                        device=device)
    beta = torch.as_tensor(rng.uniform(0.5, 3.0, m).astype(np.float32),
                           device=device)
    sigma = torch.tensor(SIGMA, dtype=torch.float32, device=device)
    return x, beta, sigma


def kernel_vs_plain(device, potentials):
    """Phase 3.  Returns the largest |kernel - plain| over agreeing chains."""
    import torch
    from montecarlo_tpu_torch.ops.fused_sweep import fused_gaussian_sweep
    rng = np.random.default_rng(SEED)
    worst = 0.0
    for pot in potentials:
        for m in SIZES:
            x, beta, sigma = inputs(m, device, rng)
            args = (x, beta, sigma, SEED, T0, N_STEPS)
            xk, ek, ak = fused_gaussian_sweep(*args, potential=pot)
            xp, ep, ap = fused_gaussian_sweep(*args, potential=pot,
                                              interpret=True)
            dx = (xk - xp).abs()
            de = (ek - ep).abs()
            off = (ak != ap) | (dx > ATOL) | (de > ATOL)
            n_off = int(off.sum())
            keep = ~off
            err = max(float(dx[keep].max()), float(de[keep].max()))
            u_err = float((ek - pot(xk)).abs().max())
            same = int(((xk == xp) & (ek == ep) & (ak == ap)).sum())
            print(f"kernel vs plain: {pot.__name__} M={m} t0={T0} "
                  f"n={N_STEPS}: {n_off} chains with an accept flip, "
                  f"max |diff| {err!r} on the rest, {same}/{m} bit-equal, "
                  f"max |e' - U(x')| {u_err!r}, "
                  f"acceptance {float(ak.sum()) / (m * N_STEPS)!r}")
            check(n_off <= MAX_FLIP_FRACTION * m,
                  f"{n_off} of {m} chains disagree ({pot.__name__})")
            check(err <= ATOL, f"kernel vs plain differ by {err}")
            check(u_err <= 1e-6, f"e' != U(x') by {u_err}")
            worst = max(worst, err)
    return worst


def segmentation(device, potentials):
    """Phase 4: one call of n steps == three calls summing to n."""
    import torch
    from montecarlo_tpu_torch.ops.fused_sweep import fused_gaussian_sweep
    rng = np.random.default_rng(SEED + 1)
    for pot, m in zip(potentials, SIZES):
        x, beta, sigma = inputs(m, device, rng)
        x1, e1, a1 = fused_gaussian_sweep(x, beta, sigma, SEED, T0, N_STEPS,
                                          potential=pot)
        xs, acc, t = x, torch.zeros_like(a1), T0
        parts = (N_STEPS // 3, 1, N_STEPS - N_STEPS // 3 - 1)
        for n in parts:
            xs, es, a = fused_gaussian_sweep(xs, beta, sigma, SEED, t, n,
                                             potential=pot)
            acc, t = acc + a, t + n
        ok = (torch.equal(x1, xs) and torch.equal(e1, es)
              and torch.equal(a1, acc))
        print(f"segmentation: {pot.__name__} M={m}: one call of {N_STEPS} "
              f"steps vs {'+'.join(map(str, parts))}: bit-equal {ok}")
        check(ok, "segmented sweep differs from one sweep")


def config1(tmc, p1d, device, path):
    """The README example: 10 chains, per-chain DAT trajectories."""
    seed, beta, m, steps, burn = 42, 2.0, 10, 10 ** 5, 1000
    times = tmc.build_schedule(steps, burn, 10)
    sim = tmc.Simulation(
        p1d.make_system(p1d.harmonic),
        p1d.init_chains(m, beta=beta, seed=seed, device=device),
        [dict(algorithm=tmc.Metropolis,
              pool=(p1d.displacement_move(sigma=0.1),), seed=seed),
         dict(algorithm=tmc.StoreCallbacks,
              callbacks=(p1d.callback_energy, tmc.callback_acceptance),
              scheduler=times),
         dict(algorithm=tmc.StoreTrajectories, scheduler=times)],
        steps, path=path)
    t0 = time.perf_counter()
    sim.run()
    wall = time.perf_counter() - t0
    e = np.loadtxt(os.path.join(path, "energy.dat"))
    a = np.loadtxt(os.path.join(path, "acceptance.dat"))
    trj = [np.loadtxt(os.path.join(path, "trajectories", str(c + 1),
                                   "trajectory.dat")) for c in range(m)]
    tail = float(e[e[:, 0] >= burn, 1].mean())
    acc = float(a[-1, 1])
    print(f"config 1: {m} chains x {steps} steps in {wall!r} s, energy tail "
          f"mean {tail!r}, acceptance {acc!r}, "
          f"{len(trj)} trajectory files of {len(trj[0])} lines")
    check(sim.device_state["sys"].x.device.type == device.type,
          "config 1 state left the device")
    check(abs(tail - 1 / (2 * beta)) < 0.02, f"config 1 energy {tail}")
    check(0.05 < acc < 0.99, f"config 1 acceptance {acc}")
    check(all(t.shape == (len(times) + 1, 2) for t in trj),
          "config 1 trajectory files")
    check(os.path.exists(os.path.join(path, "summary.log")),
          "config 1 summary.log")


def config2(tmc, p1d, device, path, m, steps, stride):
    """BASELINE config 2: energy + acceptance, BIN trajectories."""
    sched = np.arange(stride, steps + 1, stride)
    sim = tmc.Simulation(
        p1d.make_system(p1d.harmonic),
        p1d.init_chains(m, beta=2.0, seed=42, device=device),
        [dict(algorithm=tmc.Metropolis,
              pool=(p1d.displacement_move(sigma=SIGMA),), seed=42),
         dict(algorithm=tmc.StoreCallbacks,
              callbacks=(p1d.callback_energy, tmc.callback_acceptance),
              scheduler=sched),
         dict(algorithm=tmc.StoreTrajectories, fmt=tmc.BIN(),
              scheduler=sched)],
        steps, path=path)
    t0 = time.perf_counter()
    sim.run()
    wall = time.perf_counter() - t0
    ts, fields = tmc.load_chain_major_trajectories(path)
    frame = fields["frame"]
    tail = np.asarray(frame[len(ts) // 2:])
    e = np.loadtxt(os.path.join(path, "energy.dat"))
    a = np.loadtxt(os.path.join(path, "acceptance.dat"))
    e_tail = float(e[len(e) // 2:, 1].mean())
    acc = float(a[-1, 1])
    on_card = sim.device_state["sys"].x.device.type
    print(f"config 2: {m} chains x {steps} steps, stride {stride}: "
          f"{wall!r} s, state on {on_card}, energy tail mean {e_tail!r}, "
          f"BIN frame {frame.shape} tail mean {float(tail.mean())!r} std "
          f"{float(tail.std())!r}, acceptance {acc!r}")
    check(on_card == device.type, "config 2 state left the device")
    check(abs(e_tail - 0.25) < 0.01, f"config 2 energy {e_tail}")
    check(frame.shape == (len(sched) + 1, m), f"BIN shape {frame.shape}")
    check(abs(float(tail.mean())) < 0.02, "config 2 BIN mean")
    check(abs(float(tail.std()) - 0.5) < 0.02, "config 2 BIN std")
    check(0.05 < acc < 0.99, f"config 2 acceptance {acc}")
    check(os.path.exists(os.path.join(path, "summary.log")),
          "config 2 summary.log")
    return wall


def sweep_times(device, card):
    """Phase 6: kernel and plain-version ms per call and steps/s."""
    from montecarlo_tpu_torch.models import particle1d as p1d
    from montecarlo_tpu_torch.ops.fused_sweep import fused_gaussian_sweep
    rng = np.random.default_rng(SEED + 2)
    out = {}
    for m in SIZES:
        x, beta, sigma = inputs(m, device, rng)
        for label, interp, n, reps in (("kernel", False, CONFIG2_STRIDE, 5),
                                       ("plain", True, N_STEPS, 1)):
            ms = cuda_time(lambda: fused_gaussian_sweep(
                x, beta, sigma, SEED, 0, n, potential=p1d.harmonic,
                interpret=interp), reps)
            rate = m * n / (ms / 1e3)
            print(f"time: {label} sweep M={m} n_steps={n}: {ms!r} ms per "
                  f"call, {rate!r} steps/s [{card}]")
            out[(label, m)] = (ms, n, rate)
    # the plain version at the main path's own segment, for the JSON line
    m = CONFIG2_CHAINS
    x, beta, sigma = inputs(m, device, rng)
    ms = cuda_time(lambda: fused_gaussian_sweep(
        x, beta, sigma, SEED, 0, CONFIG2_STRIDE, potential=p1d.harmonic,
        interpret=True), 1)
    rate = m * CONFIG2_STRIDE / (ms / 1e3)
    print(f"time: plain sweep M={m} n_steps={CONFIG2_STRIDE}: {ms!r} ms per "
          f"call, {rate!r} steps/s [{card}]")
    out[("plain_main", m)] = (ms, CONFIG2_STRIDE, rate)
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import montecarlo_tpu_torch as tmc
    from montecarlo_tpu_torch.models import particle1d as p1d
    from montecarlo_tpu_torch.ops.fused_sweep import SWEEP_KERNEL

    # 1. device
    device = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)")

    # 2. build
    t0 = time.perf_counter()
    SWEEP_KERNEL.build()
    print(f"build: {SWEEP_KERNEL.library_path()} ready in "
          f"{time.perf_counter() - t0!r} s (nvcc {SWEEP_KERNEL.build_seconds!r} s)")

    # 3-4. the kernel against its plain version
    potentials = (p1d.harmonic, p1d.double_well)
    max_err = kernel_vs_plain(device, potentials)
    segmentation(device, potentials)

    # 5. the main path; only its launches count
    with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=ROOT) as tmp:
        SWEEP_KERNEL.launches = 0
        config1(tmc, p1d, device, os.path.join(tmp, "config1"))
        n1 = SWEEP_KERNEL.launches
        wall2 = config2(tmc, p1d, device, os.path.join(tmp, "config2"),
                        CONFIG2_CHAINS, CONFIG2_STEPS, CONFIG2_STRIDE)
        launches = SWEEP_KERNEL.launches
    print(f"main path: {launches} kernel launches ({n1} in config 1, "
          f"{launches - n1} in config 2)")
    check(n1 > 0 and launches > n1, "the main path did not launch the kernel")
    rate2 = CONFIG2_CHAINS * CONFIG2_STEPS / wall2
    print(f"time: config 2 end to end with recorders: {rate2!r} steps/s "
          f"({CONFIG2_CHAINS} chains, stride {CONFIG2_STRIDE}) [{card}]")

    # 6. times
    times = sweep_times(device, card)
    ms, _, _ = times[("kernel", CONFIG2_CHAINS)]
    plain_ms, _, _ = times[("plain_main", CONFIG2_CHAINS)]
    n2 = launches - n1
    print(f"time: config 2 breakdown: {n2} kernel launches x {ms!r} ms = "
          f"{n2 * ms / 1e3!r} s of {wall2!r} s wall "
          f"({100 * n2 * ms / 1e3 / wall2!r} % in the kernel) [{card}]")
    print(json.dumps({"kernels": [{
        "name": "fused_gaussian_sweep",
        "route": "cuda",
        "source": "montecarlo_tpu_torch/csrc/fused_sweep.cu",
        "replaces": "montecarlo_tpu/ops/fused_sweep.py:104",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
