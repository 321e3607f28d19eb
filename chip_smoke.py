#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives ``montecarlo_tpu_torch`` through its main paths on the card and
holds each hand-written CUDA kernel to its plain PyTorch version:

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit (``nvidia-smi``);
2. build: compiles ``csrc/fused_sweep.cu``, ``csrc/lj_sweep.cu`` and
   ``csrc/poly_sweep.cu`` with one nvcc each, started together;
3. the Gaussian sweep kernel vs its plain version, harmonic and double
   well, at M = 10^4 (one block) and 10^6 (four blocks), odd t0 and
   n_steps; segmentation invariance (one launch of n steps equals three
   launches summing to n, bit for bit);
4. both LJ kernels vs their plain versions at config 4's shape (256 chains
   x N 256), the config-5 pool's (64 x N 1024), a gridded case (M 300 over
   blocks of 256, M 20 over blocks of 8) and mono-species chains; after
   each run the kernel's cached energies against an O(N^2) recompute,
   positions in [0, box) and the species composition; segmentation
   invariance of both;
4b. the polydisperse swap kernel vs its plain version at the main path's
   shape (64 chains x N 256, w_disp 0.8), 64 x N 1024, a gridded case (M 300
   over blocks of 256, M 20 over blocks of 8) and N 2: bit for bit, with the
   cache against an O(N^2) recompute, positions in [0, box) and each
   chain's diameters conserved; segmentation invariance;
5. the main paths, ``Simulation.run`` on CUDA, each with every launch count
   set to 0 just before and read just after: config 1 (the README example,
   10 chains, per-chain DAT files), config 2 (10^4 chains, energy +
   acceptance callbacks, chain-major BIN trajectories), config 4 (2-D LJ,
   256 chains x N 256, displacement, energy per particle + acceptance) and
   the config-5 pool of ``examples/lj_2d.py`` without PGMC (64 chains x
   N 1024, displacement + swap, callbacks and ``StoreLastFrames``) and the
   polydisperse swap-MC path (``tools/bench_lj.py``'s poly configuration:
   64 chains x N 256, rho 0.9, beta 2, displacement + diameter swap, 100
   sweeps, with ``examples/swap_mc_glass.py``'s recorders), with physics
   and cache checks;
5d. config 5 with PGMC (``tools/bench_lj.py``'s adaptive benchmark): the
   config-5 pool at 64 chains x N 1024, 200 sweeps, VPG on the displacement
   sigma (q 2, estimator every 10 sweeps, update every 20) through the
   hybrid stepper, with energy, acceptance and parameters every 10 sweeps;
   one launch per segment between sync points, sigma adapted and on the
   card, counters, cache and acceptance checked; then the same run without
   PGMC, for the adaptive tax, and once more under ``torch.profiler`` for
   the card's busy time and idle share;
5e. config 3's adaptation on the Gaussian kernel: 10^4 chains of the
   harmonic particle-1d at beta 2, sigma 0.2 raised by VPG through the
   hybrid stepper; sigma climbs, the energy keeps equipartition;
5f. config 5 cut at sweep 100 after a ``StoreBackups`` checkpoint and
   resumed from it in a fresh ``Simulation``: bit-equal to 5d's run in
   positions, species, energies, counters, sigma and the estimator's sums;
6. times of each kernel and its plain version at its main path's shape,
   and the end-to-end rates of config 2 and the poly path, and where config
   5's wall goes with PGMC, each printed beside the card's name and power
   limit.

Prints its findings on lines before the last, a ``{"kernels": [...]}``
line (``ms`` per launch at the main path's segment of ``steps`` steps,
``plain_ms`` per call of ``plain_steps`` steps), and as the last line
``{"ok": true, "device": {...}}``.  Any failed
check raises, so the script exits non-zero without the last line.

Usage: python3 chip_smoke.py
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

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
LJ_SIGMA, LJ_T0, LJ_STEPS = 0.1, 7, 301      # odd start, a few hundred steps
LJ_ATOL = 1e-5                   # pos and energy of chains without a flip
LJ_CACHE = dict(rtol=3e-4, atol=5e-2)   # the reference's own cache bounds
CONFIG4 = dict(chains=256, n=256, sweeps=200, stride=10)
POOL5 = dict(chains=64, n=1024, sweeps=50, w_disp=0.8)
LJ_TIME_STEPS = 256              # steps per timed call, kernel and plain
POLY = dict(chains=64, n=256, rho=0.9, beta=2.0, sigma=0.1, w_disp=0.8,
            sweeps=100, stride=10)
POLY_T0, POLY_STEPS = 7, 301
POLY_CACHE = dict(rtol=3e-3, atol=8e-2)  # the reference's own poly bounds
# config 5 with PGMC (tools/bench_lj.py:83-109), resumed at sweep `resume`
PGMC5 = dict(chains=64, n=1024, sweeps=200, w_disp=0.8, eta=0.001, q=2,
             est_every=10, upd_every=20, stride=10, resume=100)
# config 3's adaptation on the Gaussian kernel: sigma 0.2 climbs toward ~1.2
PGMC3 = dict(chains=10 ** 4, beta=2.0, sigma0=0.2, eta=0.05, steps=4000,
             est_every=10, upd_every=20, stride=100)


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


def lj_inputs(m, n, device, seed, frac_b=0.2):
    import torch
    from montecarlo_tpu_torch.models import lennard_jones as lj
    st = lj.init_chains(m, n, rho=0.7, beta=1.0, frac_b=frac_b, seed=seed,
                        device=device)
    rng = np.random.default_rng(seed)
    beta = torch.as_tensor(rng.uniform(0.8, 1.5, m).astype(np.float32),
                           device=device)
    return dataclasses.replace(st, beta=beta)


def lj_call(st, n_steps, mixed, t0=LJ_T0, interpret=False, block_chains=256,
            w_disp=POOL5["w_disp"]):
    """One LJ sweep call; returns (pos, species, energy, acc, tot) for both
    kernels (species, tot are the inputs' and None for the displacement
    kernel)."""
    from montecarlo_tpu_torch.models import lennard_jones as lj
    from montecarlo_tpu_torch.ops.lj_sweep import (fused_lj_mixed_sweep,
                                                   fused_lj_sweep)
    box = float(st.box[0])
    args = (st.pos, st.species, st.beta, st.energy, box, LJ_SIGMA)
    kw = dict(params=lj.LJParams(), interpret=interpret,
              block_chains=block_chains)
    if mixed:
        return fused_lj_mixed_sweep(*args, w_disp, SEED, t0, n_steps, **kw)
    pos, e, acc = fused_lj_sweep(*args, SEED, t0, n_steps, **kw)
    return pos, st.species, e, acc, None


def lj_cache_check(st, out, what):
    """The kernel's cached energies against an O(N^2) recompute, positions
    in [0, box), species composition conserved."""
    import torch
    from montecarlo_tpu_torch.models import lennard_jones as lj
    pos, spc, e = out[:3]
    new = dataclasses.replace(st, pos=pos, species=spc, energy=e)
    full = lj.make_system().refresh(new).energy
    err = float(((e - full).abs()
                 - LJ_CACHE["rtol"] * full.abs()).max())
    box = float(st.box[0])
    check(torch.isfinite(e).all() and err <= LJ_CACHE["atol"],
          f"{what}: cached energy off the O(N^2) energy ({err})")
    check(float(pos.min()) >= 0.0 and float(pos.max()) < box,
          f"{what}: positions left [0, box)")
    check(torch.equal(spc.sum(1), st.species.sum(1)),
          f"{what}: species composition changed")
    return float((e - full).abs().max())


LJ_CASES = (  # (label, M, N, block_chains, frac_b)
    ("config 4 shape", CONFIG4["chains"], CONFIG4["n"], 256, 0.2),
    ("config-5 pool shape", POOL5["chains"], POOL5["n"], 256, 0.2),
    ("gridded, blocks of 256", 300, 128, 256, 0.2),
    ("gridded, blocks of 8", 20, 128, 8, 0.2),
    ("mono-species", 32, 128, 256, 0.0),
)


def lj_kernels_vs_plain(device):
    """Phase 4a.  Returns the largest |kernel - plain| per kernel over
    chains without an accept flip."""
    import torch
    worst = {False: 0.0, True: 0.0}
    for k, (label, m, n, bc, frac_b) in enumerate(LJ_CASES):
        st = lj_inputs(m, n, device, SEED + 10 + k, frac_b)
        for mixed in (False, True):
            name = "mixed" if mixed else "displacement"
            ker = lj_call(st, LJ_STEPS, mixed, block_chains=bc)
            pln = lj_call(st, LJ_STEPS, mixed, block_chains=bc,
                          interpret=True)
            pk, sk, ek, ak, tk = ker
            pp, sp, ep, ap, tp = pln
            acc_k = ak.reshape(m, -1)
            acc_p = ap.reshape(m, -1)
            flip = ((acc_k != acc_p).any(1) | (sk != sp).any(1))
            dpos = (pk - pp).abs().amax(dim=(1, 2))
            de = (ek - ep).abs()
            keep = ~flip
            err = max(float(dpos[keep].max()), float(de[keep].max())) \
                if bool(keep.any()) else 0.0
            same = (pk == pp).all(2).all(1) & (ek == ep) & ~flip
            tot_equal = tk is None or torch.equal(tk, tp)
            cache = lj_cache_check(st, ker, f"{name} kernel, {label}")
            rates = (acc_k.sum(0).double()
                     / (tk.sum(0).double() if tk is not None
                        else m * LJ_STEPS)).tolist()
            print(f"LJ kernel vs plain: {name}, {label} (M={m}, N={n}, "
                  f"block_chains={bc}, t0={LJ_T0}, n={LJ_STEPS}): "
                  f"{int(same.sum())}/{m} chains bit-equal, "
                  f"{int(flip.sum())} with an accept flip, max |diff| "
                  f"{err!r} on the rest, attempts equal {tot_equal}, "
                  f"max |E - E(N^2)| {cache!r}, acceptance {rates}")
            check(tot_equal, f"{name} {label}: attempt counts differ")
            check(int(flip.sum()) <= MAX_FLIP_FRACTION * m,
                  f"{name} {label}: {int(flip.sum())} of {m} chains flip")
            check(err <= LJ_ATOL, f"{name} {label}: kernel vs plain {err}")
            if frac_b == 0.0 and mixed:
                check(int(acc_k[:, 1].sum()) == 0
                      and int(tk[:, 1].sum()) > 0
                      and torch.equal(sk, st.species),
                      "mono-species chains accepted a swap")
            worst[mixed] = max(worst[mixed], err)
    return worst


def lj_segmentation(device):
    """Phase 4a: one call of n steps == three calls summing to n, both LJ
    kernels, bit for bit."""
    import torch
    for mixed, (m, n) in ((False, (CONFIG4["chains"], CONFIG4["n"])),
                          (True, (POOL5["chains"], POOL5["n"]))):
        st = lj_inputs(m, n, device, SEED + 20)
        one = lj_call(st, LJ_STEPS, mixed)
        parts = (LJ_STEPS // 3, 1, LJ_STEPS - LJ_STEPS // 3 - 1)
        cur, t, acc = st, LJ_T0, torch.zeros_like(one[3])
        for k in parts:
            pos, spc, e, a, _ = lj_call(cur, k, mixed, t0=t)
            cur = dataclasses.replace(cur, pos=pos, species=spc, energy=e)
            acc, t = acc + a, t + k
        ok = (torch.equal(cur.pos, one[0]) and torch.equal(cur.species,
                                                           one[1])
              and torch.equal(cur.energy, one[2]) and torch.equal(acc,
                                                                  one[3]))
        print(f"LJ segmentation: {'mixed' if mixed else 'displacement'} "
              f"M={m} N={n}: one call of {LJ_STEPS} steps vs "
              f"{'+'.join(map(str, parts))}: bit-equal {ok}")
        check(ok, "segmented LJ sweep differs from one sweep")


def lj_main(tmc, device, path, cfg, mixed):
    """Config 4 (one displacement move) or the config-5 pool (displacement
    + swap, with StoreLastFrames) through ``Simulation.run`` on CUDA.
    Returns (simulation, wall seconds)."""
    from montecarlo_tpu_torch.models import lennard_jones as lj
    m, n, sweeps = cfg["chains"], cfg["n"], cfg["sweeps"]
    if mixed:
        pool = (lj.lj_displacement_move(sigma=LJ_SIGMA,
                                        weight=cfg["w_disp"]),
                lj.lj_swap_move(weight=1.0 - cfg["w_disp"]))
        sched = tmc.build_schedule(sweeps, sweeps // 10, [0, 10])
    else:
        pool = (lj.lj_displacement_move(sigma=LJ_SIGMA),)
        sched = np.arange(cfg["stride"], sweeps + 1, cfg["stride"])
    algos = [
        dict(algorithm=tmc.Metropolis, pool=pool, seed=42, sweepstep=n),
        dict(algorithm=tmc.StoreCallbacks,
             callbacks=(lj.callback_energy_per_particle,
                        tmc.callback_acceptance), scheduler=sched)]
    if mixed:
        algos.append(dict(algorithm=tmc.StoreLastFrames,
                          scheduler=np.asarray([sweeps])))
    sim = tmc.Simulation(
        lj.make_system(),
        lj.init_chains(m, n, 0.7, 1.0, frac_b=0.2, seed=42, device=device),
        algos, sweeps, path=path)
    check(sim.device_algos[0].supports_fused,
          "the LJ pool is not fused on CUDA")
    t0 = time.perf_counter()
    sim.run()
    return sim, time.perf_counter() - t0


def lj_main_checks(sim, device, path, cfg, mixed, wall):
    """Checks of one LJ main-path run, made after its launch counts were
    read: state on the card, acceptance per move, recorder files, and the
    kernel's energy cache one more segment on from the final state."""
    label = "config-5 pool" if mixed else "config 4"
    m, n, sweeps = cfg["chains"], cfg["n"], cfg["sweeps"]
    st = sim.device_state["sys"]
    cnt = sim.device_state["metropolis"]["counters"].sum(0).double()
    rates = (cnt[:, 0] / cnt[:, 1]).tolist()
    e = np.loadtxt(os.path.join(path, "energy_per_particle.dat"))
    a = np.loadtxt(os.path.join(path, "acceptance.dat"))
    moves = m * n * sweeps
    print(f"{label}: {m} chains x N {n} x {sweeps} sweeps ({moves} moves) "
          f"in {wall!r} s wall ({moves / wall!r} moves/s with recorders), "
          f"state on {st.pos.device.type}, acceptance per move {rates}, "
          f"energy per particle {float(e[0, 1])!r} -> {float(e[-1, 1])!r}, "
          f"acceptance.dat last {float(a[-1, 1])!r}")
    check(st.pos.device.type == device.type, f"{label} state left the card")
    check(all(0.05 < r < 0.98 for r in rates), f"{label} acceptance {rates}")
    check(np.all(np.isfinite(e[:, 1])) and np.all(e[:, 1] < 0),
          f"{label} energy per particle")
    check(int(cnt[:, 1].sum()) == m * n * sweeps, f"{label} attempt count")
    check(os.path.exists(os.path.join(path, "summary.log")),
          f"{label} summary.log")
    if mixed:
        frames = [os.path.join(path, "trajectories", str(c + 1),
                               "lastframe.dat") for c in range(m)]
        check(all(os.path.exists(f) for f in frames),
              f"{label} lastframe.dat missing")
        with open(frames[-1]) as f:
            lines = f.read().splitlines()
        check(len(lines) == n + 1 and lines[0].split()[:2] == [
            str(sweeps), str(n)], f"{label} lastframe.dat layout")
    out = lj_call(st, n * 10, mixed, t0=sweeps * n)
    err = lj_cache_check(st, out, f"{label} after the run")
    print(f"{label}: cache after one more segment of {n * 10} steps from "
          f"the final state: max |E - E(N^2)| {err!r}")


def lj_times(device, card):
    """Phase 6b: each LJ kernel and its plain version at its main path's
    shape, LJ_TIME_STEPS steps per call; the kernel also at the main path's
    segment length."""
    out = {}
    for mixed, cfg in ((False, CONFIG4), (True, POOL5)):
        m, n = cfg["chains"], cfg["n"]
        name = "fused_lj_mixed_sweep" if mixed else "fused_lj_sweep"
        st = lj_inputs(m, n, device, SEED + 30)
        for label, interp, steps, reps in (
                ("kernel", False, LJ_TIME_STEPS, 5),
                ("kernel", False, 10 * n, 3),
                ("plain", True, LJ_TIME_STEPS, 1)):
            ms = cuda_time(lambda: lj_call(st, steps, mixed, t0=0,
                                           interpret=interp), reps)
            rate = m * steps / (ms / 1e3)
            print(f"time: {label} {name} M={m} N={n} n_steps={steps}: "
                  f"{ms!r} ms per call, {rate!r} moves/s [{card}]")
            out.setdefault(name, {})[(label, steps)] = ms
    return out


def poly_inputs(m, n, device, seed):
    import torch
    from montecarlo_tpu_torch.models import polydisperse as poly
    st = poly.init_chains(m, n, rho=POLY["rho"], beta=POLY["beta"],
                          seed=seed, device=device)
    rng = np.random.default_rng(seed)
    beta = torch.as_tensor(rng.uniform(1.5, 2.5, m).astype(np.float32),
                           device=device)
    return dataclasses.replace(st, beta=beta)


def poly_call(st, n_steps, t0=POLY_T0, interpret=False, block_chains=256):
    """One poly sweep call: (pos, diam, energy, accepted, attempted)."""
    from montecarlo_tpu_torch.models import polydisperse as poly
    from montecarlo_tpu_torch.ops.poly_sweep import fused_poly_mixed_sweep
    return fused_poly_mixed_sweep(
        st.pos, st.diam, st.beta, st.energy, float(st.box[0]), POLY["sigma"],
        POLY["w_disp"], SEED, t0, n_steps, params=poly.PolyParams(),
        interpret=interpret, block_chains=block_chains)


def poly_cache_check(st, out, what):
    """The kernel's cached energies against an O(N^2) recompute, positions
    in [0, box), each chain's diameters those it started with."""
    import torch
    from montecarlo_tpu_torch.models import polydisperse as poly
    pos, dia, e = out[:3]
    new = dataclasses.replace(st, pos=pos, diam=dia, energy=e)
    full = poly.make_system().refresh(new).energy
    err = float(((e - full).abs() - POLY_CACHE["rtol"] * full.abs()).max())
    box = float(st.box[0])
    check(torch.isfinite(e).all() and err <= POLY_CACHE["atol"],
          f"{what}: cached energy off the O(N^2) energy ({err})")
    check(float(pos.min()) >= 0.0 and float(pos.max()) < box,
          f"{what}: positions left [0, box)")
    check(torch.equal(dia.sort(1).values, st.diam.sort(1).values),
          f"{what}: diameters not conserved")
    return float((e - full).abs().max())


POLY_CASES = (  # (label, M, N, block_chains)
    ("main path shape", POLY["chains"], POLY["n"], 256),
    ("N 1024", 64, 1024, 256),
    ("gridded, blocks of 256", 300, 128, 256),
    ("gridded, blocks of 8", 20, 128, 8),
    ("N 2", 32, 2, 256),
)


def poly_kernel_vs_plain(device):
    """Phase 4b.  Returns the largest |kernel - plain| (required 0.0)."""
    import torch
    worst = 0.0
    for k, (label, m, n, bc) in enumerate(POLY_CASES):
        st = poly_inputs(m, n, device, SEED + 40 + k)
        pk, dk, ek, ak, tk = ker = poly_call(st, POLY_STEPS, block_chains=bc)
        pp, dp, ep, ap, tp = poly_call(st, POLY_STEPS, block_chains=bc,
                                       interpret=True)
        flip = (ak != ap).any(1) | (dk != dp).any(1)
        err = max(float((pk - pp).abs().max()), float((ek - ep).abs().max()),
                  float((dk - dp).abs().max()))
        same = all(torch.equal(a, b) for a, b in
                   ((pk, pp), (dk, dp), (ek, ep), (ak, ap), (tk, tp)))
        cache = poly_cache_check(st, ker, f"poly kernel, {label}")
        rates = (ak.sum(0).double() / tk.sum(0).clamp(min=1).double()).tolist()
        print(f"poly kernel vs plain: {label} (M={m}, N={n}, "
              f"block_chains={bc}, t0={POLY_T0}, n={POLY_STEPS}): "
              f"bit-equal {same}, {int(flip.sum())} chains with an accept "
              f"flip, max |diff| {err!r}, attempts equal "
              f"{torch.equal(tk, tp)}, max |E - E(N^2)| {cache!r}, "
              f"acceptance {rates}")
        check(torch.equal(tk, tp), f"poly {label}: attempt counts differ")
        check(int(flip.sum()) == 0, f"poly {label}: {int(flip.sum())} flips")
        check(err == 0.0 and same, f"poly {label}: kernel vs plain {err}")
        check(int(ak[:, 1].sum()) > 0, f"poly {label}: no swap accepted")
        worst = max(worst, err)
    return worst


def poly_segmentation(device):
    """Phase 4b: one call of n steps == three calls summing to n."""
    import torch
    st = poly_inputs(POLY["chains"], POLY["n"], device, SEED + 50)
    one = poly_call(st, POLY_STEPS)
    parts = (POLY_STEPS // 3, 1, POLY_STEPS - POLY_STEPS // 3 - 1)
    cur, t = st, POLY_T0
    acc, tot = torch.zeros_like(one[3]), torch.zeros_like(one[4])
    for k in parts:
        pos, dia, e, a, n = poly_call(cur, k, t0=t)
        cur = dataclasses.replace(cur, pos=pos, diam=dia, energy=e)
        acc, tot, t = acc + a, tot + n, t + k
    ok = all(torch.equal(a, b) for a, b in (
        (cur.pos, one[0]), (cur.diam, one[1]), (cur.energy, one[2]),
        (acc, one[3]), (tot, one[4])))
    print(f"poly segmentation: M={POLY['chains']} N={POLY['n']}: one call of "
          f"{POLY_STEPS} steps vs {'+'.join(map(str, parts))}: bit-equal {ok}")
    check(ok, "segmented poly sweep differs from one sweep")


def poly_main(tmc, device, path):
    """The poly swap-MC path through ``Simulation.run`` on CUDA.  Returns
    (simulation, initial chains, wall seconds)."""
    from montecarlo_tpu_torch.models import polydisperse as poly
    m, n, sweeps = POLY["chains"], POLY["n"], POLY["sweeps"]
    params = poly.PolyParams()
    chains = poly.init_chains(m, n, rho=POLY["rho"], beta=POLY["beta"],
                              seed=42, params=params, device=device)
    pool = (poly.displacement_move(POLY["sigma"], weight=POLY["w_disp"],
                                   params=params),
            poly.swap_move(weight=1.0 - POLY["w_disp"], params=params))
    sim = tmc.Simulation(poly.make_system(params), chains, [
        dict(algorithm=tmc.Metropolis, pool=pool, seed=42, sweepstep=n),
        dict(algorithm=tmc.StoreCallbacks,
             callbacks=(poly.callback_energy_per_particle,
                        tmc.callback_acceptance),
             scheduler=tmc.build_schedule(sweeps, 0, POLY["stride"])),
        dict(algorithm=tmc.StoreLastFrames, scheduler=np.asarray([sweeps])),
    ], sweeps, path=path)
    check(sim.device_algos[0].supports_fused,
          "the poly pool is not fused on CUDA")
    t0 = time.perf_counter()
    sim.run()
    return sim, chains, time.perf_counter() - t0


def poly_main_checks(sim, chains, device, path, wall):
    """Checks of the poly main-path run, made after its launch counts were
    read: state on the card, cache, diameters conserved and migrated,
    acceptance per move, recorder files, and the cache one more segment on."""
    import torch
    m, n, sweeps = POLY["chains"], POLY["n"], POLY["sweeps"]
    st = sim.device_state["sys"]
    cnt = sim.device_state["metropolis"]["counters"].sum(0).double()
    rates = (cnt[:, 0] / cnt[:, 1]).tolist()
    e = np.loadtxt(os.path.join(path, "energy_per_particle.dat"))
    a = np.loadtxt(os.path.join(path, "acceptance.dat"))
    moves = m * n * sweeps
    migrated = int((st.diam != chains.diam).any(1).sum())
    print(f"poly path: {m} chains x N {n} x {sweeps} sweeps ({moves} moves) "
          f"in {wall!r} s wall ({moves / wall!r} moves/s with recorders), "
          f"state on {st.pos.device.type}, acceptance per move {rates}, "
          f"energy per particle {float(e[0, 1])!r} -> {float(e[-1, 1])!r}, "
          f"acceptance.dat last {float(a[-1, 1])!r}, {migrated}/{m} chains "
          f"with swapped diameters")
    check(st.pos.device.type == device.type, "poly state left the card")
    check(all(0.01 < r < 0.98 for r in rates), f"poly acceptance {rates}")
    check(int(cnt[:, 1].sum()) == moves, "poly attempt count")
    check(np.all(np.isfinite(e[:, 1])) and len(e) == sweeps // POLY["stride"]
          + 1, "poly energy_per_particle.dat")
    check(torch.equal(st.diam.sort(1).values, chains.diam.sort(1).values),
          "poly diameters not conserved")
    check(migrated == m, f"poly diameters migrated in {migrated}/{m} chains")
    check(os.path.exists(os.path.join(path, "summary.log")),
          "poly summary.log")
    frames = [os.path.join(path, "trajectories", str(c + 1), "lastframe.dat")
              for c in range(m)]
    check(all(os.path.exists(f) for f in frames), "poly lastframe.dat missing")
    for f in frames:
        with open(f) as fh:
            lines = fh.read().splitlines()
        check(len(lines) == n + 1 and lines[0].split()[:2] == [
            str(sweeps), str(n)], "poly lastframe.dat layout")
    err = poly_cache_check(chains, (st.pos, st.diam, st.energy),
                           "poly after the run")
    out = poly_call(st, n * POLY["stride"], t0=sweeps * n)
    err2 = poly_cache_check(chains, out, "poly one segment after the run")
    print(f"poly path: cache after the run: max |E - E(N^2)| {err!r}; after "
          f"one more segment of {n * POLY['stride']} steps: {err2!r}")


def poly_times(device, card):
    """Phase 6c: the poly kernel per main-path segment and per
    LJ_TIME_STEPS steps, the plain version per LJ_TIME_STEPS steps."""
    m, n = POLY["chains"], POLY["n"]
    st = poly_inputs(m, n, device, SEED + 60)
    out = {}
    for label, interp, steps, reps in (
            ("kernel", False, LJ_TIME_STEPS, 5),
            ("kernel", False, POLY["stride"] * n, 3),
            ("plain", True, LJ_TIME_STEPS, 1)):
        ms = cuda_time(lambda: poly_call(st, steps, t0=0, interpret=interp),
                       reps)
        rate = m * steps / (ms / 1e3)
        print(f"time: {label} fused_poly_mixed_sweep M={m} N={n} "
              f"n_steps={steps}: {ms!r} ms per call, {rate!r} moves/s "
              f"[{card}]")
        out[(label, steps)] = ms
    from montecarlo_tpu_torch.models import polydisperse as poly
    refresh = poly.make_system().refresh
    out["refresh"] = cuda_time(lambda: refresh(st), 5)
    print(f"time: poly refresh (O(N^2) cache check) M={m} N={n}: "
          f"{out['refresh']!r} ms per call [{card}]")
    return out


class Interrupt(Exception):
    """Raised by :class:`StopAt` to cut a run short."""


def counted(kernels, fn):
    """Run ``fn`` with every launch count set to 0 just before; returns its
    result and the counts read just after."""
    for k in kernels:
        k.launches = 0
    out = fn()
    return out, {k.symbol: k.launches for k in kernels}


def pgmc5_sim(tmc, device, path, adaptive=True, extra=()):
    """Config 5: the LJ mixed pool at full width with PGMC adapting the
    displacement sigma through the hybrid stepper, energy per particle,
    acceptance and parameters every ``stride`` sweeps.  ``adaptive=False``
    drops the estimator and the update (the same run without PGMC)."""
    from montecarlo_tpu_torch import policy_guided as pg
    from montecarlo_tpu_torch.models import lennard_jones as lj
    cfg = PGMC5
    n, sweeps = cfg["n"], cfg["sweeps"]
    pool = (lj.lj_displacement_move(sigma=LJ_SIGMA, weight=cfg["w_disp"]),
            lj.lj_swap_move(weight=1.0 - cfg["w_disp"]))
    sched = np.arange(cfg["stride"], sweeps + 1, cfg["stride"])
    algos = [dict(algorithm=tmc.Metropolis, pool=pool, seed=42, sweepstep=n)]
    if adaptive:
        algos += [
            dict(algorithm=pg.PolicyGradientEstimator,
                 dependencies=(tmc.Metropolis,),
                 optimisers=(pg.VPG(cfg["eta"]), pg.Static()),
                 q_batch_size=cfg["q"],
                 scheduler=np.arange(cfg["est_every"], sweeps + 1,
                                     cfg["est_every"])),
            dict(algorithm=pg.PolicyGradientUpdate,
                 dependencies=(pg.PolicyGradientEstimator,),
                 scheduler=np.arange(cfg["upd_every"], sweeps + 1,
                                     cfg["upd_every"]))]
    algos += [
        dict(algorithm=tmc.StoreCallbacks,
             callbacks=(lj.callback_energy_per_particle,
                        tmc.callback_acceptance), scheduler=sched),
        dict(algorithm=tmc.StoreParameters, dependencies=(tmc.Metropolis,),
             scheduler=sched),
        *extra]
    return tmc.Simulation(
        lj.make_system(),
        lj.init_chains(cfg["chains"], n, 0.7, 1.0, frac_b=0.2, seed=42,
                       device=device),
        algos, sweeps, path=path)


def timed_run(sim):
    t0 = time.perf_counter()
    sim.run()
    return time.perf_counter() - t0


def sync_points(sim):
    """Sync points of a run in (0, steps] whose Metropolis is listed first:
    events of the other algorithms and recorder points; the hybrid stepper
    makes one fused launch for each."""
    return len({int(t) for s in sim.schedulers[1:] for t in s
                if 0 < t <= sim.steps})


def pgmc5_checks(sim, path, wall, wall_plain, card):
    """Phase 5d checks, made after the launch counts were read."""
    import torch
    from montecarlo_tpu_torch.models import lennard_jones as lj
    cfg = PGMC5
    m, n, sweeps = cfg["chains"], cfg["n"], cfg["sweeps"]
    st = sim.device_state["sys"]
    sigma = sim.device_state["params"][0]["sigma"]
    with open(os.path.join(path, "parameters", "1", "parameters.dat")) as f:
        rows = f.read().splitlines()
    last_t, last = rows[-1].split(" ", 1)
    cnt = sim.device_state["metropolis"]["counters"]
    per_chain = cnt[..., 1].sum(1)
    tot = cnt.sum(0).double()
    rates = (tot[:, 0] / tot[:, 1]).tolist()
    full = lj.make_system().refresh(st).energy
    err = float(((st.energy - full).abs() - LJ_CACHE["rtol"] * full.abs())
                .max())
    e = np.loadtxt(os.path.join(path, "energy_per_particle.dat"))
    moves = m * n * sweeps
    print(f"config 5 with PGMC: {m} chains x N {n} x {sweeps} sweeps "
          f"({moves} moves) in {wall!r} s wall ({moves / wall!r} moves/s "
          f"with recorders); without PGMC {wall_plain!r} s "
          f"({moves / wall_plain!r} moves/s), adaptive tax "
          f"{100 * (wall / wall_plain - 1)!r} % [{card}]")
    print(f"config 5 with PGMC: sigma 0.1 -> {float(sigma)!r} (parameters.dat "
          f"last row t={last_t} {last}), acceptance per move {rates}, energy "
          f"per particle {float(e[0, 1])!r} -> {float(e[-1, 1])!r}, max "
          f"|E - E(N^2)| {float((st.energy - full).abs().max())!r}")
    s = float(sigma)
    check(np.isfinite(s) and s > 0 and s != np.float32(LJ_SIGMA),
          f"config 5 sigma did not adapt ({s})")
    check(sigma.device == st.pos.device, "config 5 sigma left the card")
    check(int(last_t) == sweeps and last == f"[{s!r}]",
          f"config 5 device sigma {s!r} != parameters.dat {rows[-1]}")
    check(bool((per_chain == sweeps * n).all()),
          "config 5 attempts per chain != sweeps x N")
    check(all(0.05 < r < 0.98 for r in rates), f"config 5 acceptance {rates}")
    check(bool(torch.isfinite(st.energy).all()) and err <= LJ_CACHE["atol"],
          f"config 5 cached energy off the O(N^2) energy ({err})")
    check(np.all(np.isfinite(e[:, 1])) and len(e) == sweeps // cfg["stride"]
          + 1, "config 5 energy_per_particle.dat")


def pgmc5_breakdown(sim, n_launches, seg_ms, wall, card):
    """Config 5's parts timed apart by CUDA events on the final state: a
    kernel segment (from ``lj_times``), an estimator event, an update and
    a refresh, each times its count in the run.  An estimator event is
    host-bound: timed alone it shows its launch time, which in the run
    overlaps the segment enqueued before it, so the parts may sum to more
    than the wall."""
    from montecarlo_tpu_torch.models import lennard_jones as lj
    est, upd = sim.device_algos[1], sim.device_algos[2]
    ds, t = sim.device_state, sim.t
    n_est = int(np.count_nonzero(sim.schedulers[1]))
    n_upd = int(np.count_nonzero(sim.schedulers[2]))
    refresh = lj.make_system().refresh
    est_ms = cuda_time(lambda: est.step(ds, t), 5)
    upd_ms = cuda_time(lambda: upd.step(ds, t), 5)
    ref_ms = cuda_time(lambda: refresh(ds["sys"]), 5)
    parts = {"kernel": n_launches * seg_ms, "estimator": n_est * est_ms,
             "update": n_upd * upd_ms, "refresh": n_launches * ref_ms}
    print("time: config 5 with PGMC, parts timed apart: " + ", ".join(
        f"{k} {v!r} ms ({100 * v / (wall * 1e3)!r} % of the wall)"
        for k, v in parts.items())
        + f"; together {sum(parts.values())!r} ms of {wall * 1e3!r} ms "
        f"wall; per event: estimator {est_ms!r} ms, update {upd_ms!r} ms, "
        f"refresh {ref_ms!r} ms, kernel segment {seg_ms!r} ms [{card}]")


def pgmc5_profile(tmc, device, path, card):
    """Config 5 with PGMC once more under ``torch.profiler``: the card's
    busy time summed over its kernel rows (one stream, so they do not
    overlap), the idle share of the profiled wall, and the kernels that
    take the most device time.  Returns the run's Simulation."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    sim = pgmc5_sim(tmc, device, path)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = timed_run(sim)
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0))
        rows.append((us / 1e3, evt.count, evt.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    top = "; ".join(f"{name[:60]} x{n}: {ms!r} ms" for ms, n, name in rows[:6])
    print(f"profile: config 5 with PGMC under torch.profiler: {wall!r} s "
          f"wall, the card busy {busy!r} ms "
          f"({100 * busy / (wall * 1e3)!r} %), idle "
          f"{100 * (1 - busy / (wall * 1e3))!r} %, {len(rows)} kernel "
          f"names; most device time: {top} [{card}]")
    check(busy > 0, "the profiler saw no device time")
    return sim


def pgmc5_resume(tmc, device, root, full):
    """Phase 5f: config 5 cut at sweep ``resume`` after a backup, resumed
    from its checkpoint in a fresh Simulation; bit-equal to the run that
    was not cut (``full``).  Returns the seconds of the resumed part."""
    import torch
    from montecarlo_tpu_torch import checkpoint

    class StopAt(tmc.HostAlgorithm):
        def __init__(self, sim, dependencies=(), **_):
            pass

        def make_step(self, sim, t):
            raise Interrupt(t)

    cut = PGMC5["resume"]
    path = os.path.join(root, "cut")
    sim = pgmc5_sim(tmc, device, path, extra=(
        dict(algorithm=tmc.StoreBackups, scheduler=np.asarray([cut])),
        dict(algorithm=StopAt, scheduler=np.asarray([cut]))))
    try:
        sim.run()
        check(False, "config 5 was not cut")
    except Interrupt:
        pass
    check(sim.t == cut, f"config 5 cut at {sim.t}, not {cut}")
    ckpt = os.path.join(path, "checkpoints", f"ckpt_t{cut}.npz")
    resumed = pgmc5_sim(tmc, device, os.path.join(root, "resumed"))
    checkpoint.resume_state(resumed, ckpt)
    check(resumed.t == cut and isinstance(
        resumed.device_state["pge"]["generator"], torch.Generator)
        and resumed.device_state["pge"]["generator"].device.type
        == device.type,
        "config 5 checkpoint did not restore onto the card")
    wall = timed_run(resumed)
    a, b = full.device_state, resumed.device_state
    pairs = {"pos": (a["sys"].pos, b["sys"].pos),
             "species": (a["sys"].species, b["sys"].species),
             "energy": (a["sys"].energy, b["sys"].energy),
             "counters": (a["metropolis"]["counters"],
                          b["metropolis"]["counters"]),
             "sigma": (a["params"][0]["sigma"], b["params"][0]["sigma"]),
             "estimator sums": (a["pge"]["gd"][0].grad_j,
                                b["pge"]["gd"][0].grad_j)}
    same = {k: bool(torch.equal(x, y)) for k, (x, y) in pairs.items()}
    print(f"config 5 resume: cut at sweep {cut} (t={sim.t}), resumed from "
          f"{os.path.basename(ckpt)} in {wall!r} s; bit-equal to the run "
          f"that was not cut: {same}")
    check(all(same.values()), f"config 5 resume differs: {same}")
    return wall


def pgmc3(tmc, device, path, card):
    """Phase 5e: config 3's sigma adaptation on particle-1d (harmonic,
    beta 2) through the Gaussian kernel and the hybrid stepper."""
    from montecarlo_tpu_torch import policy_guided as pg
    from montecarlo_tpu_torch.core.simulation import _select_advance
    from montecarlo_tpu_torch.models import particle1d as p1d
    cfg = PGMC3
    steps = cfg["steps"]
    sched = np.arange(cfg["stride"], steps + 1, cfg["stride"])
    sim = tmc.Simulation(
        p1d.make_system(p1d.harmonic),
        p1d.init_chains(cfg["chains"], beta=cfg["beta"], seed=42,
                        device=device),
        [dict(algorithm=tmc.Metropolis,
              pool=(p1d.displacement_move(cfg["sigma0"]),), seed=42),
         dict(algorithm=pg.PolicyGradientEstimator,
              dependencies=(tmc.Metropolis,), optimisers=(pg.VPG(cfg["eta"]),),
              scheduler=np.arange(cfg["est_every"], steps + 1,
                                  cfg["est_every"])),
         dict(algorithm=pg.PolicyGradientUpdate,
              dependencies=(pg.PolicyGradientEstimator,),
              scheduler=np.arange(cfg["upd_every"], steps + 1,
                                  cfg["upd_every"])),
         dict(algorithm=tmc.StoreCallbacks,
              callbacks=(p1d.callback_energy, tmc.callback_acceptance),
              scheduler=sched),
         dict(algorithm=tmc.StoreParameters, dependencies=(tmc.Metropolis,),
              scheduler=sched)],
        steps, path=path)
    check("hybrid" in _select_advance(sim).__qualname__,
          "config 3 adaptation did not take the hybrid stepper")
    wall = timed_run(sim)
    with open(os.path.join(path, "parameters", "1", "parameters.dat")) as f:
        sig = [float(r.split(" ", 1)[1].strip("[]"))
               for r in f.read().splitlines()]
    e = np.loadtxt(os.path.join(path, "energy.dat"))
    tail = float(e[len(e) // 2:, 1].mean())
    s = float(sim.device_state["params"][0]["sigma"])
    print(f"config 3 adaptation: {cfg['chains']} chains x {steps} steps in "
          f"{wall!r} s ({cfg['chains'] * steps / wall!r} steps/s with "
          f"recorders and PGMC), sigma {sig[0]!r} -> {sig[len(sig) // 2]!r} "
          f"-> {s!r}, energy tail mean {tail!r} [{card}]")
    check(sig[-1] == s and s > 0.6 and sig[len(sig) // 2] > sig[0],
          f"config 3 sigma did not climb ({sig[0]} -> {s})")
    check(abs(tail - 1 / (2 * cfg["beta"])) < 0.02,
          f"config 3 energy tail {tail}")
    return sim, wall


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
    from montecarlo_tpu_torch.core.simulation import _select_advance
    from montecarlo_tpu_torch.models import particle1d as p1d
    from montecarlo_tpu_torch.ops.fused_sweep import SWEEP_KERNEL
    from montecarlo_tpu_torch.ops.lj_sweep import LJ_KERNEL, LJ_MIXED_KERNEL
    from montecarlo_tpu_torch.ops.poly_sweep import POLY_KERNEL
    kernels = (SWEEP_KERNEL, LJ_KERNEL, LJ_MIXED_KERNEL, POLY_KERNEL)

    # 1. device
    device = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)")

    # 2. build, one nvcc per source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as pool:
        list(pool.map(lambda k: k.build(),
                      (SWEEP_KERNEL, LJ_KERNEL, POLY_KERNEL)))
    for k in kernels:
        k.build()
        print(f"build: {k.symbol} from {k.library_path()} "
              f"(nvcc wall {k.build_seconds!r} s)")
    print(f"build: all kernels ready in {time.perf_counter() - t0!r} s")

    # 3. the Gaussian kernel against its plain version
    potentials = (p1d.harmonic, p1d.double_well)
    max_err = kernel_vs_plain(device, potentials)
    segmentation(device, potentials)

    # 4. the LJ kernels against their plain versions
    lj_err = lj_kernels_vs_plain(device)
    lj_segmentation(device)

    # 4b. the poly kernel against its plain version
    poly_err = poly_kernel_vs_plain(device)
    poly_segmentation(device)

    # 5. the main paths; each reads only its own launches
    def zero_counts():
        for k in kernels:
            k.launches = 0

    launches = {}
    with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=ROOT) as tmp:
        zero_counts()
        config1(tmc, p1d, device, os.path.join(tmp, "config1"))
        n1 = SWEEP_KERNEL.launches
        zero_counts()
        wall2 = config2(tmc, p1d, device, os.path.join(tmp, "config2"),
                        CONFIG2_CHAINS, CONFIG2_STEPS, CONFIG2_STRIDE)
        n2 = SWEEP_KERNEL.launches
        print(f"main path: fused_gaussian_sweep launched {n1} times in "
              f"config 1, {n2} in config 2")
        check(n1 > 0 and n2 > 0, "configs 1-2 did not launch the kernel")
        launches["fused_gaussian_sweep"] = n1 + n2
        for name, kernel, cfg, mixed in (
                ("fused_lj_sweep", LJ_KERNEL, CONFIG4, False),
                ("fused_lj_mixed_sweep", LJ_MIXED_KERNEL, POOL5, True)):
            path = os.path.join(tmp, name)
            zero_counts()
            sim, wall = lj_main(tmc, device, path, cfg, mixed)
            counts = {k.symbol: k.launches for k in kernels}
            print(f"main path: {'config-5 pool' if mixed else 'config 4'} "
                  f"launches {counts}")
            check(kernel.launches > 0, f"the main path did not launch {name}")
            launches[name] = kernel.launches
            lj_main_checks(sim, device, path, cfg, mixed, wall)
        path = os.path.join(tmp, "poly")
        zero_counts()
        sim, chains, wall_poly = poly_main(tmc, device, path)
        counts = {k.symbol: k.launches for k in kernels}
        print(f"main path: poly launches {counts}")
        check(POLY_KERNEL.launches > 0,
              "the main path did not launch fused_poly_mixed_sweep")
        launches["fused_poly_mixed_sweep"] = POLY_KERNEL.launches
        poly_main_checks(sim, chains, device, path, wall_poly)

        # 5d. config 5 with PGMC, then the same run without it
        path = os.path.join(tmp, "pgmc5")
        sim5 = pgmc5_sim(tmc, device, path)
        check("hybrid" in _select_advance(sim5).__qualname__,
              "config 5 with PGMC did not take the hybrid stepper")
        wall5, counts = counted(kernels, lambda: timed_run(sim5))
        n5, seg5 = counts[LJ_MIXED_KERNEL.symbol], sync_points(sim5)
        print(f"main path: config 5 with PGMC launches {counts}, {seg5} "
              f"segments between events and recorder points")
        check(n5 == seg5, f"config 5: {n5} launches for {seg5} segments")
        check(sum(counts.values()) == n5, "config 5 launched another kernel")
        launches["fused_lj_mixed_sweep"] += n5
        plain5 = pgmc5_sim(tmc, device, os.path.join(tmp, "pool5"),
                           adaptive=False)
        wall5_plain, counts = counted(kernels, lambda: timed_run(plain5))
        print(f"main path: config 5 without PGMC launches {counts}")
        check(counts[LJ_MIXED_KERNEL.symbol] > 0,
              "config 5 without PGMC did not launch fused_lj_mixed_sweep")
        launches["fused_lj_mixed_sweep"] += counts[LJ_MIXED_KERNEL.symbol]
        pgmc5_checks(sim5, path, wall5, wall5_plain, card)

        sim5p, counts = counted(kernels, lambda: pgmc5_profile(
            tmc, device, os.path.join(tmp, "pgmc5_profiled"), card))
        check(counts[LJ_MIXED_KERNEL.symbol] == sync_points(sim5p),
              "config 5 profiled: one launch per segment")
        launches["fused_lj_mixed_sweep"] += counts[LJ_MIXED_KERNEL.symbol]

        # 5e. config 3's adaptation on the Gaussian kernel
        (sim3, wall3), counts = counted(kernels, lambda: pgmc3(
            tmc, device, os.path.join(tmp, "pgmc3"), card))
        print(f"main path: config 3 adaptation launches {counts}")
        check(counts[SWEEP_KERNEL.symbol] == sync_points(sim3)
              and sum(counts.values()) == counts[SWEEP_KERNEL.symbol],
              "config 3 adaptation: one fused_gaussian_sweep per segment")
        launches["fused_gaussian_sweep"] += counts[SWEEP_KERNEL.symbol]

        # 5f. config 5 cut after a backup and resumed on the card
        _, counts = counted(kernels, lambda: pgmc5_resume(
            tmc, device, tmp, sim5))
        print(f"main path: config 5 cut and resumed launches {counts}")
        check(counts[LJ_MIXED_KERNEL.symbol] > 0,
              "config 5 resume did not launch fused_lj_mixed_sweep")
        launches["fused_lj_mixed_sweep"] += counts[LJ_MIXED_KERNEL.symbol]
    rate2 = CONFIG2_CHAINS * CONFIG2_STEPS / wall2
    print(f"time: config 2 end to end with recorders: {rate2!r} steps/s "
          f"({CONFIG2_CHAINS} chains, stride {CONFIG2_STRIDE}) [{card}]")

    # 6. times
    times = sweep_times(device, card)
    ms, _, _ = times[("kernel", CONFIG2_CHAINS)]
    plain_ms, _, _ = times[("plain_main", CONFIG2_CHAINS)]
    print(f"time: config 2 breakdown: {n2} kernel launches x {ms!r} ms = "
          f"{n2 * ms / 1e3!r} s of {wall2!r} s wall "
          f"({100 * n2 * ms / 1e3 / wall2!r} % in the kernel) [{card}]")
    lj_ms = lj_times(device, card)
    pgmc5_breakdown(sim5, n5, lj_ms["fused_lj_mixed_sweep"][
        ("kernel", 10 * POOL5["n"])], wall5, card)
    poly_ms = poly_times(device, card)
    seg = POLY["stride"] * POLY["n"]
    n_poly = launches["fused_poly_mixed_sweep"]
    print(f"time: poly path breakdown: {n_poly} kernel launches x "
          f"{poly_ms[('kernel', seg)]!r} ms = "
          f"{n_poly * poly_ms[('kernel', seg)] / 1e3!r} s and "
          f"{n_poly} refreshes x {poly_ms['refresh']!r} ms of "
          f"{wall_poly!r} s wall, "
          f"{POLY['chains'] * POLY['n'] * POLY['sweeps'] / wall_poly!r}"
          f" moves/s with recorders [{card}]")
    rows = [{
        "name": "fused_gaussian_sweep",
        "route": "cuda",
        "source": "montecarlo_tpu_torch/csrc/fused_sweep.cu",
        "replaces": "montecarlo_tpu/ops/fused_sweep.py:104",
        "launches": launches["fused_gaussian_sweep"],
        "max_abs_err": max_err,
        "ms": ms,
        "steps": CONFIG2_STRIDE,
        "plain_ms": plain_ms,
        "plain_steps": CONFIG2_STRIDE,
    }]
    for name, mixed, cfg, line in (
            ("fused_lj_sweep", False, CONFIG4, 122),
            ("fused_lj_mixed_sweep", True, POOL5, 191)):
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "montecarlo_tpu_torch/csrc/lj_sweep.cu",
            "replaces": f"montecarlo_tpu/ops/lj_sweep.py:{line}",
            "launches": launches[name],
            "max_abs_err": lj_err[mixed],
            "ms": lj_ms[name][("kernel", 10 * cfg["n"])],
            "steps": 10 * cfg["n"],
            "plain_ms": lj_ms[name][("plain", LJ_TIME_STEPS)],
            "plain_steps": LJ_TIME_STEPS,
        })
    rows.append({
        "name": "fused_poly_mixed_sweep",
        "route": "cuda",
        "source": "montecarlo_tpu_torch/csrc/poly_sweep.cu",
        "replaces": "montecarlo_tpu/ops/poly_sweep.py:37",
        "launches": launches["fused_poly_mixed_sweep"],
        "max_abs_err": poly_err,
        "ms": poly_ms[("kernel", seg)],
        "steps": seg,
        "plain_ms": poly_ms[("plain", LJ_TIME_STEPS)],
        "plain_steps": LJ_TIME_STEPS,
    })
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
