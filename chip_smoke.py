#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives ``montecarlo_tpu_torch`` through its main paths on the card and
holds each hand-written CUDA kernel to its plain PyTorch version:

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit (``nvidia-smi``);
2. build: compiles ``csrc/fused_sweep.cu``, ``csrc/lj_sweep.cu``,
   ``csrc/poly_sweep.cu``, ``csrc/threefry.cu`` and ``csrc/lj_energy.cu``
   with one nvcc each, started together;
3. the Gaussian sweep kernel vs its plain version, harmonic and double
   well, at M = 10, 10^4 and 10^6 (one M for each lane-group width T that
   ``group_lanes`` picks on an H100: 32, 8, 1; the T used is printed), even
   and odd t0, n_steps 1, 2, 7, 1001 and 10^4; every T from 1 to 32 against
   the picked one, bit for bit; segmentation invariance at each M (one
   launch of n steps equals three launches summing to n, bit for bit);
4. both LJ kernels vs their plain versions at config 4's shape (256 chains
   x N 256) and the config-5 pool's (64 x N 1024: eight warps a chain), 3 x
   N 100 and 1 x N 20 (N no multiple of 32, N < 32), 4 x N 4648 (sixteen
   warps, ten slots a thread, N no multiple of 512), a gridded case (M 300
   over blocks of 256, M 20 over blocks of 8) and mono-species chains;
   after each run the kernel's cached energies against an O(N^2)
   recompute, positions in [0, box) and the species composition;
   segmentation invariance of both;
4b. the polydisperse swap kernel vs its plain version at the main path's
   shape (64 chains x N 256, w_disp 0.8: eight warps a chain), 64 x N 1024,
   gridded cases (M 300 over blocks of 256, M 20 over blocks of 8, M 12 x
   N 100 over blocks of 8), N 2 and N 20 (one warp), 4 x N 4648 (sixteen
   warps): bit for bit, with the cache against an O(N^2) recompute,
   positions in [0, box) and each chain's diameters conserved;
   segmentation invariance;
4c. the 2-D LJ energy kernel (``ops/lj_energy.py``, the cache refresh's on
   the card) against the plain ``total_energy`` at the ka2d cell's shape
   (64 x N 1024, rho 1.2, A65 B35, one mixed sweep off the lattice), 4 x N
   4648 and 2 x N 2049 (two passes over the columns), N 1000, 20 and 2:
   within 1e-5 relative of the float64 energy a chain, bit-equal from call
   to call and for a chain alone; timed at 64 x N 1024 beside the plain
   float32 ``total_energy`` (64 rows a pass) and its bound by operations
   (pair terms and those inside the cutoff counted from the inputs).  The
   cache gates of phases 4, 5 and 9 recompute with the plain
   ``_energies``, never with this kernel;
5. the main paths, ``Simulation.run`` on CUDA, each with every launch count
   set to 0 just before and read just after: config 1 (the README example,
   10 chains, per-chain DAT files), run as the README writes it, with no
   ``device=`` argument anywhere: the chains, the device state and the
   kernel launches must be on ``cuda``; config 2 (10^4 chains, energy +
   acceptance callbacks, chain-major BIN trajectories), config 4 (2-D LJ,
   256 chains x N 256, displacement, energy per particle + acceptance) and
   the config-5 pool of ``examples/lj_2d.py`` without PGMC (64 chains x
   N 1024, displacement + swap, callbacks and ``StoreLastFrames``), in both
   one LJ energy launch a refresh and one for ``init_chains``, and the
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
5g. the other two pools the hybrid stepper reaches, with PGMC: the poly
   pool at 64 x N 256 and the one-move LJ pool at 256 x N 256, VPG on the
   displacement sigma (estimator every 10 sweeps, update every 20), 100
   sweeps, energy, acceptance and parameters every 10; one launch per
   segment between sync points, sigma adapted, on the card and equal to the
   last ``parameters.dat`` row, the cache within the reference's bounds;
6. times of each kernel and its plain version at its main path's shape and
   segment, each beside its bound (the larger of the bytes the function must
   move over the card's memory rate and the operations it needs, counted
   from this run's attempts, over the card's float32 rate), and the
   end-to-end rates and breakdowns of config 2, config 4, the config-5 pool
   and the poly path, and where config 5's wall goes with PGMC; the poly
   kernel at every block width W (64 x N 256 and N 1024); each printed
   beside the card's name and power limit;
7. the checkerboard cell-MC path (the substep kernel
   ``csrc/cell_substep.cu`` for 2-D LJ on the card, its torch twin
   elsewhere): 7a. ``examples/cell_mc_large_n.py``'s LJ run at full width
   (32 chains x N 32768, above what the row kernel holds; rho 1.2, beta
   1/0.45, 20 % B, sigma 0.08, sweepstep N/4, 40 steps, energy and
   acceptance every 10) through ``Simulation.run`` with ``fused='auto'``
   and no ``device=``: the cell route taken (no row kernel launched, the
   substep kernel once a substep), no overflow, acceptance, the
   cache of 4 chains against an O(N^2) recompute, the ``Cell MC: enabled``
   line; a segment and a refresh timed apart; 7b. the LJ species pool and the poly pair pool at 64 x
   N 4096 with ``fused='cell'``, hard disks at 16 x N 16384 (eta 0.70):
   composition, caches, no overlap; 7c. the LJ row kernel against the cell
   path at 64 and 32 chains, N 2048 to 19114, a sweep a call, two passes, moves/s
   and their ratio (what keeps ``'auto'`` on the row kernel wherever one
   takes the pool), with the route ``'auto'`` picks at each N, the cell
   path's launches per substep under ``torch.profiler``, and its two
   neighbourhood layouts; 7d. one segment on the card and on the CPU from
   the same draws, substep by substep; 7e. the substep kernel
   (``csrc/cell_substep.cu``) against its torch twin at the ka2d_large
   cell's shape, bit for bit, each timed by CUDA events beside the bound of
   ``h100_bench/counts/cell_substep.py``;
8. NPT and 3-D (plain torch on the cell and generic paths, no kernel of
   their own, every row kernel's launches read and held at 0): 8a.
   ``tools/bench_cell3d_npt.py``'s 3-D LJ (16 x N 4096) on the generic
   path against the 3-D cell path through ``Simulation.run``, moves/s and
   their ratio, the cache and composition; 8b. its polydisperse NPT pool
   (16 x N 2048, displacement + swap + volume) with ``fused='off'`` against
   ``'auto'`` (the cell route with volume substeps): volume moves accepted,
   boxes above the grid's floor, diameters kept, the cache; 8c. the NPT
   swap-MC glass protocol of ``benchmarks/glass_protocol_r05.json`` (128 x
   N 2048, T 0.4, P 4.0, ~100 sweeps, BIN store) gated on the record's
   density and acceptances; 8d. hard spheres under NPT on the 3-D cell path
   (16 x N 4096): no overlap, boxes moved; 8e. an NPT and a 3-D segment on
   the card and on the CPU from the same draws: no accept difference,
   boxes and fractional positions within 1e-6; 8f.
   a 3-D displacement substep and a volume substep in ms and launches under
   ``torch.profiler``, and the ideal-gas gate <V> = (N + 1) / (beta P) on
   the generic path on the card in 2-D and 3-D;
9. the chain mesh (``montecarlo_tpu_torch.parallel``; the machine has one
   card, so the ranks share it and no figure here is a multi-GPU one):
   9a. each sharded entry point (``sharded_gaussian_sweep``,
   ``sharded_lj_sweep``, ``sharded_lj_mixed_sweep``,
   ``sharded_poly_mixed_sweep``) at its main path's width for every rank
   of S = 2 and 4 in one process: one launch of its kernel per call, equal
   to the plain version with the rank's folded seed (the Gaussian one
   within its gate, the others bit for bit), the ranks' outputs differing;
   9b. two ranks of this script started on the card (``gloo``: NCCL
   refuses two ranks on one GPU, so each collective copies its CUDA
   tensors to host memory and back) run config 2 (at a tenth of phase 5's
   depth), config 4, config 5 with PGMC and the poly path through
   ``Simulation(mesh=...)``, with no ``device=`` argument: every rank
   launches its kernel on ``cuda``, rank 0 alone writes files, each rank's
   whole state (positions, energies, counters, sigma, the estimator's sums)
   equals a one-process emulation on the card (``parallel.run_emulated``:
   each rank's kernels with its folded seed, the estimator's sums added),
   and phase 5's physics and cache gates hold on what rank 0 gathered; 9c.
   one rank on ``nccl``: config 2 equals the one-rank emulation; 9d.
   config 5 resumed on two ranks from its sweep-100 backup equals the run;
   each path's wall on two ranks beside one process, the bytes gathered a
   rank at each observe point, and the collectives' times;
10. event-chain MC and replica exchange (plain torch; the reference's
   widths, the host-bound event loops cut in depth as the constants
   ``ECMC_*`` name): 10a. hard-disk ECMC at ``tools/bench_ecmc.py 64
   0.70`` (64 x N 64, chain length box/2, 8 events a step, 48 steps, not
   400) with |psi6| every step, against MH: events/s,
   no cap hit, no overlap, the tau of |psi6| under each (the port's
   ``analysis``) and the card's busy share under ``torch.profiler``; 10b.
   3-D hard spheres at ``tests/test_ecmc.py``'s size (16 x N 216, eta
   0.35): the MKK pressure in 4-6; 10c. ``ReplicaExchange`` on the hybrid
   stepper between segments of kernel #1 at config 2's width (2,500
   ladders of beta 0.5, 1, 2, 4, a swap every 10 steps, 10^5 steps): each
   beta's variance within 12 % of 1/(2 beta), every pair's swap rate above
   0.05, one launch per segment; 10d. LJ ECMC at ``tools/bench_ecmc_lj.py``'s
   two widths (N 64, rho 0.6, 64 and 512 chains): the MKK pressure within
   8 % of the virial pressure, events/s, the tau of e/N under ECMC and MH
   (MH's one-move pool on kernel #2); 10e. poly ECMC at
   ``tests/test_ecmc_soft.py``'s size against MH in that test's band, both
   6 steps from a configuration MH equilibrated;
11. the lattice models (plain torch): 11a. checkerboard sweeps at
   ``tools/bench_ising2d.py``'s defaults (1024 x 64^2, beta 0.44, 4 sweeps
   a step, 200 steps): spin-flip attempts/s and the busy share; 11b. Wolff
   and Swendsen-Wang at 64 x 64^2 near beta_c, their energies agreeing;
   11c. every sampler (checkerboard, single flip, Wolff, SW, the Potts
   samplers, the 1-D ring) at an exactly enumerable size against the exact
   moments in its reference test's band; 11d. one step of each lattice
   sampler, one replica-exchange call and one event of each ECMC hook on
   the card and on the CPU from the same inputs and draws;
12. the continuous and quantum lattice models and Wang-Landau (plain
   torch): 12a and 12b, ``CheckerboardXY`` and ``CheckerboardHeisenberg``
   with one over-relaxation sweep after each of 4 Metropolis sweeps a
   step at ``tools/bench_ising2d.py``'s widths (1024 x 64^2, 200 steps):
   spin-update attempts/s, launches a step, the busy share and the cached
   energy against a float64 recompute; 12c, both models' checkerboard and
   single-rotation paths on the 2 x 2 lattice against the exact moments
   (256 chains), TFIM against ED at ``tests/test_tfim.py``'s size and
   through ``examples/torch/tfim_quantum.py`` at its widths; 12d,
   Wang-Landau at ``examples/wang_landau_ising.py``'s widths: proposals/s
   and launches a proposal, then the reference test's gate over the full
   60,000 steps if the measured rate fits them in 240 s, else on the 3 x 3
   lattice (the 4 x 4 run cut, with where its log f got); 12e, each new
   step on the card and on the CPU from the same inputs and draws;
13. the reference's per-chain random streams (``utils/prng.py`` over the
   threefry kernel ``csrc/threefry.cu``): 13a, the kernel against its plain
   twin at 10^7 values (10^4 keys x 1000) in each mode (words, bits,
   uniform, randint bit for bit; normal within 4 ulps), timed there and at
   the generic path's shape; 13b, config 2's system (10^4 chains, 1000
   steps) and config 4 (256 x N 256, 2 sweeps) on the generic path
   (``fused='off'``) with the threefry launches set to 0 just before and
   read just after: moves/s, kernel launches a Metropolis step and the
   card's busy share under ``torch.profiler`` (with ``--parent-tree TREE``
   the same runs of the package in TREE and of this one, each in a child
   process, in turns parent, this, this, parent); 13c, the same seed's
   generic runs on the card and on the CPU (initial chains and counters
   equal, states within 1e-5); 13d, the generic path with PGMC on two gloo
   ranks sharing the card equal, tensor for tensor, to one process, and
   their backup resumed in one process equal to the uncut run;
14. every sampler on the reference's per-chain keys (the cell path,
   replica exchange, ECMC, the lattice drivers, Wang-Landau): 14a, the
   threefry kernel's ``split_uniform`` mode (the soft-potential event
   loops' key split and thresholds in one launch) bit for bit against its
   plain twin at the LJ event loop's shape (64 keys x 64) and at 10^7
   values, timed beside its bound; 14b, each sampler from one seed on the
   card and on the CPU at the CPU tests' sizes, 4 steps: counters and
   discrete states equal, continuous ones within 1e-5 (a chain that goes
   its own way is printed with the step and the margin at which it did);
   14c, each path at its phase's width, cut in depth (the cell path at 32
   x N 32768, hard-disk ECMC at 64 x N 64 eta 0.70, LJ ECMC at 64 x N 64,
   the checkerboard, XY and Heisenberg at 1024 x 64^2, Wang-Landau at
   examples/wang_landau_ising.py's widths, replica exchange at 10c's), the
   threefry launches set to 0 just before and read just after: units/s,
   launches a unit and the busy share (with ``--parent-tree TREE`` the
   same runs of both trees in child processes, in turns).

Prints its findings on lines before the last, a ``{"kernels": [...]}``
line (``ms`` and ``plain_ms`` per call at the main path's segment of
``steps`` steps; ``library_ms`` is null: no single PyTorch call computes a
Metropolis sweep; ``entry_points`` names the unsharded and the sharded
entry point that launch the kernel, ``launches`` counts both, of which
``mesh_launches`` those of phase 9's ranks; kernel #1's count includes
phase 10c's segments, kernel #2's phase 10d's MH runs; the threefry row's
``launches`` are phase 13b's, 13d's and 14c's, its times at the generic
path's shape of one uniform for each of 10^4 chains; the
``threefry_split_uniform`` row is the kernel's new mode, its launches 14c's,
its times at the LJ event loop's shape; the ``lj_total_energy`` row's
``launches`` are phase 5's two LJ main paths', its times phase 4c's at 64
x N 1024; the ``cell_substep`` row's ``launches`` are phase 7a's, its
times phase 7e's a substep at the ka2d_large cell's shape, ``ms``,
``plain_ms`` and ``bound_ms`` a displacement substep, the ``swap_``
keys a swap substep), and as the last line
``{"ok": true, "device": {...}}``.
Any failed check raises, so the script exits non-zero without the last
line.

Usage: python3 chip_smoke.py [--parent CSRC_DIR] [--parent-tree TREE]
[--kernels-only] [--cell-only] [--npt-only] [--mesh-only] [--ecmc-only]
[--lattice-only] [--spins-only] [--streams-only] [--samplers-only]
[--energy-only] [--nccl-pair]

``--parent CSRC_DIR`` names a directory with an earlier version of
``fused_sweep.cu``, ``lj_sweep.cu`` and ``poly_sweep.cu`` (and their
headers) with commit e6e7854's interface (a lane count for the Gaussian
kernel, a warp count for the LJ kernels, one warp per polydisperse chain).
They are built beside the package's kernels and, in one call, timed against
them in turns (earlier, present, present, earlier) at the main paths'
shapes (the poly kernel at 64 x N 256 and N 1024); the Gaussian and LJ
kernels must equal the earlier ones bit for bit at every shape of phases 3
and 4, the poly kernel where its block is one warp (N <= 32, the same sum
order).  ``--kernels-only`` stops after phase 4b (and the comparison with
``--parent``); ``--cell-only`` runs phase 7 alone after the build,
``--npt-only`` phase 8, ``--mesh-only`` phase 9, ``--ecmc-only`` phase
10, ``--lattice-only`` phase 11, ``--spins-only`` phase 12,
``--streams-only`` phase 13, ``--samplers-only`` phase 14,
``--energy-only`` phase 4c.
``--parent-tree TREE`` names a checkout of an earlier commit (``git
archive``) whose generic path (13b) and keyed samplers (14c) are timed
beside this one's.
``--nccl-pair`` is no phase: after the build it starts two ``nccl`` ranks
on the one card and prints what NCCL does with them.
"""

import argparse
import ctypes

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
# one M for each lane-group width the rule picks on an H100 (T = 32, 8, 1);
# 10^6 chains are four of the reference's blocks
SIZES = (10, 10 ** 4, 10 ** 6)
# (t0, n_steps): odd and even starts, segments of 1, 2 and 7 steps (shorter
# than a round of any T), a few hundred pairs
STEP_CASES = ((7, 1), (8, 1), (7, 2), (8, 2), (7, 7), (8, 7), (T0, N_STEPS))
LONG_STEPS = 10 ** 4             # config 2's segment
ALL_LANES = (1, 2, 4, 8, 16, 32)
# the card's published peaks (NVIDIA H100 SXM data sheet): device memory
# rate, and 67 TFLOP/s float32 outside the tensor cores, which counts a
# fused multiply-add as two: 3.35e13 operations a second over all lanes
HBM_BYTES_PER_S = 3.35e12
LANE_INSTR_PER_S = 67e12 / 2
ATOL = 1e-5                      # x and e: float32 ulps of log/sin/cos
MAX_FLIP_FRACTION = 1e-4         # chains allowed an ulp-level accept flip
CONFIG2_CHAINS = 10 ** 4
CONFIG2_STRIDE = 10 ** 4
CONFIG2_STEPS = 2 * 10 ** 7
LJ_SIGMA, LJ_T0, LJ_STEPS = 0.1, 7, 301      # odd start, a few hundred steps
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
# the other two pools the hybrid stepper reaches (phase 5g): the poly pool
# and the one-move LJ pool, VPG on the displacement sigma
PGMC_POOLS = dict(sweeps=100, eta=0.001, q=2, est_every=10, upd_every=20,
                  stride=10, poly=(POLY["chains"], POLY["n"]),
                  lj=(CONFIG4["chains"], CONFIG4["n"]))
# config 3's adaptation on the Gaussian kernel: sigma 0.2 climbs toward ~1.2
PGMC3 = dict(chains=10 ** 4, beta=2.0, sigma0=0.2, eta=0.05, steps=4000,
             est_every=10, upd_every=20, stride=100)
# the cell path (phase 7): examples/cell_mc_large_n.py's configuration (2-D
# KA-LJ, rho 1.2, beta 1/0.45, 20 % B, sigma 0.08, sweepstep N/4, 40 steps)
# at the largest N of the reference's record of it
# (benchmarks/cell_large_n_r05.json: 32 chains x N 32768), callbacks every
# 10 steps; 'auto' leaves smaller N to the row kernel on the card
CELL_MAIN = dict(chains=32, n=32768, rho=1.2, beta=1.0 / 0.45, frac_b=0.2,
                 sigma=0.08, steps=40, every=10)
# phase 7b: the species and pair pools at N 4096 x 64 with fused='cell';
# hard disks at N 16384 x 16, eta 0.70, delta 0.12
CELL_POOLS = dict(chains=64, n=4096, w_disp=0.8, sweeps=1)
CELL_HD = dict(chains=16, n=16384, eta=0.70, delta=0.12, sweeps=2)
# phase 7c: the row kernel against the cell path, one sweep a call, up to
# the largest N the row kernel holds (ops/lj_sweep.py: MAX_PARTICLES), at
# 64 chains and at 32 (the row kernel gives a chain one SM; the cell path's
# host time a substep does not depend on the chains)
CROSSOVER_N = (2048, 4096, 8192, 16384, 19114)
CROSSOVER_CHAINS = (64, 32)
PROFILED_N = (2048, 16384)      # the cell path profiled, layouts timed
# phase 7d: one segment on the card and on the CPU from the same draws
CELL_TWIN = dict(chains=8, n=4096, w_disp=0.7, substeps=60, seed=5)
# phase 7e: the substep kernel against its twin at the ka2d_large cell's
# shape (h100_bench/configs/ka2d_large.json): launches timed a colour
CELL_KERNEL = dict(chains=32, n=32768, rho=1.2, beta=1.0 / 0.45,
                   frac_b=0.35, sigma=0.08, kernel_reps=50, twin_reps=5)
# phase 8: NPT and 3-D.  8a and 8b: tools/bench_cell3d_npt.py's two
# configurations, each path with its (sweepstep, steps)
NPT_LJ3D = dict(chains=16, n=4096, rho=1.0, beta=1.0 / 0.45, frac_b=0.2,
                sigma=0.06, off=(64, 4), cell=(512, 16))
NPT_POLY = dict(chains=16, n=2048, rho=1.0, beta=1.0 / 0.4, pressure=4.0,
                sigma=0.08, w=(0.75, 0.2, 0.05), dlnv=0.002, off=(64, 4),
                auto=(512, 16))
# 8c: benchmarks/glass_protocol_r05.json's configuration, 100 sweeps as 400
# steps of N/4 with records every 10 steps (41 records, as the record's);
# the record gives no proposal widths: sigma 0.08 and dlnv 0.01 are those
# with which the reference reproduces its acceptances
# (tools/glass_protocol_widths.py); the gate is its physics columns, never
# its speed
GLASS = dict(chains=128, n=2048, T=0.4, P=4.0, w=(0.798, 0.2, 0.002),
             sigma=0.08, dlnv=0.01, sweepstep=512, steps=400, every=10)
GLASS_RECORD = dict(density=0.9004, density_band=0.015,
                    acc=(0.487, 0.277, 0.374), acc_band=0.03)
# 8d: tests/test_npt.py's hard-sphere NPT cell run at 16 chains
NPT_HS = dict(chains=16, n=4096, eta=0.30, beta_p=3.0, dlnv=0.002,
              delta=0.12, sweepstep=512, steps=12)
# 8e: an NPT and a 3-D segment on the card and on the CPU, same draws
NPT_TWIN = dict(chains=8, n2=4096, n3=4096, substeps=60, seed=6)
# phase 9: the chain mesh.  The machine has one card, so the ranks share
# it: two ranks on gloo (NCCL refuses two ranks on one GPU), whose
# collectives copy the chains' CUDA tensors to host memory and back, and
# one rank on nccl.  9b runs config 2 at a tenth of phase 5's depth (200
# recorder periods); 9a calls each sharded entry point for `steps` steps (the
# Gaussian one for N_STEPS) on every rank of each of `shards` rank counts
MESH = dict(world=2, config2_steps=CONFIG2_STEPS // 10, shards=(2, 4),
            steps=64, timeout=600, reps=20)
MESH_RUNS = ("config2", "config4", "pgmc5", "poly")


_ONCE = {}


def host_box(st):
    """The box edge of ``st`` as a float, read from the card once per state:
    a read in a timed loop would make every call wait for the one before."""
    key = ("box", id(st.box))
    if key not in _ONCE:
        _ONCE[key] = (st.box, float(st.box[0]))   # keeps the id taken
    return _ONCE[key][1]


def card_scalar(value, device):
    """A 0-d float32 tensor on ``device``, made once: a copy from the host
    in a timed loop would make every call wait for the one before."""
    import torch
    key = ("scalar", value, str(device))
    if key not in _ONCE:
        _ONCE[key] = torch.tensor(value, dtype=torch.float32, device=device)
    return _ONCE[key]


def _first(st, k):
    """The first ``k`` chains of a chain-stacked state."""
    return dataclasses.replace(st, **{f.name: getattr(st, f.name)[:k]
                                      for f in dataclasses.fields(st)})


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def cuda_time(fn, reps, warm=True):
    """Mean milliseconds per call of ``fn`` over ``reps`` calls, by CUDA
    events, after one warm-up call (none with ``warm=False``, for a plain
    version whose one call takes seconds)."""
    import torch
    if warm:
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# Operations per lane that the functions need, for the bounds: counted in
# the compiled kernels' loop bodies (``cuobjdump -sass`` of the libraries
# this script builds: integer, float and special-function operations
# alike, with the loops' loads and branches, without the slow paths of
# sinf/cosf that arguments below 2 pi never take, nor those of __frcp_rn
# that arguments of normal exponent never take).
GAUSS_INSTR_PER_STEP = 125        # half a pair: 378 a pair, less 131 slow path
# a pair term (minimum image, exact reciprocal, pair energy, masked add):
# (in a displacement's two rows, in a swap's four, which share the geometry
# two by two)
LJ_INSTR_PER_TERM = (57, 44)      # loops of 455 and 352 for 8 terms
LJ_INSTR_PER_PICK = 48            # a swap-pick uniform a slot: 191 for 4 slots
POLY_INSTR_PER_TERM = (52, 43)    # loops of 419 for 8 and 687 for 16 terms
INSTR_PER_STEP_DRAWS = 300        # kind, pick, Box-Muller, log u: once a step
# The 2-D LJ energy (csrc/lj_energy.cu) counted from the function's own
# operations, not the compiled loop: a pair term is two differences, two
# minimum images (a multiply, a rounding, a multiply, a subtraction each),
# r2 (two multiplies, an add), the species compare and the cutoff test; a
# term inside the cutoff adds a max, a division, four multiplies, two
# subtractions and the add.
LJ_ENERGY_OPS_PER_TERM = 15
LJ_ENERGY_OPS_INSIDE = 9
# phase 4c: (label, M, N); the ka2d cell's mixture at rho 1.2, A65 B35
LJ_ENERGY_CASES = (
    ("the ka2d cell's shape", 64, 1024),
    ("two column passes, N no multiple of 128", 4, 4648),
    ("one column past a pass", 2, 2049),
    ("N no multiple of 32", 2, 1000),
    ("N < 32", 3, 20),
    ("N 2", 1, 2),
)
LJ_ENERGY_RTOL = 1e-5     # against the float64 energy, a chain


def bound(n_bytes, operations):
    """The least time (ms) the card could take: the bytes the function must
    move (inputs read once, outputs written once) over the memory rate, or
    its operations over the float32 rate, whichever is larger; and which
    of the two it is."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = operations / LANE_INSTR_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes > by_ops
                                   else "operations")


def particle_bound(m, n, attempts, per_term, per_pick=0):
    """The bound of a particle sweep of ``attempts`` = (displacements,
    swaps) summed over the chains: two rows of N pair terms a displacement,
    four a swap (and N pick draws for the LJ swap), the draws once a step;
    the state (x, y and one attribute per particle) read and written once."""
    disp, swap = attempts
    instr = (disp * (2 * n * per_term[0] + INSTR_PER_STEP_DRAWS)
             + swap * (4 * n * per_term[1] + n * per_pick
                       + INSTR_PER_STEP_DRAWS))
    return bound(2 * m * (12 * n + 8) + 16 * m, instr)


def inputs(m, device, rng):
    import torch
    x = torch.as_tensor(rng.uniform(-2.0, 2.0, m).astype(np.float32),
                        device=device)
    beta = torch.as_tensor(rng.uniform(0.5, 3.0, m).astype(np.float32),
                           device=device)
    sigma = torch.tensor(SIGMA, dtype=torch.float32, device=device)
    return x, beta, sigma


def gauss_compare(pot, m, t0, n, args):
    """The Gaussian kernel against its plain version on ``args`` = (x, beta,
    sigma): the present gate.  Returns the largest |kernel - plain| over
    agreeing chains and the kernel's outputs."""
    from montecarlo_tpu_torch.ops.fused_sweep import fused_gaussian_sweep
    xk, ek, ak = out = fused_gaussian_sweep(*args, SEED, t0, n, potential=pot)
    xp, ep, ap = fused_gaussian_sweep(*args, SEED, t0, n, potential=pot,
                                      interpret=True)
    dx = (xk - xp).abs()
    de = (ek - ep).abs()
    off = (ak != ap) | (dx > ATOL) | (de > ATOL)
    n_off = int(off.sum())
    keep = ~off
    err = max(float(dx[keep].max()), float(de[keep].max())) \
        if bool(keep.any()) else 0.0
    u_err = float((ek - pot(xk)).abs().max())
    same = int(((xk == xp) & (ek == ep) & (ak == ap)).sum())
    print(f"kernel vs plain: {pot.__name__} M={m} t0={t0} "
          f"n={n}: {n_off} chains with an accept flip, "
          f"max |diff| {err!r} on the rest, {same}/{m} bit-equal, "
          f"max |e' - U(x')| {u_err!r}, "
          f"acceptance {float(ak.sum()) / (m * n)!r}")
    check(n_off <= MAX_FLIP_FRACTION * m,
          f"{n_off} of {m} chains disagree ({pot.__name__})")
    check(err <= ATOL, f"kernel vs plain differ by {err}")
    check(u_err <= 1e-6, f"e' != U(x') by {u_err}")
    return err, out


def kernel_vs_plain(device, potentials, parent=None):
    """Phase 3.  Returns the largest |kernel - plain| over agreeing chains.
    With ``parent`` (the earlier kernels), every case must also equal the
    earlier Gaussian kernel bit for bit."""
    import torch
    from montecarlo_tpu_torch.ops.fused_sweep import group_lanes
    rng = np.random.default_rng(SEED)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    worst, n_parent = 0.0, 0
    for k, m in enumerate(SIZES):
        print(f"lane groups: M={m} on {sms} SMs: T = {group_lanes(m, sms)} "
              f"lanes per chain")
        # the long segment once per M, alternating potential and parity
        long_case = (potentials[k % 2], T0 + k % 2, LONG_STEPS)
        cases = [(pot, t0, n) for pot in potentials
                 for t0, n in STEP_CASES] + [long_case]
        for pot, t0, n in cases:
            args = inputs(m, device, rng)
            err, out = gauss_compare(pot, m, t0, n, args)
            worst = max(worst, err)
            if parent is not None:
                old = parent.gaussian(*args, t0, n, pot)
                check(all(torch.equal(a, b) for a, b in zip(out, old)),
                      f"the Gaussian kernel differs from the earlier one "
                      f"({pot.__name__} M={m} t0={t0} n={n})")
                n_parent += 1
    if parent is not None:
        print(f"kernel vs earlier kernel: x', e' and the accept counts "
              f"bit-equal in all {n_parent} cases")
    return worst


def lanes_invariance(device, potentials):
    """Phase 3: the lane-group width changes no bit.  Every T from 1 to 32
    against the T the rule picks, at every M and segment of phase 3."""
    import torch
    from montecarlo_tpu_torch.ops import fused_sweep as fs
    rng = np.random.default_rng(SEED + 3)
    n_cases = 0
    for k, m in enumerate(SIZES):
        pot = potentials[k % 2]
        bc = fs._block_chains(m, 2048)
        for t0, n in STEP_CASES + ((T0 + k % 2, LONG_STEPS),):
            x, beta, sigma = inputs(m, device, rng)
            want = fs.fused_gaussian_sweep(x, beta, sigma, SEED, t0, n,
                                           potential=pot)
            for lanes in ALL_LANES:
                got = fs._cuda_sweep(x, beta, sigma, SEED, t0, n, pot, bc,
                                     lanes=lanes)
                check(all(torch.equal(a, b) for a, b in zip(got, want)),
                      f"T={lanes} differs from the picked T ({pot.__name__} "
                      f"M={m} t0={t0} n={n})")
                n_cases += 1
    print(f"lane groups: T = {list(ALL_LANES)} bit-equal to the picked T in "
          f"all {n_cases} cases (M = {list(SIZES)}, harmonic and double well)")


def segmentation(device, potentials):
    """Phase 3: one call of n steps == three calls summing to n, at each M
    (each T the rule picks)."""
    import torch
    from montecarlo_tpu_torch.ops.fused_sweep import fused_gaussian_sweep
    rng = np.random.default_rng(SEED + 1)
    for k, m in enumerate(SIZES):
        pot = potentials[k % 2]
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


def config1(tmc, p1d, path):
    """The README example as the README writes it: 10 chains, per-chain DAT
    trajectories, and no ``device=`` argument anywhere, so everything must
    land on the card by default."""
    seed, beta, m, steps, burn = 42, 2.0, 10, 10 ** 5, 1000
    times = tmc.build_schedule(steps, burn, 10)
    chains = p1d.init_chains(m, beta=beta, seed=seed)
    check(all(t.device.type == "cuda" for t in (chains.x, chains.beta,
                                                chains.e)),
          f"init_chains without device= made chains on {chains.x.device}")
    sim = tmc.Simulation(
        p1d.make_system(p1d.harmonic),
        chains,
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
    from montecarlo_tpu_torch.utils.tree import tree_leaves
    where = {str(leaf.device.type) for leaf in tree_leaves(sim.device_state)
             if hasattr(leaf, "device")}
    print(f"config 1: no device= argument: chains on {chains.x.device}, the "
          f"simulation on {sim.device}, the device state on {sorted(where)}")
    check(sim.device.type == "cuda" and where == {"cuda"},
          f"config 1 without device= ran on {sim.device}, state on {where}")
    check(abs(tail - 1 / (2 * beta)) < 0.02, f"config 1 energy {tail}")
    check(0.05 < acc < 0.99, f"config 1 acceptance {acc}")
    check(all(t.shape == (len(times) + 1, 2) for t in trj),
          "config 1 trajectory files")
    check(os.path.exists(os.path.join(path, "summary.log")),
          "config 1 summary.log")


def config2_sim(tmc, p1d, device, path, m, steps, stride, mesh=None,
                fused="auto"):
    """BASELINE config 2: energy + acceptance, BIN trajectories."""
    sched = np.arange(stride, steps + 1, stride)
    return tmc.Simulation(
        p1d.make_system(p1d.harmonic),
        p1d.init_chains(m, beta=2.0, seed=42, device=device),
        [dict(algorithm=tmc.Metropolis,
              pool=(p1d.displacement_move(sigma=SIGMA),), seed=42,
              fused=fused),
         dict(algorithm=tmc.StoreCallbacks,
              callbacks=(p1d.callback_energy, tmc.callback_acceptance),
              scheduler=sched),
         dict(algorithm=tmc.StoreTrajectories, fmt=tmc.BIN(),
              scheduler=sched)],
        steps, path=path, mesh=mesh)


def config2(tmc, p1d, device, path, m, steps, stride):
    """Runs config 2 and checks its physics; returns the wall seconds."""
    sim = config2_sim(tmc, p1d, device, path, m, steps, stride)
    t0 = time.perf_counter()
    sim.run()
    wall = time.perf_counter() - t0
    config2_checks(tmc, sim.device_state["sys"].x.device.type, device, path,
                   m, steps, stride, wall)
    return wall


def config2_checks(tmc, on_card, device, path, m, steps, stride, wall):
    """Config 2's physics from its files: the energy tail, the BIN frame's
    shape, mean and std, acceptance; ``on_card`` is the device type of the
    final state."""
    sched = np.arange(stride, steps + 1, stride)
    ts, fields = tmc.load_chain_major_trajectories(path)
    frame = fields["frame"]
    tail = np.asarray(frame[len(ts) // 2:])
    e = np.loadtxt(os.path.join(path, "energy.dat"))
    a = np.loadtxt(os.path.join(path, "acceptance.dat"))
    e_tail = float(e[len(e) // 2:, 1].mean())
    acc = float(a[-1, 1])
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
    args = (st.pos, st.species, st.beta, st.energy, host_box(st),
            card_scalar(LJ_SIGMA, st.pos.device))
    kw = dict(params=lj.LJParams(), interpret=interpret,
              block_chains=block_chains)
    if mixed:
        return fused_lj_mixed_sweep(*args, w_disp, SEED, t0, n_steps, **kw)
    pos, e, acc = fused_lj_sweep(*args, SEED, t0, n_steps, **kw)
    return pos, st.species, e, acc, None


def plain_energy(mod, params, st):
    """The O(N^2) energy of every chain by the model's plain torch ops
    (``_energies``: 256 rows a pass, ~1.7e7 pair terms a chain batch): the
    gates' recompute, which never runs the LJ energy kernel that the LJ
    refresh runs on the card."""
    return mod._energies(st, params, 256, 2 ** 24)


def lj_cache_check(st, out, what):
    """The kernel's cached energies against an O(N^2) recompute, positions
    in [0, box), species composition conserved."""
    import torch
    from montecarlo_tpu_torch.models import lennard_jones as lj
    pos, spc, e = out[:3]
    new = dataclasses.replace(st, pos=pos, species=spc, energy=e)
    full = plain_energy(lj, lj.LJParams(), new)
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
    ("N no multiple of 32", 3, 100, 256, 0.2),
    ("N < 32", 1, 20, 256, 0.2),
    ("sixteen warps, N no multiple of 512", 4, 4608 + 40, 256, 0.2),
    ("gridded, blocks of 256", 300, 128, 256, 0.2),
    ("gridded, blocks of 8", 20, 128, 8, 0.2),
    ("mono-species", 32, 128, 256, 0.0),
    ("mono-species, two warps", 8, 200, 256, 0.0),
)


def lj_kernels_vs_plain(device, parent=None):
    """Phase 4a.  Returns the largest |kernel - plain| per kernel (required
    0.0: bit-equal).  With ``parent`` (the earlier kernels), every case must
    also equal the earlier kernels bit for bit."""
    import torch
    from montecarlo_tpu_torch.ops.lj_sweep import block_warps
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
                  f"W={block_warps(n)} warps, block_chains={bc}, "
                  f"t0={LJ_T0}, n={LJ_STEPS}): "
                  f"{int(same.sum())}/{m} chains bit-equal, "
                  f"{int(flip.sum())} with an accept flip, max |diff| "
                  f"{err!r} on the rest, attempts equal {tot_equal}, "
                  f"max |E - E(N^2)| {cache!r}, acceptance {rates}")
            check(tot_equal, f"{name} {label}: attempt counts differ")
            check(int(flip.sum()) == 0,
                  f"{name} {label}: {int(flip.sum())} of {m} chains flip")
            check(err == 0.0 and bool(same.all()),
                  f"{name} {label}: kernel vs plain {err}, "
                  f"{int(same.sum())}/{m} chains bit-equal")
            if parent is not None:
                old = parent.lj(st, LJ_STEPS, mixed, LJ_T0, bc)
                eq = all(torch.equal(a, b) for a, b in zip(ker, old)
                         if a is not None)
                print(f"LJ kernel vs earlier kernel: {name}, {label}: "
                      f"bit-equal {eq} (W={block_warps(n)})")
                check(eq, f"{name} {label}: differs from the earlier "
                          f"kernel")
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
                          (True, (POOL5["chains"], POOL5["n"])),
                          (False, (3, 100)), (True, (3, 100)),
                          (True, (4, 4608 + 40))):
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


def lj_dense(m, n, device, seed):
    """Chains of the ka2d cell's mixture (rho 1.2, A65 B35, T 0.45), moved
    off the lattice by one mixed sweep of the particles."""
    from montecarlo_tpu_torch.models import lennard_jones as lj
    from montecarlo_tpu_torch.ops.lj_sweep import fused_lj_mixed_sweep
    st = lj.init_chains(m, n, 1.2, 1 / 0.45, frac_b=0.35, seed=seed,
                        device=device)
    pos, spc, e, _, _ = fused_lj_mixed_sweep(
        st.pos, st.species, st.beta, st.energy, float(st.box[0]), 0.08, 0.8,
        seed, 0, n, params=lj.LJParams())
    return dataclasses.replace(st, pos=pos, species=spc, energy=e)


def lj_pairs_inside(st, params, rows=64):
    """Ordered pairs ``i != j`` within their pair's cutoff ``rcut sig``
    (the terms that add more than the geometry), summed over the chains."""
    import torch
    pos, spc, box = st.pos, st.species, st.box
    n = pos.shape[1]
    cols = torch.arange(n, device=pos.device)
    inside = 0
    for start in range(0, n, rows):
        idx = cols[start:start + rows]
        d = pos[:, None, :, :] - pos[:, idx, None, :]
        b = box[:, None, None, None]
        d = d - b * torch.round(d / b)
        r2 = torch.sum(d * d, dim=-1)
        _, sig = params.coeffs(spc[:, idx, None], spc[:, None, :])
        near = (r2 < (params.rcut * sig) ** 2) & (idx[:, None] != cols)
        inside += int(near.sum())
    return inside


def lj_energy_vs_plain(device, card):
    """Phase 4c.  The LJ energy kernel (``ops/lj_energy.py``) on the card
    against the plain ``total_energy`` at each of LJ_ENERGY_CASES: within
    LJ_ENERGY_RTOL of the float64 energy a chain, bit-equal from call to
    call and for a chain called alone, one launch a call; at the ka2d
    cell's shape timed beside the plain float32 ``total_energy`` at 64
    rows a pass (the refresh's plain path) and beside its bound by
    operations.  Returns the kernels row's figures."""
    import torch
    from montecarlo_tpu_torch.models import lennard_jones as lj
    from montecarlo_tpu_torch.ops.lj_energy import (LJ_ENERGY_KERNEL,
                                                    lj_total_energy)
    params = lj.LJParams()
    out = {"err": 0.0, "rel64": 0.0}
    for label, m, n in LJ_ENERGY_CASES:
        st = lj_dense(m, n, device, seed=SEED + m + n)
        before = LJ_ENERGY_KERNEL.launches
        got = lj_total_energy(st.pos, st.species, st.box, params)
        check(LJ_ENERGY_KERNEL.launches == before + 1,
              f"4c {label}: {LJ_ENERGY_KERNEL.launches - before} launches "
              f"for one call")
        wide = dataclasses.replace(st, pos=st.pos.double(),
                                   box=st.box.double())
        want = plain_energy(lj, params, wide)
        plain = plain_energy(lj, params, st)
        rel = float(((got.double() - want).abs() / want.abs()).max())
        err = float((got - plain).abs().max())
        again = lj_total_energy(st.pos, st.species, st.box, params)
        alone = lj_total_energy(st.pos[-1:], st.species[-1:], st.box[-1:],
                                params)
        print(f"4c: lj_total_energy {label} (M {m}, N {n}): max relative "
              f"gap to the float64 energy {rel!r}, max |kernel - plain "
              f"float32| {err!r}, energy per particle "
              f"{float(got.mean()) / n!r}")
        check(bool(torch.isfinite(got).all()) and rel <= LJ_ENERGY_RTOL,
              f"4c {label}: {rel} off the float64 energy")
        check(torch.equal(again, got) and torch.equal(alone, got[-1:]),
              f"4c {label}: the kernel's bits moved between calls")
        out["err"] = max(out["err"], err)
        out["rel64"] = max(out["rel64"], rel)
        if (m, n) == LJ_ENERGY_CASES[0][1:]:
            pairs = m * n * (n - 1)
            inside = lj_pairs_inside(st, params)
            k_ms = cuda_time(
                lambda: lj_total_energy(st.pos, st.species, st.box, params),
                50)
            p_ms = cuda_time(
                lambda: lj.total_energy(st, params, row_batch=64), 5)
            b_ms, by = bound(m * (12 * n + 8),
                             pairs * LJ_ENERGY_OPS_PER_TERM
                             + inside * LJ_ENERGY_OPS_INSIDE)
            out.update(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=by,
                       shape=[m, n])
            print(f"bound: lj_total_energy at M {m} x N {n}: {pairs} pair "
                  f"terms, {inside} inside the cutoff "
                  f"({100 * inside / pairs!r} %); {k_ms!r} ms a call against "
                  f"a bound of {b_ms!r} ms (by {by}, "
                  f"{LJ_ENERGY_OPS_PER_TERM} operations a term and "
                  f"{LJ_ENERGY_OPS_INSIDE} more inside, at "
                  f"{LANE_INSTR_PER_S!r} a second): {100 * b_ms / k_ms!r} % "
                  f"of the bound's rate; plain total_energy (row_batch 64) "
                  f"{p_ms!r} ms [{card}]")
    return out


def lj_main(tmc, device, path, cfg, mixed):
    """Config 4 (one displacement move) or the config-5 pool (displacement
    + swap, with StoreLastFrames) through ``Simulation.run`` on CUDA.
    Returns (simulation, wall seconds)."""
    sim = lj_sim(tmc, device, path, cfg, mixed)
    check(sim.device_algos[0].supports_fused,
          "the LJ pool is not fused on CUDA")
    t0 = time.perf_counter()
    sim.run()
    return sim, time.perf_counter() - t0


def lj_sim(tmc, device, path, cfg, mixed, mesh=None, fused="auto"):
    """The Simulation of :func:`lj_main`."""
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
        dict(algorithm=tmc.Metropolis, pool=pool, seed=42, sweepstep=n,
             fused=fused),
        dict(algorithm=tmc.StoreCallbacks,
             callbacks=(lj.callback_energy_per_particle,
                        tmc.callback_acceptance), scheduler=sched)]
    if mixed:
        algos.append(dict(algorithm=tmc.StoreLastFrames,
                          scheduler=np.asarray([sweeps])))
    return tmc.Simulation(
        lj.make_system(),
        lj.init_chains(m, n, 0.7, 1.0, frac_b=0.2, seed=42, device=device),
        algos, sweeps, path=path, mesh=mesh)


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


def unset(t):
    """An output buffer like ``t`` that equals no result: NaN, or -1 for
    integers, so a kernel that writes nothing never compares equal."""
    import torch
    return torch.full_like(t, float("nan") if t.is_floating_point() else -1)


class EarlierKernels:
    """The kernels of an earlier ``csrc/`` with commit e6e7854's interface
    (a lane count for the Gaussian kernel, a warp count for the LJ kernels,
    one warp per polydisperse chain), built from ``csrc_dir`` with the
    package's nvcc flags, for comparing and timing in the same call."""

    _PTR = ctypes.c_void_p
    _RUN = [ctypes.c_uint32, ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p]
    _ARGTYPES = {
        "mc_fused_gaussian_sweep": [_PTR] * 6 + [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_uint32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p],
        "mc_lj_sweep": [_PTR] * 8 + [ctypes.c_int64, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int64] + _RUN,
        "mc_lj_mixed_sweep": [_PTR] * 10 + [ctypes.c_int64, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_int64]
        + _RUN,
        "mc_poly_mixed_sweep": [_PTR] * 10 + [ctypes.c_int64, ctypes.c_int,
                                              ctypes.c_int64] + _RUN,
    }

    def __init__(self, csrc_dir, build_dir):
        from montecarlo_tpu_torch.ops._cuda import NVCC_FLAGS, _nvcc
        sources = {"fused_sweep": ("mc_fused_gaussian_sweep",),
                   "lj_sweep": ("mc_lj_sweep", "mc_lj_mixed_sweep"),
                   "poly_sweep": ("mc_poly_mixed_sweep",)}
        procs = {}
        for stem in sources:
            out = os.path.join(build_dir, f"earlier_{stem}.so")
            procs[stem] = (out, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", out,
                 os.path.join(csrc_dir, stem + ".cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        self.fn = {}
        for stem, (out, proc) in procs.items():
            log, _ = proc.communicate()
            check(proc.returncode == 0, f"nvcc failed on the earlier "
                                        f"{stem}.cu:\n{log}")
            lib = ctypes.CDLL(out)
            for symbol in sources[stem]:
                fn = getattr(lib, symbol)
                fn.argtypes, fn.restype = self._ARGTYPES[symbol], ctypes.c_int
                self.fn[symbol] = fn
        print(f"build: the earlier kernels from {csrc_dir}")

    def gaussian(self, x, beta, sigma, t0, n, pot):
        import torch
        from montecarlo_tpu_torch.ops import fused_sweep as fs
        kind, a2, h, a4 = fs.kernel_potential(pot)
        xo, eo = unset(x), unset(x)
        acc = unset(torch.empty(x.shape, dtype=torch.int32, device=x.device))
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        err = self.fn["mc_fused_gaussian_sweep"](
            x.data_ptr(), beta.data_ptr(), sigma.data_ptr(), xo.data_ptr(),
            eo.data_ptr(), acc.data_ptr(), x.numel(),
            fs._block_chains(x.numel(), 2048), SEED, t0, n,
            fs.group_lanes(x.numel(), sms), kind, a2, h, a4,
            torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"the earlier Gaussian kernel: cudaError {err}")
        return xo, eo, acc

    def lj(self, st, n_steps, mixed, t0, block_chains=256,
           w_disp=POOL5["w_disp"]):
        """As ``lj_call``: (pos, species, energy, acc, tot)."""
        import torch
        from montecarlo_tpu_torch.models import lennard_jones as lj
        from montecarlo_tpu_torch.ops import lj_sweep as ops
        m, n, _ = st.pos.shape
        tab = ops._table(lj.LJParams(), host_box(st),
                         card_scalar(LJ_SIGMA, st.pos.device),
                         w_disp if mixed else 1.0, st.pos.device)
        pos, e = unset(st.pos), unset(st.energy)
        acc = unset(torch.empty((m, 2) if mixed else (m,), dtype=torch.int32,
                                device=st.pos.device))
        spc, tot = unset(st.species), unset(acc)
        outs = ([pos, spc, e, acc, tot] if mixed else [pos, e, acc])
        err = self.fn["mc_lj_mixed_sweep" if mixed else "mc_lj_sweep"](
            st.pos.data_ptr(), st.species.data_ptr(), st.beta.data_ptr(),
            st.energy.data_ptr(), tab.data_ptr(),
            *(t.data_ptr() for t in outs), m, n, ops.block_warps(n),
            min(block_chains, max(8, m)), SEED, t0, n_steps,
            torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"the earlier LJ kernel: cudaError {err}")
        return (pos, spc, e, acc, tot) if mixed else (
            pos, st.species, e, acc, None)

    def poly(self, st, n_steps, t0, block_chains=256):
        """As ``poly_call``: (pos, diam, energy, accepted, attempted)."""
        import torch
        from montecarlo_tpu_torch.models import polydisperse as poly
        from montecarlo_tpu_torch.ops import lj_sweep, poly_sweep
        m, n, _ = st.pos.shape
        tab = lj_sweep._table(poly.PolyParams(), host_box(st),
                              card_scalar(POLY["sigma"], st.pos.device),
                              POLY["w_disp"], st.pos.device,
                              build=poly_sweep._poly_scalars)
        counts = torch.empty((m, 2), dtype=torch.int32, device=st.pos.device)
        out = (unset(st.pos), unset(st.diam), unset(st.energy), unset(counts),
               unset(counts))
        err = self.fn["mc_poly_mixed_sweep"](
            st.pos.data_ptr(), st.diam.data_ptr(), st.beta.data_ptr(),
            st.energy.data_ptr(), tab.data_ptr(),
            *(t.data_ptr() for t in out), m, n, min(block_chains, max(8, m)),
            SEED, t0, n_steps, torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"the earlier poly kernel: cudaError {err}")
        return out


def earlier_vs_present(parent, device, card):
    """With ``--parent``: each redesigned kernel and its earlier version at
    the main paths' shapes and segments, timed in one call in turns
    (earlier, present, present, earlier), by CUDA events."""
    from montecarlo_tpu_torch.models import particle1d as p1d
    from montecarlo_tpu_torch.ops.fused_sweep import fused_gaussian_sweep
    rng = np.random.default_rng(SEED + 4)
    cases = []
    for m in SIZES:
        x, beta, sigma = inputs(m, device, rng)
        cases.append((
            f"fused_gaussian_sweep M={m} n_steps={LONG_STEPS}",
            lambda x=x, beta=beta, sigma=sigma: parent.gaussian(
                x, beta, sigma, 0, LONG_STEPS, p1d.harmonic),
            lambda x=x, beta=beta, sigma=sigma: fused_gaussian_sweep(
                x, beta, sigma, SEED, 0, LONG_STEPS, potential=p1d.harmonic)))
    for mixed, cfg in ((False, CONFIG4), (True, POOL5)):
        m, n = cfg["chains"], cfg["n"]
        st = lj_inputs(m, n, device, SEED + 30)
        name = "fused_lj_mixed_sweep" if mixed else "fused_lj_sweep"
        cases.append((
            f"{name} M={m} N={n} n_steps={10 * n}",
            lambda st=st, mixed=mixed, n=n: parent.lj(st, 10 * n, mixed, 0),
            lambda st=st, mixed=mixed, n=n: lj_call(st, 10 * n, mixed, t0=0)))
    for n in (POLY["n"], 1024):
        st = poly_inputs(POLY["chains"], n, device, SEED + 60)
        cases.append((
            f"fused_poly_mixed_sweep M={POLY['chains']} N={n} "
            f"n_steps={POLY['stride'] * n}",
            lambda st=st, n=n: parent.poly(st, POLY["stride"] * n, 0),
            lambda st=st, n=n: poly_call(st, POLY["stride"] * n, t0=0)))
    for label, old, new in cases:
        ms = [cuda_time(fn, 3) for fn in (old, new, new, old)]
        print(f"time: earlier vs present {label}: earlier {ms[0]!r} ms, "
              f"present {ms[1]!r} ms, present {ms[2]!r} ms, earlier "
              f"{ms[3]!r} ms per call: {(ms[0] + ms[3]) / (ms[1] + ms[2])!r} "
              f"times faster [{card}]")


def lj_times(device, card):
    """Phase 6b: each LJ kernel at its main path's shape, LJ_TIME_STEPS steps
    per call and the main path's segment; its plain version at the segment
    (one call, seconds long); the attempts of the timed segment for the
    bound."""
    out = {}
    for mixed, cfg in ((False, CONFIG4), (True, POOL5)):
        m, n = cfg["chains"], cfg["n"]
        name = "fused_lj_mixed_sweep" if mixed else "fused_lj_sweep"
        st = lj_inputs(m, n, device, SEED + 30)
        for label, interp, steps, reps in (
                ("kernel", False, LJ_TIME_STEPS, 5),
                ("kernel", False, 10 * n, 3),
                ("plain", True, 10 * n, 1)):
            ms = cuda_time(lambda: lj_call(st, steps, mixed, t0=0,
                                           interpret=interp), reps,
                           warm=not interp)
            rate = m * steps / (ms / 1e3)
            print(f"time: {label} {name} M={m} N={n} n_steps={steps}: "
                  f"{ms!r} ms per call, {rate!r} moves/s [{card}]")
            out.setdefault(name, {})[(label, steps)] = ms
        tot = lj_call(st, 10 * n, mixed, t0=0)[4]
        out[name]["attempts"] = ((m * 10 * n, 0) if tot is None
                                 else tuple(int(v) for v in tot.sum(0)))
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
        st.pos, st.diam, st.beta, st.energy, host_box(st),
        card_scalar(POLY["sigma"], st.pos.device),
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
    ("N < 32", 16, 20, 256),
    ("N no multiple of 32", 12, 100, 8),
    ("sixteen warps, N no multiple of 512", 4, 4608 + 40, 256),
)


def poly_kernel_vs_plain(device, parent=None):
    """Phase 4b.  Returns the largest |kernel - plain| (required 0.0).  With
    ``parent`` (the earlier kernels, one warp per chain), the cases whose
    block is one warp must also equal the earlier kernel bit for bit: the
    sum order is the same there."""
    import torch
    from montecarlo_tpu_torch.ops.poly_sweep import poly_block_warps
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
              f"W={poly_block_warps(n)} warps, "
              f"block_chains={bc}, t0={POLY_T0}, n={POLY_STEPS}): "
              f"bit-equal {same}, {int(flip.sum())} chains with an accept "
              f"flip, max |diff| {err!r}, attempts equal "
              f"{torch.equal(tk, tp)}, max |E - E(N^2)| {cache!r}, "
              f"acceptance {rates}")
        check(torch.equal(tk, tp), f"poly {label}: attempt counts differ")
        check(int(flip.sum()) == 0, f"poly {label}: {int(flip.sum())} flips")
        check(err == 0.0 and same, f"poly {label}: kernel vs plain {err}")
        check(int(ak[:, 1].sum()) > 0, f"poly {label}: no swap accepted")
        if parent is not None:
            old = parent.poly(st, POLY_STEPS, POLY_T0, bc)
            eq = all(torch.equal(a, b) for a, b in zip(ker, old))
            print(f"poly kernel vs earlier kernel: {label}: bit-equal {eq} "
                  f"(W={poly_block_warps(n)})")
            check(eq or poly_block_warps(n) > 1,
                  f"poly {label}: one warp differs from the earlier kernel")
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
    sim, chains = poly_path_sim(tmc, device, path)
    check(sim.device_algos[0].supports_fused,
          "the poly pool is not fused on CUDA")
    t0 = time.perf_counter()
    sim.run()
    return sim, chains, time.perf_counter() - t0


def poly_path_sim(tmc, device, path, mesh=None):
    """The Simulation of :func:`poly_main` and its initial chains."""
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
    ], sweeps, path=path, mesh=mesh)
    return sim, chains


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
    LJ_TIME_STEPS steps, the plain version per segment (one call), and the
    attempts of the timed segment for the bound."""
    m, n = POLY["chains"], POLY["n"]
    st = poly_inputs(m, n, device, SEED + 60)
    out = {}
    for label, interp, steps, reps in (
            ("kernel", False, LJ_TIME_STEPS, 5),
            ("kernel", False, POLY["stride"] * n, 3),
            ("plain", True, POLY["stride"] * n, 1)):
        ms = cuda_time(lambda: poly_call(st, steps, t0=0, interpret=interp),
                       reps, warm=not interp)
        rate = m * steps / (ms / 1e3)
        print(f"time: {label} fused_poly_mixed_sweep M={m} N={n} "
              f"n_steps={steps}: {ms!r} ms per call, {rate!r} moves/s "
              f"[{card}]")
        out[(label, steps)] = ms
    out["attempts"] = tuple(int(v) for v in poly_call(
        st, POLY["stride"] * n, t0=0)[4].sum(0))
    from montecarlo_tpu_torch.models import polydisperse as poly
    refresh = poly.make_system().refresh
    out["refresh"] = cuda_time(lambda: refresh(st), 5)
    print(f"time: poly refresh (O(N^2) cache check) M={m} N={n}: "
          f"{out['refresh']!r} ms per call [{card}]")
    poly_warp_times(device, card)
    return out


def poly_warp_times(device, card, sizes=(POLY["n"], 1024)):
    """Phase 6c: the poly kernel with every block width W at 64 chains of
    each N in ``sizes`` (the main path's and N 1024), one main-path segment
    (10 N steps) per call, the Ws in turns and then in reverse, for
    ``poly_block_warps``' rule."""
    import torch
    from montecarlo_tpu_torch.models import polydisperse as poly
    from montecarlo_tpu_torch.ops import lj_sweep, poly_sweep
    for n in sizes:
        st = poly_inputs(POLY["chains"], n, device, SEED + 60)
        tab = lj_sweep._table(poly.PolyParams(), host_box(st),
                              card_scalar(POLY["sigma"], device),
                              POLY["w_disp"], device,
                              build=poly_sweep._poly_scalars)
        steps = POLY["stride"] * n
        ms = {}
        order = (1, 2, 4, 8, 16)
        for w in order + order[::-1]:
            ms.setdefault(w, []).append(cuda_time(
                lambda w=w: lj_sweep._cuda_sweep(
                    poly_sweep.POLY_KERNEL, True, st.pos, st.diam, st.beta,
                    st.energy, tab, SEED, 0, steps, 256, w,
                    attr=("diam", torch.float32)), 3))
        best = min(ms, key=lambda w: sum(ms[w]))
        print(f"time: poly kernel by block width, M={POLY['chains']} N={n} "
              f"n_steps={steps}: " + ", ".join(
                  f"W {w}: {v[0]!r} / {v[1]!r} ms" for w, v in ms.items())
              + f"; fastest W {best}, the rule's W "
              f"{poly_sweep.poly_block_warps(n)} [{card}]")


class Interrupt(Exception):
    """Raised by :class:`StopAt` to cut a run short."""


def counted(kernels, fn):
    """Run ``fn`` with every launch count set to 0 just before; returns its
    result and the counts read just after."""
    for k in kernels:
        k.launches = 0
    out = fn()
    return out, {k.symbol: k.launches for k in kernels}


def pgmc5_sim(tmc, device, path, adaptive=True, extra=(), mesh=None):
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
        algos, sweeps, path=path, mesh=mesh)


def timed_run(sim):
    """Wall seconds of ``sim.run()``, from an idle card to an idle card."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run()
    torch.cuda.synchronize()
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
    full = plain_energy(lj, lj.LJParams(), st)
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
        # a span's shadow on the card's rows (the program's mc. spans) is
        # no kernel
        if evt.device_type != torch.autograd.DeviceType.CUDA \
                or getattr(evt, "is_user_annotation", False):
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
    keys = resumed.device_state["pge"]["keys"]
    check(resumed.t == cut and keys.dtype == torch.uint32
          and keys.device.type == device.type,
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


def pgmc_pool_sim(tmc, device, path, kind):
    """Phase 5g: the poly pool (``kind`` "poly") or the one-move LJ pool
    ("lj") at its main path's width with VPG on the displacement sigma
    through the hybrid stepper, energy per particle, acceptance and
    parameters every ``stride`` sweeps."""
    from montecarlo_tpu_torch import policy_guided as pg
    from montecarlo_tpu_torch.models import lennard_jones as lj
    from montecarlo_tpu_torch.models import polydisperse as poly
    cfg = PGMC_POOLS
    m, n = cfg[kind]
    sweeps = cfg["sweeps"]
    if kind == "poly":
        model = poly
        params = poly.PolyParams()
        pool = (poly.displacement_move(POLY["sigma"], weight=POLY["w_disp"],
                                       params=params),
                poly.swap_move(weight=1.0 - POLY["w_disp"], params=params))
        chains = poly.init_chains(m, n, rho=POLY["rho"], beta=POLY["beta"],
                                  seed=42, params=params, device=device)
        system = poly.make_system(params)
        optimisers = (pg.VPG(cfg["eta"]), pg.Static())
    else:
        model = lj
        pool = (lj.lj_displacement_move(sigma=LJ_SIGMA),)
        chains = lj.init_chains(m, n, 0.7, 1.0, frac_b=0.2, seed=42,
                                device=device)
        system = lj.make_system()
        optimisers = (pg.VPG(cfg["eta"]),)
    sched = np.arange(cfg["stride"], sweeps + 1, cfg["stride"])
    return tmc.Simulation(system, chains, [
        dict(algorithm=tmc.Metropolis, pool=pool, seed=42, sweepstep=n),
        dict(algorithm=pg.PolicyGradientEstimator,
             dependencies=(tmc.Metropolis,), optimisers=optimisers,
             q_batch_size=cfg["q"],
             scheduler=np.arange(cfg["est_every"], sweeps + 1,
                                 cfg["est_every"])),
        dict(algorithm=pg.PolicyGradientUpdate,
             dependencies=(pg.PolicyGradientEstimator,),
             scheduler=np.arange(cfg["upd_every"], sweeps + 1,
                                 cfg["upd_every"])),
        dict(algorithm=tmc.StoreCallbacks,
             callbacks=(model.callback_energy_per_particle,
                        tmc.callback_acceptance), scheduler=sched),
        dict(algorithm=tmc.StoreParameters, dependencies=(tmc.Metropolis,),
             scheduler=sched)], sweeps, path=path)


def pgmc_pool_checks(sim, kind, path, wall, card):
    """Phase 5g checks, made after the launch counts were read: sigma
    adapted, on the card and equal to the last ``parameters.dat`` row;
    attempts per chain; acceptance; the cache against an O(N^2) recompute
    within the reference's bounds; for poly, each chain's diameters."""
    import torch
    from montecarlo_tpu_torch.models import lennard_jones as lj
    from montecarlo_tpu_torch.models import polydisperse as poly
    cfg = PGMC_POOLS
    m, n = cfg[kind]
    sweeps = cfg["sweeps"]
    label = f"{kind} pool with PGMC"
    st = sim.device_state["sys"]
    sigma = sim.device_state["params"][0]["sigma"]
    with open(os.path.join(path, "parameters", "1", "parameters.dat")) as f:
        rows = f.read().splitlines()
    last_t, last = rows[-1].split(" ", 1)
    cnt = sim.device_state["metropolis"]["counters"]
    tot = cnt.sum(0).double()
    rates = (tot[:, 0] / tot[:, 1]).tolist()
    model, params, bounds = ((poly, poly.PolyParams(), POLY_CACHE)
                             if kind == "poly"
                             else (lj, lj.LJParams(), LJ_CACHE))
    full = plain_energy(model, params, st)
    err = float(((st.energy - full).abs() - bounds["rtol"] * full.abs())
                .max())
    moves = m * n * sweeps
    s = float(sigma)
    print(f"{label}: {m} chains x N {n} x {sweeps} sweeps ({moves} moves) in "
          f"{wall!r} s wall ({moves / wall!r} moves/s with recorders and "
          f"PGMC), sigma {LJ_SIGMA} -> {s!r} (parameters.dat last row "
          f"t={last_t} {last}), acceptance per move {rates}, max "
          f"|E - E(N^2)| {float((st.energy - full).abs().max())!r} [{card}]")
    check(np.isfinite(s) and s > 0 and s != np.float32(LJ_SIGMA),
          f"{label}: sigma did not adapt ({s})")
    check(sigma.device == st.pos.device, f"{label}: sigma left the card")
    check(int(last_t) == sweeps and last == f"[{s!r}]",
          f"{label}: device sigma {s!r} != parameters.dat {rows[-1]}")
    check(bool((cnt[..., 1].sum(1) == sweeps * n).all()),
          f"{label}: attempts per chain != sweeps x N")
    check(all(0.01 < r < 0.98 for r in rates), f"{label}: acceptance {rates}")
    check(bool(torch.isfinite(st.energy).all()) and err <= bounds["atol"],
          f"{label}: cached energy off the O(N^2) energy ({err})")
    if kind == "poly":
        check(torch.equal(st.diam.sort(1).values,
                          sim.chains0.diam.sort(1).values)
              and not torch.equal(st.diam, sim.chains0.diam),
              f"{label}: diameters not conserved, or none swapped")


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
        interpret=True), 1, warm=False)
    rate = m * CONFIG2_STRIDE / (ms / 1e3)
    print(f"time: plain sweep M={m} n_steps={CONFIG2_STRIDE}: {ms!r} ms per "
          f"call, {rate!r} steps/s [{card}]")
    out[("plain_main", m)] = (ms, CONFIG2_STRIDE, rate)
    return out


def cell_main(tmc, device, path, card):
    """Phase 7a: ``examples/cell_mc_large_n.py``'s LJ run at full width
    through ``Simulation.run`` with ``fused='auto'`` and no ``device=``:
    the cell route, on the card, its cache against an O(N^2) recompute;
    then a segment and a refresh of the run timed apart by CUDA events."""
    import torch
    from montecarlo_tpu_torch.models import lennard_jones as lj
    cfg = CELL_MAIN
    m, n, steps, every = cfg["chains"], cfg["n"], cfg["steps"], cfg["every"]
    chains = lj.init_chains(m, n, rho=cfg["rho"], beta=cfg["beta"],
                            frac_b=cfg["frac_b"], seed=42)
    sim = tmc.Simulation(lj.make_system(), chains, [
        dict(algorithm=tmc.Metropolis,
             pool=(lj.lj_displacement_move(cfg["sigma"]),), seed=7,
             sweepstep=n // 4, fused="auto"),
        dict(algorithm=tmc.StoreCallbacks,
             callbacks=(lj.callback_energy_per_particle,
                        tmc.callback_acceptance),
             scheduler=np.arange(every, steps + 1, every))], steps,
        path=path)
    met = sim.device_algos[0]
    check(met._use_cell and met.supports_fused,
          "the large-N LJ run did not take the cell path under 'auto'")
    print(f"cell main path: N {n} x {m} chains, plan {met._cell_plan!r}")
    torch.cuda.synchronize()
    wall = timed_run(sim)
    return sim, wall


def cell_main_checks(sim, path, wall, card):
    import torch
    from montecarlo_tpu_torch.models import lennard_jones as lj
    cfg = CELL_MAIN
    m, n, steps, every = cfg["chains"], cfg["n"], cfg["steps"], cfg["every"]
    met = sim.device_algos[0]
    slc = sim.device_state["metropolis"]
    st = sim.device_state["sys"]
    cnt = slc["counters"]
    att = int(cnt[..., 1].sum())
    rate = float(cnt[..., 0].sum()) / att
    # the run's parts timed apart: a segment of `every` steps and a refresh
    # (the run ends on a refresh, so the cache is checked one segment on)
    ds = sim.device_state
    seg_ms = cuda_time(lambda: met.fused_advance(ds, every), 2, warm=False)
    ref_ms = cuda_time(lambda: sim.system.refresh(ds["sys"]), 2, warm=False)
    st4 = _first(met.fused_advance(ds, every)["sys"], 4)
    full = lj.total_energy(st4, lj.LJParams(), row_batch=256)
    err = float(((st4.energy - full).abs()
                 - LJ_CACHE["rtol"] * full.abs()).max())
    with open(os.path.join(path, "summary.log")) as f:
        summary = f.read()
    e = np.loadtxt(os.path.join(path, "energy_per_particle.dat"))
    print(f"cell main path: {att} attempts ({att / m!r} a chain, requested "
          f"{steps * n // 4}) in {wall!r} s wall ({att / wall!r} moves/s "
          f"with recorders), acceptance {rate!r}, state on "
          f"{st.pos.device.type}, overflow {bool(slc['cell_overflow'])}, "
          f"energy per particle {float(e[0, 1])!r} -> {float(e[-1, 1])!r}, "
          f"max |E - E(N^2)| over 4 chains one segment on "
          f"{float((st4.energy - full).abs().max())!r} [{card}]")
    check(st.pos.device.type == "cuda",
          "the cell path's chains are not on the card")
    check(not bool(slc["cell_overflow"]), "the cell path overflowed")
    check(0.05 < rate < 0.98, f"cell main path acceptance {rate}")
    check(bool(torch.isfinite(st.energy).all()) and err <= LJ_CACHE["atol"],
          f"cell main path cached energy off the O(N^2) energy ({err})")
    check(f"Cell MC: enabled ({met._cell_plan!r})" in summary,
          "summary.log lacks the Cell MC: enabled line")
    check(e.shape == (steps // every + 1, 2) and np.all(np.isfinite(e[:, 1])),
          "cell main path energy_per_particle.dat")
    per = met._cell_plan.nc ** 2 // 4
    check(abs(att / m - steps * n // 4) <= per,
          "cell main path: attempts off the requested count by more than "
          "one substep")
    n_seg = steps // every
    print(f"time: cell main path breakdown: {n_seg} segments x {seg_ms!r} ms "
          f"= {n_seg * seg_ms / 1e3!r} s, {n_seg} refreshes (O(N^2), "
          f"row-batched) x {ref_ms!r} ms = {n_seg * ref_ms / 1e3!r} s, of "
          f"{wall!r} s wall; the rest {wall - n_seg * (seg_ms + ref_ms) / 1e3!r}"
          f" s is the host: start-up, recorders [{card}]")


def cell_routes(tmc, root, card):
    """Phase 7b: the LJ species pool and the poly pair pool at N 4096 x 64
    with ``fused='cell'``, hard disks at N 16384 x 16, about a sweep each:
    composition conserved, caches within bounds, hard disks overlap-free."""
    import torch
    from montecarlo_tpu_torch.models import hard_disks as hd
    from montecarlo_tpu_torch.models import lennard_jones as lj
    from montecarlo_tpu_torch.models import polydisperse as poly
    cfg = CELL_POOLS
    m, n, wd = cfg["chains"], cfg["n"], cfg["w_disp"]
    runs = {
        "LJ species pool": (
            lj, lj.init_chains(m, n, rho=1.2, beta=1.0 / 0.45, frac_b=0.2,
                               seed=43),
            (lj.lj_displacement_move(0.08, weight=wd),
             lj.lj_swap_move(weight=1.0 - wd)), n, cfg["sweeps"], LJ_CACHE),
        "poly pair pool": (
            poly, poly.init_chains(m, n, rho=POLY["rho"], beta=POLY["beta"],
                                   seed=44),
            (poly.displacement_move(POLY["sigma"], weight=wd),
             poly.swap_move(weight=1.0 - wd)), n, cfg["sweeps"], POLY_CACHE),
        "hard disks": (
            hd, hd.init_chains(CELL_HD["chains"], CELL_HD["n"],
                               eta=CELL_HD["eta"], seed=45),
            (hd.displacement_move(CELL_HD["delta"]),), CELL_HD["n"],
            CELL_HD["sweeps"], None)}
    for label, (mod, chains, pool, sweep, sweeps, bounds) in runs.items():
        sim = tmc.Simulation(mod.make_system(), chains, [
            dict(algorithm=tmc.Metropolis, pool=pool, seed=9,
                 sweepstep=sweep, fused="cell")], sweeps,
            path=os.path.join(root, label.replace(" ", "_")))
        met = sim.device_algos[0]
        torch.cuda.synchronize()
        wall = timed_run(sim)
        slc = sim.device_state["metropolis"]
        # the run ends on a refresh: check the state one segment on
        st = met.fused_advance(sim.device_state, 1)["sys"]
        cnt = slc["counters"].sum(0).double()
        rates = (cnt[:, 0] / cnt[:, 1]).tolist()
        st4 = _first(st, 4)
        line = (f"cell route: {label}, {chains.pos.shape[0]} chains x N "
                f"{chains.pos.shape[1]}, plan {met._cell_plan!r}, "
                f"{int(cnt[:, 1].sum())} attempts in {wall!r} s wall, "
                f"acceptance per move {rates}")
        check(met._use_cell and not bool(slc["cell_overflow"]),
              f"{label}: not on the cell path, or overflowed")
        check(st.pos.device.type == "cuda",
              f"{label}: chains not on the card")
        check(all(0.01 < r < 0.99 for r in rates), f"{label}: acceptance "
              f"{rates}")
        if bounds is None:
            # float32 positions resolve a distance only to about their
            # spacing at the box edge (1.5e-5 at this box of 135.6: a
            # position is frac * box rounded), finer than overlap_free's
            # default 1e-5 can ask: the gate is two spacings
            tol = max(1e-5, 2 * float(np.spacing(np.float32(host_box(st4)))))
            dmin = hd.min_pair_distance(st4)
            print(f"{line}; min pair distance over 4 chains "
                  f"{float(dmin.min())!r} (gate 1 - {tol!r}) [{card}]")
            check(bool(hd.overlap_free(st4, tol=tol).all()),
                  "hard disks overlap after the cell path")
            continue
        if mod is lj:
            full = lj.total_energy(st4, lj.LJParams(), row_batch=256)
            kept = torch.equal(st.species.sum(1), chains.species.sum(1))
        else:
            full = poly.total_energy(st4, poly.PolyParams(), row_batch=256)
            kept = torch.equal(torch.sort(st.diam, 1).values,
                               torch.sort(chains.diam, 1).values)
        err = float(((st4.energy - full).abs() - bounds["rtol"]
                     * full.abs()).max())
        print(f"{line}; composition kept {kept}, max |E - E(N^2)| over 4 "
              f"chains {float((st4.energy - full).abs().max())!r} [{card}]")
        check(kept, f"{label}: composition changed")
        check(err <= bounds["atol"], f"{label}: cached energy off ({err})")


def crossover(tmc, device, card):
    """Phase 7c: the LJ displacement row kernel (#2) against the cell path
    at 64 chains (and at 32), rho 1.2, sigma 0.08, one sweep a call,
    N 2048 to 19114, by CUDA events, two passes in turns (row, cell, cell,
    row); at 64 chains the cell path's launches per substep under
    ``torch.profiler`` and the two neighbourhood layouts; at each N,
    ``'auto'`` must pick the row kernel."""
    import torch
    from montecarlo_tpu_torch.models import lennard_jones as lj
    from montecarlo_tpu_torch.ops import cell_mc
    from montecarlo_tpu_torch.ops.lj_sweep import fused_lj_sweep
    params = lj.LJParams()
    pe, rc2, rcut = lj.cell_closures(params)
    sigma = card_scalar(CELL_MAIN["sigma"], device)
    for n in CROSSOVER_N:
        chains = lj.init_chains(max(CROSSOVER_CHAINS), n,
                                rho=CELL_MAIN["rho"], beta=CELL_MAIN["beta"],
                                frac_b=CELL_MAIN["frac_b"], seed=46,
                                device=device)
        with tempfile.TemporaryDirectory(prefix=".chip_smoke-",
                                         dir=ROOT) as tmp:
            met = tmc.Simulation(lj.make_system(), chains, [
                dict(algorithm=tmc.Metropolis,
                     pool=(lj.lj_displacement_move(CELL_MAIN["sigma"]),))],
                1, path=tmp).device_algos[0]
        check(met.supports_fused and not met._use_cell,
              f"'auto' at N {n}: not the row kernel")
        for m in CROSSOVER_CHAINS:
            st = _first(chains, m)
            box = host_box(st)
            grid = cell_mc.plan_grid(n, box, rcut, max_occupancy=int(
                _occupancy(st, cell_mc.plan_grid(n, box, rcut).nc)))
            a_att = grid.nc ** 2 // 4
            n_sub = -(-n // a_att)       # a sweep, rounded up to substeps
            attempts = []

            def row():
                return fused_lj_sweep(st.pos, st.species, st.beta, st.energy,
                                      box, sigma, SEED, 0, n, params=params)

            def cell():
                res = cell_mc.cell_mc_segment(
                    grid, cell_mc.CellModel(pe, rc2, rcut),
                    cell_mc.KeyDraws(1, 0, torch.arange(m)), st.pos,
                    st.species.float(), st.beta, st.energy, sigma, n_sub,
                    box=st.box)
                attempts.append(res[4])
                return res

            row()
            cell()                       # warm both
            times = {"row": [], "cell": []}
            for name in ("row", "cell", "cell", "row"):
                times[name].append(cuda_time(row if name == "row" else cell,
                                             1, warm=False))
            cell_att = int(attempts[-1][:, 0].sum())
            row_rate = [m * n / (t / 1e3) for t in times["row"]]
            cell_rate = [cell_att / (t / 1e3) for t in times["cell"]]
            print(f"crossover: N {n} x {m} chains, one sweep a call: row "
                  f"kernel {times['row']} ms ({row_rate} moves/s), cell path "
                  f"{times['cell']} ms for {n_sub} substeps of {grid!r} "
                  f"({cell_rate} moves/s, {cell_att} attempts), cell / row "
                  f"{np.mean(cell_rate) / np.mean(row_rate)!r}; 'auto' "
                  f"takes the row kernel [{card}]")
            if n in PROFILED_N and m == max(CROSSOVER_CHAINS):
                cell_profile(grid, pe, rc2, st, sigma, card)
                layouts(grid, st, card)


def _occupancy(st, nc):
    from montecarlo_tpu_torch.core.metropolis import _max_cell_occupancy
    return _max_cell_occupancy(st, nc, 2)


def _launches_and_busy(prof):
    """Kernel launches counted on a ``torch.profiler`` run's host rows, and
    the kernels' device time (microseconds) on its card rows (spans left
    out)."""
    import torch
    launches = busy = 0
    for evt in prof.key_averages():
        if getattr(evt, "is_user_annotation", False):
            continue        # a span's shadow on the card's rows: no kernel
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            busy += getattr(evt, "self_device_time_total",
                            getattr(evt, "self_cuda_time_total", 0))
        elif evt.key in ("cudaLaunchKernel", "cuLaunchKernel",
                         "cudaLaunchKernelExC", "cuLaunchKernelEx"):
            launches += evt.count
    return launches, busy


def cell_profile(grid, pe, rc2, st, sigma, card, n_sub=20):
    """Launches and device time per substep of the cell path under
    ``torch.profiler``: the runtime's kernel launches counted on the host
    rows, the kernels' device time on the card's rows."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from montecarlo_tpu_torch.ops import cell_mc
    ids = torch.arange(st.pos.shape[0])
    model = cell_mc.CellModel(pe, rc2, grid.rcut)
    args = (st.pos, st.species.float(), st.beta, st.energy, sigma)
    cell_mc.cell_mc_segment(grid, model, cell_mc.KeyDraws(2, 0, ids), *args,
                            n_sub, box=st.box)
    torch.cuda.synchronize()
    counts = {}
    for k in (0, n_sub):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            cell_mc.cell_mc_segment(grid, model, cell_mc.KeyDraws(2, 0, ids),
                                    *args, k, box=st.box)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches, busy = _launches_and_busy(prof)
        counts[k] = (launches, busy / 1e3, wall * 1e3)
    (l0, b0, w0), (l1, b1, w1) = counts[0], counts[n_sub]
    print(f"profile: cell path at N {st.pos.shape[1]} x {st.pos.shape[0]} "
          f"chains, {grid!r}: {(l1 - l0) / n_sub!r} kernel launches a "
          f"substep ({l0} for the bind and unbind alone), the card busy "
          f"{(b1 - b0) / n_sub!r} ms a substep of {(w1 - w0) / n_sub!r} ms "
          f"wall under the profiler ({100 * (b1 - b0) / (w1 - w0)!r} % "
          f"busy) [{card}]")
    check(l1 > l0 and b1 > 0, "the profiler saw no cell-path launches")


def layouts(grid, st, card):
    """The two neighbourhood layouts of the reference's substep on the
    same packed cells: one gather of the packed fields (the port's) and a
    torus roll of the full grid per offset, sliced to the active cells and
    concatenated (the reference's large-grid layout); equal, and timed."""
    import torch
    from montecarlo_tpu_torch.ops import cell_mc
    s = torch.remainder(st.pos / st.box[:, None, None], 1.0)
    P = cell_mc._pack(cell_mc.bind_cells(grid, s, st.species))
    m, f, nc, cap = P.shape[0], P.shape[1], grid.nc, grid.cap
    h, parity = nc // 2, (1, 0)
    flat, _ = cell_mc._geometry(nc, 2, parity, str(P.device))

    def gather():
        return P.reshape(m, f, nc * nc, cap).index_select(2, flat).reshape(
            m, f, h, h, 9 * cap)

    def rolls():
        return torch.cat([
            torch.roll(P, (-dx, -dy), (2, 3))[:, :, parity[0]::2,
                                               parity[1]::2]
            for dx in (-1, 0, 1) for dy in (-1, 0, 1)], dim=-1)

    same = torch.equal(gather(), rolls())
    t_g = cuda_time(gather, 50)
    t_r = cuda_time(rolls, 50)
    print(f"layouts: {grid!r}, {m} chains: one gather {t_g!r} ms, nine rolls "
          f"+ slices + a concat {t_r!r} ms, equal {same} [{card}]")
    check(same, "the two neighbourhood layouts differ")


def card_vs_cpu(device, card):
    """Phase 7d: one segment of the LJ species pool (both kinds of substep)
    on the card and on the CPU from the same cells and the same draws, made
    once on the CPU; substep by substep, the accept decisions, counts and
    cells compared.  A decision that differs (a flip) is allowed only where
    both sides sit at the threshold within float32 rounding of the
    neighbourhood sums; the card's cells are then set to the CPU's.
    Returns the largest position difference at the end."""
    import torch
    from montecarlo_tpu_torch.models import lennard_jones as lj
    from montecarlo_tpu_torch.ops import cell_mc
    cfg = CELL_TWIN
    m, n = cfg["chains"], cfg["n"]
    pe, rc2, rcut = lj.cell_closures(lj.LJParams())
    st = lj.init_chains(m, n, rho=1.2, beta=1.0 / 0.45, frac_b=0.2, seed=47,
                        device="cpu")
    grid = cell_mc.plan_grid(n, float(st.box[0]), rcut,
                             max_occupancy=_occupancy(st, cell_mc.plan_grid(
                                 n, float(st.box[0]), rcut).nc))
    variants, _ = cell_mc._make_substep(grid, pe, rc2, "species")
    draws = cell_mc.KeyDraws(cfg["seed"], 0, torch.arange(m))
    seq = draws.variants(cfg["substeps"], 4, cfg["w_disp"],
                         1.0 - cfg["w_disp"], True, False)
    shift = draws.shift(m, 2, "cpu")
    s = torch.remainder(st.pos / st.box[:, None, None] + shift[:, None, :],
                        1.0)
    s = torch.where(s >= 1.0, 0.0, s)
    cpu = cell_mc.bind_cells(grid, s, st.species)
    gpu = cell_mc.bind_cells(grid, s.to(device), st.species.to(device))
    check(all(torch.equal(cpu[k], gpu[k].cpu()) for k in cpu),
          "the card's bind differs from the CPU's")
    P_c, P_g = cell_mc._pack(cpu), cell_mc._pack(gpu)
    box_g, beta_g = st.box.to(device), st.beta.to(device)
    sigma = torch.tensor(0.08)
    seen = []
    orig = cell_mc._chain_sums

    def spy(d_e, attempted, accept):
        seen.append((d_e, accept))
        return orig(d_e, attempted, accept)

    cell_mc._chain_sums = spy
    flips = worst_margin = 0
    try:
        for i, (kind, color) in enumerate(seq.tolist()):
            d = draws.substep(i, kind, m, grid.nc // 2, grid.cap, 2,
                              "gaussian", "cpu")
            seen.clear()
            _, att_c, acc_c = variants[kind][color](P_c, st.box, sigma,
                                                    st.beta, *d)
            _, att_g, acc_g = variants[kind][color](
                P_g, box_g, sigma.to(device), beta_g,
                *(x.to(device) for x in d))
            (de_c, a_c), (de_g, a_g) = seen[0], seen[1]
            check(torch.equal(att_c, att_g.cpu()),
                  f"substep {i}: attempts differ between card and CPU")
            diff = a_c != a_g.cpu()
            if bool(diff.any()):
                log_u = torch.log(d[-1])
                beta = st.beta.view(-1, 1, 1)
                for de in (de_c, de_g.cpu()):
                    margin = (log_u + beta * de).abs()[diff]
                    bound = 1e-5 * (1.0 + (beta * de).abs()[diff])
                    worst_margin = max(worst_margin, float(margin.max()))
                    check(bool((margin <= bound).all()),
                          f"substep {i}: an accept flip away from the "
                          f"threshold ({margin.tolist()})")
                flips += int(diff.sum())
                P_g.copy_(P_c.to(device))
            check(int((acc_c - acc_g.cpu()).abs().sum()) <= int(diff.sum()),
                  f"substep {i}: accept counts differ beyond the flips")
    finally:
        cell_mc._chain_sums = orig

    def positions(P, idx, box):
        s_out, attr = cell_mc.unbind_cells(
            {"crd": P[:, :2], "attr": P[:, 2], "idx": idx}, n)
        frac = torch.remainder(s_out.cpu() - shift[:, None, :], 1.0)
        return frac * st.box[:, None, None], attr.cpu()

    pos_c, attr_c = positions(P_c, cpu["idx"], st.box)
    pos_g, attr_g = positions(P_g, gpu["idx"], box_g)
    dpos = float((pos_c - pos_g).abs().max())
    same = torch.equal(attr_c, attr_g) and torch.equal(P_c[:, 3],
                                                       P_g[:, 3].cpu())
    print(f"card vs CPU: {len(seq)} substeps ({int((seq[:, 0] == 1).sum())} "
          f"swaps) of {grid!r} at {m} chains x N {n}: {flips} accept flips "
          f"(largest |log u + beta dE| at one {worst_margin!r}), max "
          f"|position difference| {dpos!r}, species and occupancy equal "
          f"{same} [{card}]")
    check(dpos <= 1e-5 and same, "the card's segment differs from the CPU's")
    return dpos


def substep_kernel(device, card):
    """Phase 7e: the cell path's substep kernel (``csrc/cell_substep.cu``)
    against its torch twin (``ops/cell_mc.py: _make_substep``) at the
    ka2d_large cell's shape: one substep of each kind and colour from the
    same cells and draws, equal bit for bit; then each side's time a
    substep by CUDA events (the kernel's two launches; the twin's ~110),
    the colours in turn on a working copy of the cells, beside the least
    time of the substep by ``h100_bench/counts/cell_substep.py`` (the
    draws' operations included, as the benchmark's roofline counts them).
    Returns {kind: (kernel ms, twin ms, bound ms, what bounds it)}."""
    import torch
    from montecarlo_tpu_torch.models import lennard_jones as lj
    from montecarlo_tpu_torch.ops import cell_mc
    sys.path.insert(0, os.path.join(ROOT, "h100_bench"))
    from counts import cell_substep as counts
    from harness.peaks import BYTES_PER_S, FLOAT32_OPS_PER_S, least_seconds
    cfg = CELL_KERNEL
    m, n = cfg["chains"], cfg["n"]
    params = lj.LJParams()
    pe, rc2, rcut = lj.cell_closures(params)
    st = lj.init_chains(m, n, rho=cfg["rho"], beta=cfg["beta"],
                        frac_b=cfg["frac_b"], seed=48, device=device)
    grid = cell_mc.plan_grid(n, float(st.box[0]), rcut)
    ids = torch.arange(m, device=device)
    s = torch.remainder(st.pos / st.box[:, None, None] + cell_mc.KeyDraws(
        3, 0, ids).shift(m, 2, device)[:, None, :], 1.0)
    P0 = cell_mc._pack(cell_mc.bind_cells(grid, s, st.species.float()))
    sigma = torch.tensor(cfg["sigma"], device=device)
    args = cell_mc._kernel_args(grid, sigma, st.box, st.beta, None)
    h = grid.nc // 2
    out = {}
    for kind in (0, 1):
        variants, _ = cell_mc._make_substep(
            grid, pe, rc2, "species" if kind else None)
        draws = [cell_mc.KeyDraws(3, 0, ids).substep(
            c, kind, m, h, grid.cap, 2, "gaussian", device) for c in range(4)]

        def kernel_side(P):
            e = st.energy.clone()
            att = torch.zeros((m, 3), dtype=torch.int32, device=device)
            launch = cell_mc._kernel_substeps(grid, P, params, e, att,
                                              torch.zeros_like(att))
            return (lambda c: launch(kind, c, args, *draws[c])), e, att

        def twin_side(P):
            return lambda c: variants[kind][c](P, st.box, sigma, st.beta,
                                               *draws[c])

        attempts = 0
        for c in range(4):
            P_k, P_t = P0.clone(), P0.clone()
            run, e, att = kernel_side(P_k)
            run(c)
            d_e, n_att, _ = twin_side(P_t)(c)
            check(torch.equal(P_k, P_t) and torch.equal(e, st.energy + d_e)
                  and torch.equal(att[:, kind], n_att),
                  f"the substep kernel differs from its twin (kind {kind}, "
                  f"colour {c})")
            attempts += int(n_att.sum())

        def timed(step, reps):
            for c in range(4):
                step(c)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                for c in range(4):
                    step(c)
            b.record()
            torch.cuda.synchronize()
            return a.elapsed_time(b) / (4 * reps)

        ms_k = timed(kernel_side(P0.clone())[0], cfg["kernel_reps"])
        ms_t = timed(twin_side(P0.clone()), cfg["twin_reps"])
        ops, nbytes = counts.count(m, n, grid.nc, attempts // 4 * (kind == 0),
                                   attempts // 4 * (kind == 1), 1)
        bound = least_seconds(ops, nbytes) * 1e3
        by = ("bytes" if nbytes / BYTES_PER_S >= ops / FLOAT32_OPS_PER_S
              else "float32 operations")
        out[kind] = (ms_k, ms_t, bound, by)
        print(f"substep kernel, {('displacement', 'swap')[kind]}: "
              f"{ms_k!r} ms a substep (twin {ms_t!r} ms, {ms_t / ms_k!r}x); "
              f"bound {bound!r} ms by {by} ({100 * bound / ms_k!r} % of "
              f"it) at {m} chains x N {n}, {grid!r}, {attempts // 4} "
              f"attempts a "
              f"substep; equal to the twin in every colour [{card}]")
    return out


def cell_phases(tmc, device, kernels, card):
    """Phase 7: the cell path's main path (7a, reading every kernel's
    launches: the cell route launches no row kernel and the substep kernel
    once a substep), its other routes (7b), the crossover with the row
    kernel (7c), the card against the CPU (7d) and the substep kernel
    against its twin (7e).  Returns 7a's launches of the substep kernel
    and 7e's times."""
    from montecarlo_tpu_torch.ops.cell_mc import CELL_SUBSTEP_KERNEL
    with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=ROOT) as tmp:
        path = os.path.join(tmp, "cell_main")
        (sim, wall), counts = counted(
            kernels + (CELL_SUBSTEP_KERNEL,),
            lambda: cell_main(tmc, device, path, card))
        n_sub = counts.pop(CELL_SUBSTEP_KERNEL.symbol)
        print(f"main path: the cell path's run launches {counts} and the "
              f"substep kernel {n_sub} times in {sim.counters.cell_substeps}"
              f" substeps (every one a displacement)")
        check(sum(counts.values()) == 0,
              "the cell path's run launched a row kernel")
        check(n_sub == sim.counters.cell_substeps > 0,
              "the substep kernel's launches differ from the run's "
              "displacement substeps")
        cell_main_checks(sim, path, wall, card)
        del sim
        cell_routes(tmc, tmp, card)
    crossover(tmc, device, card)
    card_vs_cpu(device, card)
    return n_sub, substep_kernel(device, card)


# ---------------------------------------------------------------------------
# Phase 8: NPT and 3-D (plain torch on the cell and generic paths)
# ---------------------------------------------------------------------------

def _attempts(sim):
    """Attempts over all chains and moves, and the (accepted, attempted)
    sums per move, of a run's counters."""
    cnt = sim.device_state["metropolis"]["counters"].sum(0).double()
    return int(cnt[:, 1].sum()), cnt


def lj3d_generic_vs_cell(tmc, kernels, root, card):
    """Phase 8a: ``tools/bench_cell3d_npt.py``'s 3-D LJ at full width (16 x
    N 4096, rho 1.0, beta 1/0.45, 20 % B, sigma 0.06) through
    ``Simulation.run``: the generic path (``fused='off'``, sweepstep 64,
    4 steps) against the 3-D cell path (``fused='cell'``, sweepstep 512,
    16 steps), each run twice from the same chains; moves/s of the second
    runs and their ratio; the cache of 4 chains against an O(N^2)
    recompute and the composition after the cell run."""
    import torch
    from montecarlo_tpu_torch.models import lennard_jones as lj
    cfg = NPT_LJ3D
    m, n = cfg["chains"], cfg["n"]
    chains = lj.init_chains(m, n, rho=cfg["rho"], beta=cfg["beta"],
                            frac_b=cfg["frac_b"], seed=42, dim=3)
    rates, out = {}, {}
    for mode, (sweep, steps) in (("off", cfg["off"]), ("cell", cfg["cell"])):
        walls = []
        for rep in range(2):
            sim = tmc.Simulation(lj.make_system(), chains, [
                dict(algorithm=tmc.Metropolis,
                     pool=(lj.lj_displacement_move(cfg["sigma"]),), seed=7,
                     sweepstep=sweep, fused=mode)], steps,
                path=os.path.join(root, f"lj3d_{mode}_{rep}"))
            met = sim.device_algos[0]
            wall, counts = counted(kernels, lambda: timed_run(sim))
            check(sum(counts.values()) == 0,
                  f"8a {mode}: a row kernel was launched ({counts})")
            walls.append(wall)
        att, cnt = _attempts(sim)
        if mode == "off":
            check(not met.supports_fused, "8a: 'off' took a fast path")
        else:
            check(met._use_cell and met._cell_plan.dim == 3,
                  "8a: the 3-D LJ run did not take the cell path")
            print(f"8a: 3-D plan {met._cell_plan!r}")
        rates[mode] = att / walls[1]
        acc = float(cnt[:, 0].sum() / cnt[:, 1].sum())
        out[mode] = sim
        print(f"8a: 3-D LJ {m} x N {n}, {mode}: {att} attempts in "
              f"{walls!r} s (second run {rates[mode]!r} moves/s), "
              f"acceptance {acc!r} [{card}]")
        check(0.05 < acc < 0.98, f"8a {mode}: acceptance {acc}")
    sim = out["cell"]
    st = sim.device_state["sys"]
    check(not bool(sim.device_state["metropolis"]["cell_overflow"]),
          "8a: the cell path overflowed")
    st4 = _first(st, 4)
    full = lj.total_energy(st4, lj.LJParams(), row_batch=256)
    err = float(((st4.energy - full).abs()
                 - LJ_CACHE["rtol"] * full.abs()).max())
    kept = torch.equal(st.species.sum(1), chains.species.sum(1))
    print(f"8a: cell / generic {rates['cell'] / rates['off']!r}; max "
          f"|E - E(N^2)| over 4 chains "
          f"{float((st4.energy - full).abs().max())!r}, composition kept "
          f"{kept}, state on {st.pos.device.type} [{card}]")
    check(st.pos.device.type == "cuda", "8a: chains not on the card")
    check(err <= LJ_CACHE["atol"], f"8a: cached energy off ({err})")
    check(kept, "8a: composition changed")
    return out["cell"], chains


def poly_npt_generic_vs_auto(tmc, kernels, root, card):
    """Phase 8b: ``tools/bench_cell3d_npt.py``'s polydisperse NPT at full
    width (16 x N 2048, rho 1.0, beta 1/0.4, P 4.0; displacement 0.08 w
    0.75, swap w 0.2, volume dlnv 0.002 w 0.05): ``fused='off'`` (sweepstep
    64, 4 steps) against ``'auto'`` (sweepstep 512, 16 steps), twice each;
    under ``'auto'`` the cell route with no row kernel launched; volume
    moves attempted and accepted, boxes above the grid's floor, diameters
    kept, the cache within the reference's poly bounds."""
    import torch
    from montecarlo_tpu_torch.models import polydisperse as poly
    cfg = NPT_POLY
    m, n = cfg["chains"], cfg["n"]
    chains = poly.init_chains(m, n, rho=cfg["rho"], beta=cfg["beta"],
                              seed=42)
    wd, ws, wv = cfg["w"]
    pool = (poly.displacement_move(cfg["sigma"], weight=wd),
            poly.swap_move(weight=ws),
            poly.volume_move(dlnv=cfg["dlnv"], pressure=cfg["pressure"],
                             weight=wv))
    rates, out = {}, {}
    for mode, (sweep, steps) in (("off", cfg["off"]), ("auto", cfg["auto"])):
        walls = []
        for rep in range(2):
            sim = tmc.Simulation(poly.make_system(), chains, [
                dict(algorithm=tmc.Metropolis, pool=pool, seed=7,
                     sweepstep=sweep, fused=mode)], steps,
                path=os.path.join(root, f"polynpt_{mode}_{rep}"))
            met = sim.device_algos[0]
            wall, counts = counted(kernels, lambda: timed_run(sim))
            check(sum(counts.values()) == 0,
                  f"8b {mode}: a row kernel was launched ({counts})")
            walls.append(wall)
        att, cnt = _attempts(sim)
        rates[mode] = att / walls[1]
        out[mode] = sim
        if mode == "auto":
            check(met._use_cell and met._cell_model.vol == 2,
                  "8b: 'auto' did not take the cell path with volume "
                  "substeps")
            print(f"8b: NPT plan {met._cell_plan!r}")
        accs = (cnt[:, 0] / cnt[:, 1]).tolist()
        print(f"8b: poly NPT {m} x N {n}, {mode}: {att} attempts in "
              f"{walls!r} s (second run {rates[mode]!r} moves/s), volume "
              f"{int(cnt[2, 1])} attempted, {int(cnt[2, 0])} accepted, "
              f"acceptance per move {accs} [{card}]")
        check(cnt[2, 1] > 0 and cnt[2, 0] > 0,
              f"8b {mode}: no volume move attempted or accepted")
    sim = out["auto"]
    met = sim.device_algos[0]
    st = sim.device_state["sys"]
    check(not bool(sim.device_state["metropolis"]["cell_overflow"]),
          "8b: the cell path overflowed")
    check(bool((st.box >= np.float32(met._cell_plan.box_min)).all()),
          "8b: a box below the grid's floor")
    check(torch.equal(torch.sort(st.diam, 1).values,
                      torch.sort(chains.diam, 1).values),
          "8b: diameters changed")
    st4 = _first(st, 4)
    full = poly.total_energy(st4, poly.PolyParams(), row_batch=256)
    err = float(((st4.energy - full).abs()
                 - POLY_CACHE["rtol"] * full.abs()).max())
    print(f"8b: cell / generic {rates['auto'] / rates['off']!r}; boxes "
          f"{float(chains.box[0])!r} -> {st.box.min().item()!r} .. "
          f"{st.box.max().item()!r} (floor {met._cell_plan.box_min!r}); "
          f"max |E - E(N^2)| over 4 chains "
          f"{float((st4.energy - full).abs().max())!r} [{card}]")
    check(err <= POLY_CACHE["atol"], f"8b: cached energy off ({err})")
    return sim


def glass_protocol(tmc, kernels, root, card):
    """Phase 8c: the NPT swap-MC glass protocol of
    ``benchmarks/glass_protocol_r05.json`` (128 x N 2048, T 0.4, P 4.0,
    displacement 0.798 + swap 0.2 + volume 0.002, about 100 sweeps on the
    cell path with the BIN store), gated on the record's physics columns:
    the density 1.0 -> 0.9004 and the acceptances per move, each within its
    band; moves/s with recorders beside the card."""
    from montecarlo_tpu_torch.models import polydisperse as poly
    cfg = GLASS
    m, n, steps, every = cfg["chains"], cfg["n"], cfg["steps"], cfg["every"]
    chains = poly.init_chains(m, n, rho=1.0, beta=1.0 / cfg["T"], seed=42)
    wd, ws, wv = cfg["w"]
    pool = (poly.displacement_move(cfg["sigma"], weight=wd),
            poly.swap_move(weight=ws),
            poly.volume_move(dlnv=cfg["dlnv"], pressure=cfg["P"],
                             weight=wv))
    sched = np.arange(every, steps + 1, every)
    path = os.path.join(root, "glass")
    sim = tmc.Simulation(poly.make_system(), chains, [
        dict(algorithm=tmc.Metropolis, pool=pool, seed=11,
             sweepstep=cfg["sweepstep"]),
        dict(algorithm=tmc.StoreCallbacks,
             callbacks=(poly.callback_energy_per_particle,
                        poly.callback_density, tmc.callback_acceptance),
             scheduler=sched),
        dict(algorithm=tmc.StoreTrajectories, fmt=tmc.BIN(),
             scheduler=sched)], steps, path=path)
    met = sim.device_algos[0]
    check(met._use_cell, "8c: the glass protocol is not on the cell path")
    wall, counts = counted(kernels, lambda: timed_run(sim))
    check(sum(counts.values()) == 0, f"8c: a row kernel ran ({counts})")
    att, cnt = _attempts(sim)
    acc = (cnt[:, 0] / cnt[:, 1]).tolist()
    rho = np.loadtxt(os.path.join(path, "density.dat"))
    e = np.loadtxt(os.path.join(path, "energy_per_particle.dat"))
    from montecarlo_tpu_torch.core.algorithms import (
        load_chain_major_trajectories)
    times, fields = load_chain_major_trajectories(path)
    st = sim.device_state["sys"]
    st4 = _first(st, 4)
    full = poly.total_energy(st4, poly.PolyParams(), row_batch=256)
    print(f"8c: glass protocol {m} x N {n}, {met._cell_plan!r}: {att} "
          f"attempted moves ({att / (m * n)!r} sweeps) in {wall!r} s, "
          f"{att / wall!r} moves/s with recorders; density "
          f"{float(rho[0, 1])!r} -> {float(rho[-1, 1])!r} (record "
          f"{GLASS_RECORD['density']!r}), acceptance disp/swap/vol {acc} "
          f"(record {GLASS_RECORD['acc']!r}), e/N {float(e[-1, 1])!r}, "
          f"{len(times)} BIN records of {fields['pos'].shape[1]} chains, "
          f"max |E - E(N^2)| over 4 chains "
          f"{float((st4.energy - full).abs().max())!r} [{card}]")
    check(not bool(sim.device_state["metropolis"]["cell_overflow"]),
          "8c: the cell path overflowed")
    check(abs(float(rho[-1, 1]) - GLASS_RECORD["density"])
          <= GLASS_RECORD["density_band"],
          f"8c: final density {float(rho[-1, 1])} outside "
          f"{GLASS_RECORD['density']} +- {GLASS_RECORD['density_band']}")
    for name, got, want in zip(("disp", "swap", "vol"), acc,
                               GLASS_RECORD["acc"]):
        check(abs(got - want) <= GLASS_RECORD["acc_band"],
              f"8c: {name} acceptance {got} outside {want} +- "
              f"{GLASS_RECORD['acc_band']}")
    check(len(times) == len(sched) + 1 and fields["pos"].shape[1] == m,
          "8c: BIN records")
    err = float(((st4.energy - full).abs()
                 - POLY_CACHE["rtol"] * full.abs()).max())
    check(err <= POLY_CACHE["atol"], f"8c: cached energy off ({err})")
    return wall


def hard_spheres_npt(tmc, kernels, root, card):
    """Phase 8d: hard spheres under NPT on the 3-D cell path at 16 x
    N 4096 (eta 0.30, beta P 3.0, dlnv 0.002 w 0.05, displacement 0.12,
    sweepstep 512, 12 steps: ``tests/test_npt.py``'s test at 16 chains):
    no overlap, the boxes moved, no overflow."""
    from montecarlo_tpu_torch.models import hard_disks as hd
    cfg = NPT_HS
    m, n = cfg["chains"], cfg["n"]
    chains = hd.init_chains(m, n, eta=cfg["eta"], seed=9, dim=3)
    pool = (hd.displacement_move(cfg["delta"], weight=0.95),
            hd.volume_move(dlnv=cfg["dlnv"], beta_pressure=cfg["beta_p"],
                           weight=0.05))
    sim = tmc.Simulation(hd.make_system(), chains, [
        dict(algorithm=tmc.Metropolis, pool=pool, seed=5,
             sweepstep=cfg["sweepstep"])], cfg["steps"],
        path=os.path.join(root, "hs_npt"))
    met = sim.device_algos[0]
    check(met._use_cell and met._cell_plan.dim == 3,
          "8d: hard spheres not on the 3-D cell path")
    wall, counts = counted(kernels, lambda: timed_run(sim))
    check(sum(counts.values()) == 0, f"8d: a row kernel ran ({counts})")
    att, cnt = _attempts(sim)
    st = sim.device_state["sys"]
    free = hd.overlap_free(st)
    dmin = float(hd.min_pair_distance(st).min())
    print(f"8d: hard spheres {m} x N {n}, {met._cell_plan!r}: {att} "
          f"attempts in {wall!r} s, acceptance per move "
          f"{(cnt[:, 0] / cnt[:, 1]).tolist()}, boxes "
          f"{float(chains.box[0])!r} -> {st.box.min().item()!r} .. "
          f"{st.box.max().item()!r}, min pair distance {dmin!r} [{card}]")
    check(not bool(sim.device_state["metropolis"]["cell_overflow"]),
          "8d: the cell path overflowed")
    check(bool(free.all()), "8d: hard spheres overlap")
    check(bool((st.box != chains.box).all()), "8d: a box did not move")
    check(cnt[1, 0] > 0, "8d: no volume move accepted")


class _Replay:
    """The draws of a CPU :class:`KeyDraws`, moved to ``device``: one
    segment's numbers for the card, made as the CPU's run makes them."""

    def __init__(self, draws, device):
        self.draws, self.device = draws, device

    def variants(self, *args):
        return self.draws.variants(*args)

    def shift(self, m, dim, device):
        return self.draws.shift(m, dim, "cpu").to(self.device)

    def substep(self, *args):
        return tuple(x.to(self.device)
                     for x in self.draws.substep(*args[:-1], "cpu"))

    def volume(self, i, m, device):
        return tuple(x.to(self.device) for x in self.draws.volume(i, m,
                                                                  "cpu"))


def npt_card_vs_cpu(device, card):
    """Phase 8e: one NPT segment (2-D poly: displacement, swap and volume
    substeps) and one 3-D segment (LJ species pool) on the card and on the
    CPU from the same draws, made on the CPU: 0 accept flips (equal
    counters), attributes equal, boxes within 1e-6 relative and fractional
    positions (position / box) within 1e-6: the card's ``exp`` of a volume
    step may round its last bit the other way, and a position scales with
    its box."""
    import torch
    from montecarlo_tpu_torch.models import lennard_jones as lj
    from montecarlo_tpu_torch.models import polydisperse as poly
    from montecarlo_tpu_torch.ops import cell_mc
    from montecarlo_tpu_torch.core.metropolis import _max_cell_occupancy
    cfg = NPT_TWIN
    m = cfg["chains"]
    cases = {
        "2-D poly NPT": (
            poly.init_chains(m, cfg["n2"], rho=1.0, beta=1.0 / 0.4, seed=48,
                             device="cpu"),
            poly.cell_closures(poly.PolyParams()), "diam",
            dict(w_disp=0.6, w_swap=0.2, swap_mode="pair",
                 vol=(cfg["n2"], 4.0), dlnv=0.002), 0.15),
        "3-D LJ": (
            lj.init_chains(m, cfg["n3"], rho=1.0, beta=1.0 / 0.45,
                           frac_b=0.2, seed=49, device="cpu", dim=3),
            lj.cell_closures(lj.LJParams()), "species",
            dict(w_disp=0.6, w_swap=0.4, swap_mode="species"), 0.0)}
    for label, (st, (pe, rc2, rcut), field, kw, margin) in cases.items():
        n, dim = st.pos.shape[1:]
        box = float(st.box[0])
        plan0 = cell_mc.plan_grid(n, box, rcut, dim=dim, box_margin=margin)
        occ = _max_cell_occupancy(st, plan0.nc, dim)
        grid = cell_mc.plan_grid(n, box, rcut, dim=dim, box_margin=margin,
                                 max_occupancy=int(np.ceil(
                                     occ * (box / plan0.box_min) ** dim)))
        attr = getattr(st, field).to(torch.float32)
        model = cell_mc.CellModel(pe, rc2, rcut,
                                  swap_mode=kw.pop("swap_mode"))
        res = {}
        for where in ("cpu", "card"):
            draws = cell_mc.KeyDraws(cfg["seed"], 0, torch.arange(m))
            if where == "cpu":
                x = (st.pos, attr, st.beta, st.energy, st.box)
            else:
                draws = _Replay(draws, device)
                x = tuple(t.to(device) for t in (st.pos, attr, st.beta,
                                                 st.energy, st.box))
            out = cell_mc.cell_mc_segment(
                grid, model, draws, *x[:4], torch.tensor(0.08),
                cfg["substeps"], box=x[4], **kw)
            res[where] = [t.cpu() for t in out]
        c, g = res["cpu"], res["card"]
        flips = int((c[5] - g[5]).abs().sum())
        dpos = float((c[0] - g[0]).abs().max())
        dfrac = float((c[0] / c[3][:, None, None]
                       - g[0] / g[3][:, None, None]).abs().max())
        dbox = float(((c[3] - g[3]).abs() / c[3]).max())
        seq = cell_mc.KeyDraws(cfg["seed"], 0, torch.arange(m)).variants(
            cfg["substeps"], 2 ** dim, kw["w_disp"], kw.get("w_swap", 0.0),
            True, "vol" in kw)
        kinds = np.bincount(seq[:, 0], minlength=3).tolist()
        print(f"8e: card vs CPU, {label}, {m} chains x N {n}, {grid!r}: "
              f"{cfg['substeps']} substeps (kinds {kinds}), {flips} accept "
              f"differences, max |position difference| {dpos!r} (of the "
              f"fractional positions {dfrac!r}), max box difference "
              f"{dbox!r} relative, attributes equal "
              f"{torch.equal(c[1], g[1])}, attempts "
              f"{c[4].sum(0).tolist()} [{card}]")
        check(torch.equal(c[4], g[4]) and flips == 0,
              f"8e {label}: the card's accept decisions differ")
        check(dfrac <= 1e-6 and dbox <= 1e-6 and torch.equal(c[1], g[1]),
              f"8e {label}: the card's segment differs from the CPU's")
        check(not bool(c[6].any()), f"8e {label}: invalid bind")


def substep_profile(label, fn, n_calls, card):
    """Launches, the card's busy time and wall per call of ``fn`` (one
    substep) under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n_calls
    launches, busy = _launches_and_busy(prof)
    busy = busy / 1e3 / n_calls
    ms = cuda_time(fn, n_calls)
    print(f"8f: {label}: {launches / n_calls!r} launches, the card busy "
          f"{busy!r} ms of {wall * 1e3!r} ms wall a call under the profiler "
          f"({100 * busy / (wall * 1e3)!r} %), {ms!r} ms a call by CUDA "
          f"events without it [{card}]")
    check(launches > 0 and busy > 0, f"8f {label}: the profiler saw nothing")
    return ms


def substep_times(lj3d_sim, poly_sim, card):
    """Phase 8f: a 3-D displacement substep (8a's cell run's state) and a
    volume substep (8b's), each timed and profiled on its bound state."""
    import torch
    from montecarlo_tpu_torch.ops import cell_mc
    for label, sim, field, kind in (
            ("3-D LJ displacement substep", lj3d_sim, "species", 0),
            ("poly NPT volume substep", poly_sim, "diam", 2)):
        met = sim.device_algos[0]
        grid = met._cell_plan
        pe, rc2 = met._cell_model.model.pair_energy, \
            met._cell_model.model.rcut2_of
        st = sim.device_state["sys"]
        m, n, dim = st.pos.shape
        vol = (n, met._cell_model.pressure) if kind == 2 else None
        variants, _ = cell_mc._make_substep(grid, pe, rc2, None, vol)
        s = torch.remainder(st.pos / st.box[:, None, None], 1.0)
        P = cell_mc._pack(cell_mc.bind_cells(
            grid, s, getattr(st, field).to(torch.float32)))
        draws = cell_mc.KeyDraws(3, 0, torch.arange(m))
        if kind == 0:
            d = draws.substep(0, 0, m, grid.nc // 2, grid.cap, dim,
                              "gaussian", st.pos.device)
            sigma = torch.tensor(0.06, device=st.pos.device)
            fn = lambda: variants[0][1](P, st.box, sigma, st.beta, *d)
        else:
            d = draws.volume(0, m, st.pos.device)
            dlnv = torch.tensor(0.002, device=st.pos.device)
            fn = lambda: variants[2][0](P, st.box, st.energy, dlnv, st.beta,
                                        *d)
        substep_profile(f"{label}, {m} chains x N {n}, {grid!r}", fn, 20,
                        card)


def ideal_gas_on_card(tmc, root, card):
    """Phase 8f: the ideal-gas gate on the generic path on the card: 128 x
    N 16, 4,000 steps, <V> = (N + 1) / (beta P) within 6 % in 2-D and
    3-D."""
    from montecarlo_tpu_torch.models import lennard_jones as lj
    ideal = lj.LJParams(eps=((0.0, 0.0), (0.0, 0.0)))
    n, beta, pressure, steps = 16, 1.0, 0.5, 4000
    for dim in (2, 3):
        chains = lj.init_chains(128, n, rho=0.5, beta=beta, seed=3,
                                params=ideal, dim=dim)
        sim = tmc.Simulation(lj.make_system(ideal), chains, [
            dict(algorithm=tmc.Metropolis,
                 pool=(lj.lj_volume_move(0.3, pressure, params=ideal),),
                 seed=7)], steps, path=os.path.join(root, f"ideal{dim}"))
        wall = timed_run(sim)
        v = sim.device_state["sys"].box.double().cpu().numpy() ** dim
        want = (n + 1) / (beta * pressure)
        print(f"8f: ideal gas {dim}-D on the generic path, 128 x N {n}, "
              f"{steps} steps in {wall!r} s: <V> {float(v.mean())!r} "
              f"against (N + 1) / (beta P) = {want!r} "
              f"({100 * (float(v.mean()) / want - 1)!r} %) [{card}]")
        check(abs(float(v.mean()) / want - 1) <= 0.06,
              f"8f: ideal gas {dim}-D <V> {float(v.mean())}")


def npt_phases(tmc, device, kernels, card):
    """Phase 8: NPT and 3-D on the card (8a-8f); every run reads the row
    kernels' launches, which must stay at 0."""
    with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=ROOT) as tmp:
        lj3d_sim, _ = lj3d_generic_vs_cell(tmc, kernels, tmp, card)
        poly_sim = poly_npt_generic_vs_auto(tmc, kernels, tmp, card)
        substep_times(lj3d_sim, poly_sim, card)
        del lj3d_sim, poly_sim
        glass_protocol(tmc, kernels, tmp, card)
        hard_spheres_npt(tmc, kernels, tmp, card)
        npt_card_vs_cpu(device, card)
        ideal_gas_on_card(tmc, tmp, card)


# -- phase 9: the chain mesh ---------------------------------------------------------

def state_arrays(ds):
    """The tensors of a device-state tree as host arrays, by path."""
    from montecarlo_tpu_torch.utils.tree import tree_leaves_with_path
    import torch
    return {"/".join(str(k) for k in path): leaf.detach().cpu().numpy()
            for path, leaf in tree_leaves_with_path(ds)
            if torch.is_tensor(leaf)}


def sharded_vs_plain(device, kernels):
    """Phase 9a: each sharded entry point at its main path's shape, for
    every rank of S = 2 and 4 (one process, each rank's mesh built by
    hand), against its plain version called with the rank's folded seed:
    the Gaussian one within its gate, the particle ones bit for bit.  Every
    rank gets the same chains, so the ranks' outputs must differ.  Each
    call must launch its kernel once.  Returns the largest |kernel - plain|
    of each kernel."""
    import torch
    from montecarlo_tpu_torch.models import lennard_jones as lj
    from montecarlo_tpu_torch.models import particle1d as p1d
    from montecarlo_tpu_torch.models import polydisperse as poly
    from montecarlo_tpu_torch.ops import fused_sweep as fs
    from montecarlo_tpu_torch.ops import lj_sweep as ls
    from montecarlo_tpu_torch.ops import poly_sweep as ps
    from montecarlo_tpu_torch.parallel import Mesh
    sweep, lj_k, lj_mixed_k, poly_k = kernels
    rng = np.random.default_rng(SEED + 9)
    n = MESH["steps"]
    worst = {k.symbol: 0.0 for k in kernels}

    def launched(kernel, fn):
        before = kernel.launches
        out = fn()
        check(kernel.launches == before + 1,
              f"{kernel.symbol}: a sharded call did not launch it once")
        return out

    for s in MESH["shards"]:
        meshes = [Mesh(rank=r, size=s, device=device) for r in range(s)]
        x, beta, sigma = inputs(CONFIG2_CHAINS // s, device, rng)
        firsts = []
        for mesh in meshes:
            xk, ek, ak = launched(sweep, lambda: fs.sharded_gaussian_sweep(
                mesh, "chains", x, beta, sigma, SEED, T0, N_STEPS,
                potential=p1d.harmonic))
            xp, ep, ap = fs.fused_gaussian_sweep(
                x, beta, sigma, fs._shard_seed(mesh.rank, SEED), T0, N_STEPS,
                potential=p1d.harmonic, interpret=True)
            off = (ak != ap) | ((xk - xp).abs() > ATOL) \
                | ((ek - ep).abs() > ATOL)
            check(int(off.sum()) <= MAX_FLIP_FRACTION * x.numel(),
                  f"sharded Gaussian S={s} rank {mesh.rank}: "
                  f"{int(off.sum())} chains off their plain version")
            keep = ~off
            worst[sweep.symbol] = max(
                worst[sweep.symbol], float((xk - xp)[keep].abs().max()),
                float((ek - ep)[keep].abs().max()))
            firsts.append(xk)
        cases = (
            (lj_k, CONFIG4, lambda m, nn: lj_inputs(m, nn, device, 91),
             lambda mesh, st, seed, kw: ls.sharded_lj_sweep(
                 mesh, "chains", st.pos, st.species, st.beta, st.energy,
                 host_box(st), card_scalar(LJ_SIGMA, device), seed, LJ_T0, n,
                 params=lj.LJParams(), **kw),
             lambda st, seed: ls.fused_lj_sweep(
                 st.pos, st.species, st.beta, st.energy, host_box(st),
                 card_scalar(LJ_SIGMA, device), seed, LJ_T0, n,
                 params=lj.LJParams(), interpret=True)),
            (lj_mixed_k, POOL5, lambda m, nn: lj_inputs(m, nn, device, 92),
             lambda mesh, st, seed, kw: ls.sharded_lj_mixed_sweep(
                 mesh, "chains", st.pos, st.species, st.beta, st.energy,
                 host_box(st), card_scalar(LJ_SIGMA, device),
                 POOL5["w_disp"], seed, LJ_T0, n, params=lj.LJParams(), **kw),
             lambda st, seed: ls.fused_lj_mixed_sweep(
                 st.pos, st.species, st.beta, st.energy, host_box(st),
                 card_scalar(LJ_SIGMA, device), POOL5["w_disp"], seed, LJ_T0,
                 n, params=lj.LJParams(), interpret=True)),
            (poly_k, POLY, lambda m, nn: poly_inputs(m, nn, device, 93),
             lambda mesh, st, seed, kw: ps.sharded_poly_mixed_sweep(
                 mesh, "chains", st.pos, st.diam, st.beta, st.energy,
                 host_box(st), card_scalar(POLY["sigma"], device),
                 POLY["w_disp"], seed, POLY_T0, n, params=poly.PolyParams(),
                 **kw),
             lambda st, seed: ps.fused_poly_mixed_sweep(
                 st.pos, st.diam, st.beta, st.energy, host_box(st),
                 card_scalar(POLY["sigma"], device), POLY["w_disp"], seed,
                 POLY_T0, n, params=poly.PolyParams(), interpret=True)))
        blocks = {sweep.symbol: firsts}
        for kernel, cfg, make, sharded, plain in cases:
            st = make(cfg["chains"] // s, cfg["n"])
            blocks[kernel.symbol] = []
            for mesh in meshes:
                out = launched(kernel, lambda: sharded(mesh, st, SEED, {}))
                want = plain(st, fs._shard_seed(mesh.rank, SEED))
                same = all(torch.equal(a, b) for a, b in zip(out, want))
                check(same, f"sharded {kernel.symbol} S={s} rank "
                      f"{mesh.rank} differs from its plain version")
                blocks[kernel.symbol].append(out[0])
        for sym, outs in blocks.items():
            check(all(not torch.equal(outs[i], outs[j]) for i in range(s)
                      for j in range(i + 1, s)),
                  f"{sym}: two ranks drew the same stream (S={s})")
        print(f"9a: S={s}: every rank's sharded call launched its kernel "
              f"once and equals its plain version with the rank's folded "
              f"seed (Gaussian: M {CONFIG2_CHAINS // s} a rank, {N_STEPS} "
              f"steps, within atol {ATOL}; LJ, LJ mixed, poly at "
              f"{CONFIG4['chains'] // s} x N {CONFIG4['n']}, "
              f"{POOL5['chains'] // s} x N {POOL5['n']}, "
              f"{POLY['chains'] // s} x N {POLY['n']}, {n} steps, bit for "
              f"bit); the ranks' outputs differ")
    return worst


def sharded_times(device, card):
    """Phase 9a's times: each sharded entry point on rank 0 of a two-rank
    mesh at its main path's width a rank and segment, by CUDA events,
    beside its bound (the attempts of the timed segment); its plain
    version's ms a step over ``MESH['steps']`` steps (N_STEPS for the
    Gaussian one), one call.  Returns {entry point: (ms, plain ms a step,
    (bound ms, bound by))}."""
    import torch
    from montecarlo_tpu_torch.models import lennard_jones as lj
    from montecarlo_tpu_torch.models import particle1d as p1d
    from montecarlo_tpu_torch.models import polydisperse as poly
    from montecarlo_tpu_torch.ops import fused_sweep as fs
    from montecarlo_tpu_torch.ops import lj_sweep as ls
    from montecarlo_tpu_torch.ops import poly_sweep as ps
    from montecarlo_tpu_torch.parallel import Mesh
    mesh = Mesh(rank=0, size=2, device=device)
    rng = np.random.default_rng(SEED + 10)
    m = CONFIG2_CHAINS // 2
    x, beta, sigma = inputs(m, device, rng)
    cases = [("sharded_gaussian_sweep", m, CONFIG2_STRIDE, N_STEPS,
              lambda n, interp: fs.sharded_gaussian_sweep(
                  mesh, "chains", x, beta, sigma, SEED, 0, n,
                  potential=p1d.harmonic, interpret=interp),
              lambda out: bound(20 * m + 4,
                                m * CONFIG2_STRIDE * GAUSS_INSTR_PER_STEP))]
    for name, cfg, make, fn, per_term, per_pick in (
            ("sharded_lj_sweep", CONFIG4,
             lambda mm, nn: lj_inputs(mm, nn, device, 94),
             lambda st, n, interp: ls.sharded_lj_sweep(
                 mesh, "chains", st.pos, st.species, st.beta, st.energy,
                 host_box(st), card_scalar(LJ_SIGMA, device), SEED, 0, n,
                 params=lj.LJParams(), interpret=interp),
             LJ_INSTR_PER_TERM, LJ_INSTR_PER_PICK),
            ("sharded_lj_mixed_sweep", POOL5,
             lambda mm, nn: lj_inputs(mm, nn, device, 95),
             lambda st, n, interp: ls.sharded_lj_mixed_sweep(
                 mesh, "chains", st.pos, st.species, st.beta, st.energy,
                 host_box(st), card_scalar(LJ_SIGMA, device),
                 POOL5["w_disp"], SEED, 0, n, params=lj.LJParams(),
                 interpret=interp),
             LJ_INSTR_PER_TERM, LJ_INSTR_PER_PICK),
            ("sharded_poly_mixed_sweep", POLY,
             lambda mm, nn: poly_inputs(mm, nn, device, 96),
             lambda st, n, interp: ps.sharded_poly_mixed_sweep(
                 mesh, "chains", st.pos, st.diam, st.beta, st.energy,
                 host_box(st), card_scalar(POLY["sigma"], device),
                 POLY["w_disp"], SEED, 0, n, params=poly.PolyParams(),
                 interpret=interp),
             POLY_INSTR_PER_TERM, 0)):
        mm, nn = cfg["chains"] // 2, cfg["n"]
        st = make(mm, nn)
        seg = 10 * nn
        cases.append((
            name, mm, seg, MESH["steps"],
            lambda n, interp, fn=fn, st=st: fn(st, n, interp),
            lambda out, mm=mm, nn=nn, seg=seg, per_term=per_term,
            per_pick=per_pick: particle_bound(
                mm, nn, (mm * seg, 0) if len(out) == 3 else tuple(
                    int(v) for v in out[4].sum(0)), per_term, per_pick)))
    times = {}
    for name, mm, seg, plain_steps, call, bound_of in cases:
        ms = cuda_time(lambda: call(seg, False), 3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call(plain_steps, True)
        torch.cuda.synchronize()
        plain = (time.perf_counter() - t0) * 1e3 / plain_steps
        b_ms, by = bound_of(call(seg, False))
        times[name] = (ms, plain, (b_ms, by))
        print(f"time: 9a {name} on rank 0 of 2, M {mm} a rank, {seg} steps: "
              f"{ms!r} ms a launch against a bound of {b_ms!r} ms (by "
              f"{by}); plain version {plain!r} ms a step over {plain_steps} "
              f"steps [{card}]")
    return times


def mesh_sim(tmc, name, mesh, root):
    """Phase 9b's run ``name`` at its main path's width, on ``mesh`` (None:
    one process), with no ``device=`` argument: config 2 at a tenth of
    phase 5's depth, config 4, config 5 with PGMC (with a backup at sweep
    ``PGMC5['resume']``) and the poly path."""
    from montecarlo_tpu_torch.models import particle1d as p1d
    path = os.path.join(root, name)
    if name == "config2":
        return config2_sim(tmc, p1d, None, path, CONFIG2_CHAINS,
                           MESH["config2_steps"], CONFIG2_STRIDE, mesh=mesh)
    if name == "config4":
        return lj_sim(tmc, None, path, CONFIG4, False, mesh=mesh)
    if name == "pgmc5":
        return pgmc5_sim(tmc, None, path, mesh=mesh, extra=(dict(
            algorithm=tmc.StoreBackups,
            scheduler=np.asarray([PGMC5["resume"]])),))
    if name == "generic":
        return generic_pgmc_sim(tmc, path, mesh)
    return poly_path_sim(tmc, None, path, mesh=mesh)[0]


def run_on_mesh(tmc, mesh, root, names, kernels=None):
    """Runs of phase 9b on ``mesh``: {name: {sim, wall, counts, whole,
    gathers, gathered_bytes, sliced}}, each run's launch counts set to 0
    just before and read just after (``kernels`` None: not read), ``whole``
    the final state gathered from every rank."""
    from montecarlo_tpu_torch.parallel import fetch
    out = {}
    for name in names:
        sim = mesh_sim(tmc, name, mesh, root)
        before = dict(mesh.counts) if mesh is not None else None
        threefry0 = _threefry_launches()
        if kernels is None:
            wall, counts = timed_run(sim), None
        else:
            wall, counts = counted(kernels, lambda: timed_run(sim))
        r = dict(sim=sim, wall=wall, counts=counts,
                 threefry=_threefry_launches() - threefry0)
        if mesh is not None:
            r.update(gathers=mesh.counts["all_gather"] - before["all_gather"],
                     gathered_bytes=mesh.counts["all_gather_bytes"]
                     - before["all_gather_bytes"], sliced=len(mesh.sliced),
                     whole=state_arrays(fetch(sim.device_state, mesh)))
        out[name] = r
    return out


def _guard_writes(root, violations):
    """Record every attempt of this process to create or write a file
    under ``root``."""
    import builtins

    def guard(fn, kind):
        def wrapped(path, *args, **kw):
            p = os.path.abspath(os.fspath(path)) if isinstance(
                path, (str, os.PathLike)) else ""
            mode = args[0] if args else kw.get("mode", "r")
            if p.startswith(os.path.abspath(root)) and (
                    kind != "open" or any(c in str(mode) for c in "wax+")):
                violations.append(f"{kind} {p}")
            return fn(path, *args, **kw)
        return wrapped

    builtins.open = guard(builtins.open, "open")
    os.makedirs = guard(os.makedirs, "makedirs")
    os.replace = guard(os.replace, "replace")
    np.savez = guard(np.savez, "savez")


def mesh_worker(opts):
    """One rank of phase 9b or 9c (``--mesh-rank``): joins the group, runs
    the named paths on its mesh, resumes config 5 from its backup (9d, with
    config 5 in the runs), times the collectives, and leaves its results in
    ``<root>/results/rank<r>``."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    import montecarlo_tpu_torch as tmc
    from montecarlo_tpu_torch import checkpoint
    from montecarlo_tpu_torch.ops.fused_sweep import SWEEP_KERNEL
    from montecarlo_tpu_torch.ops.lj_sweep import LJ_KERNEL, LJ_MIXED_KERNEL
    from montecarlo_tpu_torch.ops.poly_sweep import POLY_KERNEL
    from montecarlo_tpu_torch.parallel import fetch, initialize, make_mesh
    kernels = (SWEEP_KERNEL, LJ_KERNEL, LJ_MIXED_KERNEL, POLY_KERNEL)
    rank, root = opts.mesh_rank, opts.mesh_root
    runs_dir = os.path.join(root, "runs")
    out_dir = os.path.join(root, "results", f"rank{rank}")
    os.makedirs(out_dir, exist_ok=True)
    initialize(f"localhost:{opts.mesh_port}", opts.mesh_world, rank,
               backend=opts.mesh_backend)
    try:
        mesh = make_mesh()
        print(f"9b: rank {mesh.rank} of {mesh.size}, backend {mesh.backend}, "
              f"chains on {mesh.device}", flush=True)
        violations = []
        if rank != 0:
            _guard_writes(runs_dir, violations)
        runs = run_on_mesh(tmc, mesh, runs_dir, opts.mesh_runs.split(","),
                           kernels)
        summary = {"violations": violations, "runs": {}}
        for name, r in runs.items():
            st = r["sim"].device_state
            np.savez(os.path.join(out_dir, f"{name}.npz"),
                     **state_arrays(st))
            if rank == 0:
                np.savez(os.path.join(out_dir, f"{name}_whole.npz"),
                         **r["whole"])
            summary["runs"][name] = {
                "wall": r["wall"], "counts": r["counts"],
                "threefry": r["threefry"],
                "gathers": r["gathers"],
                "gathered_bytes": r["gathered_bytes"], "sliced": r["sliced"],
                "device": str(st["sys"].pos.device if hasattr(
                    st["sys"], "pos") else st["sys"].x.device)}
        if "pgmc5" in runs:
            # 9d: the run's backup at sweep `resume`, resumed in a fresh
            # Simulation on the same ranks, against the run itself
            resumed = pgmc5_sim(tmc, None, os.path.join(runs_dir, "resumed"),
                                mesh=mesh)
            checkpoint.resume_state(resumed, os.path.join(
                runs_dir, "pgmc5", "checkpoints",
                f"ckpt_t{PGMC5['resume']}.npz"))
            wall, counts = counted(kernels, lambda: timed_run(resumed))
            got = state_arrays(fetch(resumed.device_state, mesh))
            want = runs["pgmc5"]["whole"]
            summary["resume"] = {
                "wall": wall, "counts": counts,
                "same": {k: bool(np.array_equal(got[k], want[k]))
                         for k in want}}
        # the collectives alone, at the sizes the runs gather and reduce
        times = {}
        m2 = CONFIG2_CHAINS // mesh.size
        pool = (PGMC5["chains"] // mesh.size, PGMC5["n"], 2)
        for label, t, fn in (
                ("all_gather config-2 x", torch.zeros(m2, device=mesh.device),
                 mesh.all_gather),
                ("all_gather config-5 pos", torch.zeros(
                    pool, device=mesh.device), mesh.all_gather),
                ("all_reduce a GradientData field", torch.zeros(
                    (1, 1), device=mesh.device), mesh.all_reduce)):
            fn(t)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(MESH["reps"]):
                fn(t)
            torch.cuda.synchronize()
            times[label] = (time.perf_counter() - t0) / MESH["reps"] * 1e3
        summary["collective_ms"] = times
        with open(os.path.join(out_dir, "summary.json"), "w") as f:
            json.dump(summary, f)
    finally:
        dist.destroy_process_group()
    return 0


def spawn_ranks(root, world, backend, names):
    """Start ``world`` ranks of this script (``--mesh-rank``) on one card,
    wait for them within ``MESH['timeout']``, and return each rank's
    summary; every rank is ended before this returns."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-u", os.path.abspath(__file__), "--mesh-rank",
         str(r), "--mesh-world", str(world), "--mesh-port", str(port),
         "--mesh-backend", backend, "--mesh-root", root, "--mesh-runs",
         ",".join(names)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MESH["timeout"])[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        tail = "\n".join(f"  rank {r}: {line}"
                         for line in out.splitlines()[-40:])
        print(tail)
        check(p.returncode == 0, f"rank {r} of {world} ({backend}) exited "
              f"with {p.returncode}")
    summaries = []
    for r in range(world):
        with open(os.path.join(root, "results", f"rank{r}",
                               "summary.json")) as f:
            summaries.append(json.load(f))
    return summaries


def _load(root, rank, name):
    with np.load(os.path.join(root, "results", f"rank{rank}",
                              name + ".npz")) as f:
        return dict(f)


def mesh_phases(tmc, device, kernels, card):
    """Phase 9 (9a-9d); returns (the largest |kernel - plain| of 9a per
    kernel, the launches of 9b-9d's ranks per kernel)."""
    import torch
    from montecarlo_tpu_torch.parallel import run_emulated
    symbols = {"config2": kernels[0].symbol, "config4": kernels[1].symbol,
               "pgmc5": kernels[2].symbol, "poly": kernels[3].symbol}
    err = sharded_vs_plain(device, kernels)
    sharded_times(device, card)
    launches = {k.symbol: 0 for k in kernels}
    world = MESH["world"]
    with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=ROOT) as tmp:
        # 9b: two ranks on the one card, gloo
        gloo = os.path.join(tmp, "gloo")
        ranks = spawn_ranks(gloo, world, "gloo", MESH_RUNS)
        # 9c: one rank on nccl
        nccl = os.path.join(tmp, "nccl")
        (one,) = spawn_ranks(nccl, 1, "nccl", ("config2",))
        # the same runs in one process: the emulation of each rank count
        # (threads; each rank's kernels with its folded seed, the
        # estimator's sums added) and the whole ensemble without a mesh
        emul = run_emulated(lambda mesh: {
            n: state_arrays(r["sim"].device_state) for n, r in run_on_mesh(
                tmc, mesh, os.path.join(tmp, "emul2"), MESH_RUNS).items()},
            world, device)
        emul1 = run_emulated(lambda mesh: state_arrays(run_on_mesh(
            tmc, mesh, os.path.join(tmp, "emul1"), ("config2",))[
                "config2"]["sim"].device_state), 1, device)
        single = run_on_mesh(tmc, None, os.path.join(tmp, "single"),
                             MESH_RUNS, kernels)

        for r, summary in enumerate(ranks):
            check(summary["violations"] == [],
                  f"rank {r} wrote files: {summary['violations'][:5]}")
            for name in MESH_RUNS:
                run = summary["runs"][name]
                n = run["counts"][symbols[name]]
                check(n > 0 and run["device"].startswith("cuda"),
                      f"rank {r} {name}: {n} launches on {run['device']}")
                check(sum(run["counts"].values()) == n,
                      f"rank {r} {name} launched another kernel")
                launches[symbols[name]] += n
                got, want = _load(gloo, r, name), emul[r][name]
                same = [k for k in want if not np.array_equal(got[k],
                                                              want[k])]
                check(sorted(got) == sorted(want) and not same,
                      f"rank {r} {name} differs from the emulation: {same}")
            res = summary["resume"]
            check(all(res["same"].values()),
                  f"rank {r}: config 5 resumed differs: {res['same']}")
            launches[symbols["pgmc5"]] += res["counts"][symbols["pgmc5"]]
        print("9b: launches of each rank's kernel: " + "; ".join(
            f"{name} {[s['runs'][name]['counts'][symbols[name]] for s in ranks]}"
            for name in MESH_RUNS) + f"; config 5 resumed "
            f"{[s['resume']['counts'][symbols['pgmc5']] for s in ranks]}")
        sig = [float(_load(gloo, r, "pgmc5")["params/0/sigma"])
               for r in range(world)]
        check(sig[0] == sig[1] and sig[0] != np.float32(LJ_SIGMA),
              f"config 5 sigma on the ranks: {sig}")
        n = one["runs"]["config2"]["counts"][symbols["config2"]]
        got = _load(nccl, 0, "config2")
        check(n > 0, f"9c: config 2 on one nccl rank: {n} launches")
        check(all(np.array_equal(got[k], emul1[0][k]) for k in emul1[0]),
              "9c: config 2 on one nccl rank differs from the emulation")
        launches[symbols["config2"]] += n
        print(f"9b: {world} ranks (gloo, chains on the card) equal the "
              f"one-process emulation in every tensor of each rank's state "
              f"(positions, energies, species, diameters, counters, sigma, "
              f"the estimator's sums); sigma {sig[0]!r} on both ranks; rank "
              f"1 wrote no file; 9c: one nccl rank equals the one-rank "
              f"emulation; 9d: config 5 resumed from its sweep-"
              f"{PGMC5['resume']} backup on {world} ranks is bit-equal to "
              f"the run")

        # phase 5's gates on what rank 0 wrote and gathered
        runs = os.path.join(gloo, "runs")
        config2_checks(tmc, ranks[0]["runs"]["config2"]["device"].split(":")[0],
                       device, os.path.join(runs, "config2"), CONFIG2_CHAINS,
                       MESH["config2_steps"], CONFIG2_STRIDE,
                       ranks[0]["runs"]["config2"]["wall"])
        mesh_cache_checks(gloo, device)
        for name, rows in (("config4", CONFIG4["sweeps"] // CONFIG4["stride"]
                            + 1),
                           ("pgmc5", PGMC5["sweeps"] // PGMC5["stride"] + 1),
                           ("poly", POLY["sweeps"] // POLY["stride"] + 1)):
            e = np.loadtxt(os.path.join(runs, name,
                                        "energy_per_particle.dat"))
            check(e.shape == (rows, 2) and np.all(np.isfinite(e)),
                  f"{name}: energy_per_particle.dat has {e.shape} rows")
        with open(os.path.join(runs, "pgmc5", "parameters", "1",
                               "parameters.dat")) as f:
            rows = f.read().splitlines()
        check(len(rows) == PGMC5["sweeps"] // PGMC5["stride"] + 1
              and rows[-1] == f"{PGMC5['sweeps']} [{sig[0]!r}]",
              f"config 5 parameters.dat: {rows[-1]}")
        check(os.listdir(os.path.join(runs, "pgmc5", "checkpoints"))
              == [f"ckpt_t{PGMC5['resume']}.npz"], "config 5 checkpoints")

        # times: two ranks sharing the one card, beside one process
        for name in MESH_RUNS:
            walls = [s["runs"][name]["wall"] for s in ranks]
            run = ranks[0]["runs"][name]
            fetches = run["gathers"] // run["sliced"]
            per_point = run["gathered_bytes"] / max(fetches, 1)
            print(f"time: 9b {name}: {world} ranks on one card (gloo) "
                  f"{max(walls)!r} s wall (ranks {walls}), one process "
                  f"{single[name]['wall']!r} s; {fetches} observe points, "
                  f"{run['gathers']} all-gathers, {per_point!r} bytes "
                  f"gathered a rank a point; two ranks share one card, so "
                  f"this is no multi-GPU figure [{card}]")
        print(f"time: 9c config2 on one nccl rank "
              f"{one['runs']['config2']['wall']!r} s, one process "
              f"{single['config2']['wall']!r} s [{card}]")
        for label, ms in ranks[0]["collective_ms"].items():
            print(f"time: 9b collective {label}: {ms!r} ms a call on "
                  f"{world} gloo ranks sharing one card, host copies "
                  f"included; on one nccl rank "
                  f"{one['collective_ms'][label]!r} ms [{card}]")
        print(f"time: 9d config 5 resumed from sweep {PGMC5['resume']}: "
              f"{ranks[0]['resume']['wall']!r} s [{card}]")
    return err, launches


def mesh_cache_checks(root, device):
    """The caches of the gathered final LJ and poly states (phase 5's
    bounds), positions in [0, box), each chain's attempts."""
    import torch
    from montecarlo_tpu_torch.models import lennard_jones as lj
    from montecarlo_tpu_torch.models import polydisperse as poly
    for name, mod, params, cls, cache, cfg in (
            ("config4", lj, lj.LJParams(), lj.LJState, LJ_CACHE, CONFIG4),
            ("pgmc5", lj, lj.LJParams(), lj.LJState, LJ_CACHE, PGMC5),
            ("poly", poly, poly.PolyParams(), poly.PolyState, POLY_CACHE,
             POLY)):
        whole = _load(root, 0, name + "_whole")
        st = cls(**{k.split("/", 1)[1]: torch.as_tensor(v, device=device)
                    for k, v in whole.items() if k.startswith("sys/")})
        full = plain_energy(mod, params, st)
        err = float(((st.energy - full).abs()
                     - cache["rtol"] * full.abs()).max())
        att = whole["metropolis/counters"][..., 1].sum(1)
        check(st.pos.shape[0] == cfg["chains"] and err <= cache["atol"],
              f"{name} on the mesh: cache off the O(N^2) energy ({err})")
        check(float(st.pos.min()) >= 0 and float(st.pos.max())
              < float(st.box.max()), f"{name}: positions left [0, box)")
        check(np.all(att == cfg["n"] * cfg["sweeps"]),
              f"{name}: attempts per chain {set(att.tolist())}")
        print(f"9b: {name} gathered from the ranks: {cfg['chains']} chains, "
              f"max |E - E(N^2)| {float((st.energy - full).abs().max())!r}, "
              f"attempts per chain {cfg['n'] * cfg['sweeps']}")


def nccl_pair(card):
    """Not a phase: two ranks on nccl on the one card, config 2; prints
    what NCCL does with them (the ranks' output and exit codes)."""
    with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=ROOT) as tmp:
        try:
            spawn_ranks(tmp, 2, "nccl", ("config2",))
            print(f"nccl pair: two nccl ranks on one card ran [{card}]")
        except RuntimeError as e:
            print(f"nccl pair: {e} [{card}]")


# -- phase 10: event-chain MC and replica exchange (plain torch) ----------------------

# Phase 10 runs the reference's widths; its depths are cut where named: the
# event loop is bound by the host's launches (~60 an iteration, ~100
# iterations an event at eta 0.70), ~1 s a step of 10a on the H100.
# 10a: tools/bench_ecmc.py 64 0.70 (hard disks, N 64, chain length box/2, 8
# events a step, |psi6| every step; MH with a 0.08 square displacement, a
# sweep a step), 48 steps, not 400
ECMC_HD = dict(chains=64, n=64, eta=0.70, events=8, steps=48, cap=512,
               mh_delta=0.08)
# 10b: tests/test_ecmc.py:151-180 (hard spheres, 16 x N 216, eta 0.35, 4
# events a step), two runs of 24 steps, not 80
ECMC_HS = dict(chains=16, n=216, eta=0.35, events=4, steps=24, cap=512)
# 10c: config 2's width as 2,500 ladders of (0.5, 1, 2, 4), a swap every 10
# steps, on the hybrid stepper over kernel #1
TEMPERING = dict(ladders=2500, betas=(0.5, 1.0, 2.0, 4.0), every=10,
                 steps=10 ** 5, record=1000, burn=10 ** 4)
# 10d: tools/bench_ecmc_lj.py's two runs (N 64, rho 0.6, chain length 1.5,
# 8 events a step, e/N and the virial pressure every step; MH with sigma
# 0.25), 48 steps at 64 chains and 30 at 512, not 300, the first third a
# burn-in run apart
ECMC_LJ = dict(n=64, rho=0.6, ell=1.5, events=8, steps={64: 48, 512: 30},
               mh_sigma=0.25)
# 10e: tests/test_ecmc_soft.py:91's poly size (32 x N 64, rho 1.0, beta 2,
# chain length 1.0, 8 events a step; MH displacement-only, sigma 0.12, two
# sweeps a step): both continue 6 steps from one configuration that MH
# brought to equilibrium in 24 (a poly iteration is ~500 launches), not
# 200 steps each from the lattice
ECMC_POLY = dict(chains=32, n=64, rho=1.0, beta=2.0, ell=1.0, events=8,
                 burn=24, steps=6, mh_sigma=0.12)


def _series(sim_path, name):
    d = np.loadtxt(os.path.join(sim_path, f"{name}.dat"))
    return d[1:, 1]


def _busy_share(fn, card, what):
    """The card's busy share over one call of ``fn`` under
    ``torch.profiler`` (the kernels' device time over the call's wall), and
    the kernel launches the call made."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches, busy = _launches_and_busy(prof)
    share = busy / 1e6 / wall
    print(f"profile: {what}: {launches} kernel launches, the card busy "
          f"{busy / 1e3!r} ms of {wall * 1e3!r} ms wall under the profiler "
          f"({100 * share!r} % busy) [{card}]")
    check(launches > 0 and busy > 0, f"{what}: the profiler saw no launch")
    return share, launches


def ecmc_hard_disks(tmc, root, card):
    """10a: hard-disk ECMC at tools/bench_ecmc.py's size against MH, with
    the tau of |psi6| under each."""
    from montecarlo_tpu_torch.models import hard_disks as hd
    from montecarlo_tpu_torch.utils.analysis import integrated_autocorr_time
    c = ECMC_HD
    box = float(hd.init_chains(1, c["n"], eta=c["eta"], seed=0).box[0])
    ell = box / 2.0

    def sim_of(algo, path):
        chains = hd.init_chains(c["chains"], c["n"], eta=c["eta"], seed=42)
        return tmc.Simulation(hd.make_system(), chains, [
            algo,
            dict(algorithm=tmc.StoreCallbacks, callbacks=(hd.callback_psi6,),
                 scheduler=np.arange(1, c["steps"] + 1))],
            c["steps"], path=path)

    model = hd.ecmc_model(ell, max_events_per_chain=c["cap"])
    ecmc = dict(algorithm=tmc.EventChain, model=model,
                events_per_step=c["events"], seed=7)
    sim_e = sim_of(ecmc, os.path.join(root, "ecmc_hd"))
    wall_e = timed_run(sim_e)
    stats = sim_e.device_state["ecmc"]["stats"]
    ncoll = int(stats["collisions"].sum())
    cap = int(stats["cap_hits"].sum())
    ok = bool(hd.overlap_free(sim_e.device_state["sys"]).all())
    p_e = float(hd.ecmc_pressure(stats, ell))
    sim_m = sim_of(dict(algorithm=tmc.Metropolis,
                        pool=(hd.displacement_move(c["mh_delta"]),),
                        sweepstep=c["n"], seed=7),
                   os.path.join(root, "mh_hd"))
    wall_m = timed_run(sim_m)
    cnt = sim_m.device_state["metropolis"]["counters"]
    acc_m = float(cnt[..., 0].sum()) / float(cnt[..., 1].sum())
    s_e, s_m = _series(sim_e.path, "psi6"), _series(sim_m.path, "psi6")
    tau_e, tau_m = integrated_autocorr_time(s_e), integrated_autocorr_time(
        s_m)
    ess_e, ess_m = len(s_e) / tau_e / wall_e, len(s_m) / tau_m / wall_m
    print(f"ecmc: hard disks {c['chains']} x N {c['n']}, eta {c['eta']}, "
          f"chain length {ell!r}, {c['events']} events a step, "
          f"{c['steps']} steps: {ncoll} collisions in {wall_e!r} s = "
          f"{ncoll / wall_e!r} events/s with the |psi6| recorder, cap_hits "
          f"{cap}, overlap-free {ok}, MKK pressure {p_e!r}; tau(|psi6|) "
          f"{tau_e!r} steps, {ess_e!r} ESS/s [{card}]")
    print(f"ecmc: MH on the same disks (delta {c['mh_delta']}, a sweep a "
          f"step): {wall_m!r} s, acceptance {acc_m!r}, tau(|psi6|) "
          f"{tau_m!r} steps, {ess_m!r} ESS/s; ECMC / MH ESS/s "
          f"{ess_e / ess_m!r} [{card}]")
    check(cap == 0, f"10a: {cap} event chains hit the iteration cap")
    check(ok, "10a: ECMC left overlapping disks")
    check(bool(hd.overlap_free(sim_m.device_state["sys"]).all()),
          "10a: MH left overlapping disks")
    check(np.isfinite(tau_e) and np.isfinite(tau_m) and tau_e > 0,
          "10a: no finite tau")
    check(0.01 < acc_m < 0.99, f"10a: MH acceptance {acc_m}")
    # the card's busy share over 5 more steps of the same run
    st = sim_e.device_state
    alg = sim_e.device_algos[0]
    share, _ = _busy_share(lambda: alg.step(st, sim_e.steps + 1), card,
                           f"hard-disk ECMC, one step of {c['events']} "
                           f"events")
    return ncoll / wall_e, share


def ecmc_hard_spheres(tmc, root, card):
    """10b: 3-D hard spheres at tests/test_ecmc.py's size: the MKK pressure
    in the reference's band (Carnahan-Starling 4.97)."""
    from montecarlo_tpu_torch.models import hard_disks as hd
    c = ECMC_HS
    chains = hd.init_chains(c["chains"], c["n"], eta=c["eta"], seed=60,
                            dim=3)
    ell = float(chains.box[0]) / 2.0
    model = hd.ecmc_model(ell, max_events_per_chain=c["cap"])
    walls = []
    for k in range(2):
        sim = tmc.Simulation(hd.make_system(), chains, [
            dict(algorithm=tmc.EventChain, model=model,
                 events_per_step=c["events"], seed=9)],
            c["steps"], path=os.path.join(root, f"ecmc_hs{k}"))
        walls.append(timed_run(sim))
        chains = sim.device_state["sys"]
    stats = sim.device_state["ecmc"]["stats"]
    p = float(hd.ecmc_pressure(stats, ell))
    eta = c["eta"]
    cs = (1 + eta + eta ** 2 - eta ** 3) / (1 - eta) ** 3
    print(f"ecmc: hard spheres {c['chains']} x N {c['n']}, eta {eta}: MKK "
          f"beta P / rho {p!r} (Carnahan-Starling {cs!r}), cap_hits "
          f"{int(stats['cap_hits'].sum())}, walls {walls!r} s [{card}]")
    check(int(stats["cap_hits"].sum()) == 0, "10b: cap hits")
    check(bool((stats["collisions"] > 0).all()), "10b: a chain never hit")
    check(bool(hd.overlap_free(chains).all()), "10b: overlapping spheres")
    check(4.0 < p < 6.0, f"10b: MKK pressure {p} outside 4-6")


def tempering_on_kernel(tmc, root, card, kernels):
    """10c: replica exchange between fused segments of kernel #1 at config
    2's width; returns the kernel's launches."""
    import torch
    from montecarlo_tpu_torch.core.simulation import _select_advance
    from montecarlo_tpu_torch.models import particle1d as p1d
    c = TEMPERING
    t_n = len(c["betas"])
    betas = tmc.tile_ladder(c["betas"], c["ladders"])
    chains = p1d.init_chains(t_n * c["ladders"], beta=betas, seed=42)

    def var_cb(k):
        def cb(view):
            return torch.mean(view.sys.x[k::t_n] ** 2)
        cb.__name__ = f"callback_var{k}"
        return cb

    sim = tmc.Simulation(p1d.make_system(), chains, [
        dict(algorithm=tmc.Metropolis,
             pool=(p1d.displacement_move(sigma=1.0),), seed=42),
        dict(algorithm=tmc.ReplicaExchange, n_temps=t_n, seed=5,
             scheduler=np.arange(c["every"], c["steps"] + 1, c["every"])),
        dict(algorithm=tmc.StoreCallbacks,
             callbacks=[var_cb(k) for k in range(t_n)]
             + [tmc.callback_swap_rate],
             scheduler=np.arange(c["record"], c["steps"] + 1, c["record"]))],
        c["steps"], path=os.path.join(root, "tempering"))
    check("hybrid" in _select_advance(sim).__qualname__,
          "10c: replica exchange did not take the hybrid stepper")
    wall, counts = counted(kernels, lambda: timed_run(sim))
    n = counts[kernels[0].symbol]
    check(n == sync_points(sim) and sum(counts.values()) == n,
          f"10c: {counts} for {sync_points(sim)} segments")
    counters = sim.device_state["replica_exchange"]["counters"].cpu().numpy()
    rate = counters[:, 0] / counters[:, 1]
    variances = []
    for k, beta in enumerate(c["betas"]):
        d = np.loadtxt(os.path.join(sim.path, f"var{k}.dat"))
        var = d[d[:, 0] > c["burn"], 1].mean()
        variances.append(float(var))
        check(abs(var - 1 / (2 * beta)) < 0.12 / (2 * beta),
              f"10c: beta {beta} variance {var} outside 1/(2 beta) +- 12 %")
    m = t_n * c["ladders"]
    print(f"tempering: {m} chains as {c['ladders']} ladders of "
          f"{c['betas']}, a swap every {c['every']} steps, {c['steps']} "
          f"steps on the hybrid stepper: {wall!r} s, {m * c['steps'] / wall!r}"
          f" steps/s, {n} launches of kernel #1; swap rates {rate.tolist()}, "
          f"variances {variances} against {[1 / (2 * b) for b in c['betas']]}"
          f" [{card}]")
    check(bool(np.all(rate > 0.05)), f"10c: swap rates {rate}")
    check(counters[:, 1].tolist()
          == [c["steps"] // c["every"] // 2 * c["ladders"]] * (t_n - 1),
          f"10c: attempts {counters[:, 1]}")
    return n


def ecmc_lj(tmc, root, card, kernels):
    """10d: LJ ECMC at tools/bench_ecmc_lj.py's two widths, MKK pressure
    beside the virial pressure, events/s, and the tau of e/N under ECMC and
    under MH (the MH pool's one LJ displacement on kernel #2); returns the
    kernel's launches."""
    from montecarlo_tpu_torch.models import lennard_jones as lj
    from montecarlo_tpu_torch.utils.analysis import integrated_autocorr_time
    c = ECMC_LJ
    n_kernel = 0
    for m, steps in c["steps"].items():
        burn = steps // 3

        def sim_of(algo, name, chains, n_steps):
            return tmc.Simulation(lj.make_system(), chains, [
                algo,
                dict(algorithm=tmc.StoreCallbacks,
                     callbacks=(lj.callback_energy_per_particle,
                                lj.callback_pressure),
                     scheduler=np.arange(1, n_steps + 1))],
                n_steps, path=os.path.join(root, f"{name}{m}"))

        chains = lj.init_chains(m, c["n"], rho=c["rho"], beta=1.0,
                                frac_b=0.0, seed=42)
        ecmc = dict(algorithm=tmc.EventChain,
                    model=lj.ecmc_model(c["ell"], max_events_per_chain=512),
                    events_per_step=c["events"], seed=7)
        # the MKK statistics and the virial's average over the same steps,
        # after a burn-in run of a third of them
        sim_b = sim_of(ecmc, "ecmc_lj_burn", chains, burn)
        wall_b = timed_run(sim_b)
        sim_e = sim_of(ecmc, "ecmc_lj", sim_b.device_state["sys"],
                       steps - burn)
        wall_e, counts = counted(kernels, lambda: timed_run(sim_e))
        check(sum(counts.values()) == 0, f"10d: ECMC launched {counts}")
        stats = sim_e.device_state["ecmc"]["stats"]
        ncoll, cap = int(stats["collisions"].sum()), int(
            stats["cap_hits"].sum())
        p_e = 1.0 + float(stats["excess"].double().sum()) / (
            float(stats["chains"].double().sum()) * c["ell"])
        p_v = float(_series(sim_e.path, "pressure").mean()) / c["rho"]
        sim_m = sim_of(dict(algorithm=tmc.Metropolis,
                            pool=(lj.lj_displacement_move(c["mh_sigma"]),),
                            sweepstep=c["n"], seed=7), "mh_lj", chains,
                       steps)
        wall_m, counts = counted(kernels, lambda: timed_run(sim_m))
        n_kernel += counts[kernels[1].symbol]
        s_e = _series(sim_e.path, "energy_per_particle")
        s_m = _series(sim_m.path, "energy_per_particle")[burn:]
        tau_e, tau_m = (integrated_autocorr_time(s_e),
                        integrated_autocorr_time(s_m))
        ess_e, ess_m = len(s_e) / tau_e / wall_e, len(s_m) / tau_m / wall_m
        print(f"ecmc: LJ {m} x N {c['n']}, rho {c['rho']}, chain length "
              f"{c['ell']}, {burn} + {steps - burn} steps: "
              f"{ncoll / wall_e!r} events/s with the e/N and pressure "
              f"recorders ({ncoll} in {wall_e!r} s; the burn-in "
              f"{wall_b!r} s), cap_hits {cap}; MKK beta P / rho {p_e!r} "
              f"against the virial's average over the same steps {p_v!r}; "
              f"tau(e/N) ECMC {tau_e!r} steps ({ess_e!r} ESS/s), MH "
              f"{tau_m!r} steps ({ess_m!r} ESS/s, {wall_m!r} s, {counts}); "
              f"ECMC / MH ESS/s {ess_e / ess_m!r}; mean e/N ECMC "
              f"{float(s_e.mean())!r} MH {float(s_m.mean())!r} [{card}]")
        check(cap == 0, f"10d: {cap} cap hits at {m} chains")
        check(abs(p_e - p_v) / abs(p_v) < 0.08,
              f"10d: MKK {p_e} against virial {p_v}")
        check(abs(s_e.mean() - s_m.mean()) < 0.05,
              f"10d: e/N ECMC {s_e.mean()} against MH {s_m.mean()}")
    return n_kernel


def ecmc_poly(tmc, root, card):
    """10e: polydisperse ECMC at tests/test_ecmc_soft.py:91's size against
    displacement-only MH, in that test's band, both continuing from one
    configuration MH brought to equilibrium."""
    from montecarlo_tpu_torch.models import polydisperse as poly
    c = ECMC_POLY
    mh = dict(algorithm=tmc.Metropolis,
              pool=(poly.displacement_move(c["mh_sigma"]),),
              sweepstep=2 * c["n"], seed=3)

    def sim_of(algo, name, chains, steps, every):
        return tmc.Simulation(poly.make_system(), chains, [
            algo,
            dict(algorithm=tmc.StoreCallbacks,
                 callbacks=(poly.callback_energy_per_particle,),
                 scheduler=np.arange(every, steps + 1, every))],
            steps, path=os.path.join(root, name))

    chains = poly.init_chains(c["chains"], c["n"], rho=c["rho"],
                              beta=c["beta"], seed=1)
    burn = sim_of(mh, "poly_burn", chains, c["burn"], 10)
    wall_b = timed_run(burn)
    start = burn.device_state["sys"]
    sim_e = sim_of(dict(algorithm=tmc.EventChain,
                        model=poly.ecmc_model(c["ell"]),
                        events_per_step=c["events"], seed=2), "ecmc_poly",
                   start, c["steps"], 1)
    wall_e = timed_run(sim_e)
    stats = sim_e.device_state["ecmc"]["stats"]
    sim_m = sim_of({**mh, "seed": 4}, "mh_poly", start, c["steps"], 1)
    wall_m = timed_run(sim_m)
    tails = [_series(sim.path, "energy_per_particle")
             for sim in (sim_e, sim_m)]
    se = float(np.sqrt(sum(t.std() ** 2 / len(t) for t in tails)))
    diff = float(abs(tails[0].mean() - tails[1].mean()))
    ncoll = int(stats["collisions"].sum())
    print(f"ecmc: poly {c['chains']} x N {c['n']}, {c['steps']} steps from "
          f"{c['burn']} of MH ({wall_b!r} s): {ncoll / wall_e!r} events/s "
          f"({wall_e!r} s), cap_hits {int(stats['cap_hits'].sum())}; e/N "
          f"ECMC {float(tails[0].mean())!r} MH {float(tails[1].mean())!r} "
          f"({wall_m!r} s), |difference| {diff!r} against 4 se + 0.02 = "
          f"{4 * se + 0.02!r} [{card}]")
    check(int(stats["cap_hits"].sum()) == 0, "10e: cap hits")
    check(diff < 4 * se + 0.02, "10e: ECMC and MH energies disagree")


def ecmc_phases(tmc, device, kernels, card):
    """Phase 10: event-chain MC and replica exchange on the card; returns
    the launches of kernels #1 (10c) and #2 (10d's MH)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=ROOT) as tmp:
        ecmc_hard_disks(tmc, tmp, card)
        ecmc_hard_spheres(tmc, tmp, card)
        n1 = tempering_on_kernel(tmc, tmp, card, kernels)
        n2 = ecmc_lj(tmc, tmp, card, kernels)
        ecmc_poly(tmc, tmp, card)
    print(f"phase 10: {time.perf_counter() - t0!r} s [{card}]")
    return n1, n2


# -- phase 11: the discrete lattice models (plain torch) ------------------------------

# 11a: tools/bench_ising2d.py's defaults
CHECKERBOARD = dict(chains=1024, size=64, beta=0.44, sweeps=4, steps=200)
# 11b: Swendsen-Wang, then Wolff from its last configuration, at 64^2 near
# beta_c
CLUSTER = dict(chains=64, size=64, beta=0.44, steps=100, burn=50)


def lattice_checkerboard(tmc, root, card):
    """11a: checkerboard sweeps at tools/bench_ising2d.py's size; spin-flip
    attempts per second and the card's busy share."""
    import torch
    from montecarlo_tpu_torch.models import ising2d
    c = CHECKERBOARD
    chains = ising2d.init_chains(c["chains"], c["size"], beta=c["beta"],
                                 seed=42)
    sim = tmc.Simulation(ising2d.make_system(), chains, [
        dict(algorithm=ising2d.CheckerboardMetropolis, sweeps=c["sweeps"],
             seed=42)], c["steps"], path=os.path.join(root, "checkerboard"))
    wall = timed_run(sim)
    attempts = c["chains"] * c["size"] ** 2 * c["sweeps"] * c["steps"]
    st = sim.device_state["sys"]
    e_spin = float(st.energy.mean()) / c["size"] ** 2
    s = st.spins.float()
    full = -(s * (s.roll(1, 1) + s.roll(1, 2))).sum(dim=(1, 2))
    cnt = sim.device_state["checkerboard"]["counters"]
    acc = float(cnt[..., 0].sum()) / float(cnt[..., 1].sum())
    print(f"lattice: checkerboard {c['chains']} x {c['size']}^2, beta "
          f"{c['beta']}, {c['sweeps']} sweeps a step, {c['steps']} steps: "
          f"{wall!r} s, {attempts / wall!r} spin-flip attempts/s, "
          f"acceptance {acc!r}, e/spin {e_spin!r} [{card}]")
    check(bool(torch.equal(full, st.energy)), "11a: cached energies")
    check(0.05 < acc < 0.95, f"11a: acceptance {acc}")
    check(-1.6 < e_spin < -1.2, f"11a: e/spin {e_spin} at beta 0.44")
    alg, ds = sim.device_algos[0], sim.device_state
    share, _ = _busy_share(lambda: alg.step(ds, c["steps"] + 1), card,
                           f"checkerboard, one step of {c['sweeps']} sweeps")
    return attempts / wall, share


def lattice_clusters(tmc, root, card):
    """11b: Swendsen-Wang and Wolff at 64^2 near beta_c: clusters/s, and
    Wolff's energy, continued from SW's last configuration, against SW's
    after its burn-in (a Wolff flip of a random start's small clusters
    equilibrates far slower than a sweep)."""
    import torch
    from montecarlo_tpu_torch.models import ising2d
    c = CLUSTER
    out = {}
    chains = ising2d.init_chains(c["chains"], c["size"], beta=c["beta"],
                                 seed=11)
    for name, algo, burn in (
            ("swendsen_wang", dict(algorithm=ising2d.SwendsenWang, seed=3),
             c["burn"]),
            ("wolff", dict(algorithm=ising2d.WolffCluster, clusters=4,
                           seed=3), 0)):
        sim = tmc.Simulation(ising2d.make_system(), chains, [
            algo,
            dict(algorithm=tmc.StoreCallbacks,
                 callbacks=(ising2d.callback_energy_per_spin,
                            ising2d.callback_magnetisation),
                 scheduler=np.arange(1, c["steps"] + 1))],
            c["steps"], path=os.path.join(root, name))
        wall = timed_run(sim)
        chains = sim.device_state["sys"]
        d = np.loadtxt(os.path.join(sim.path, "energy_per_spin.dat"))
        e = d[d[:, 0] > burn, 1].mean()
        cnt = sim.device_state[name]["counters"].cpu().numpy()
        per = cnt[..., 0].sum() / cnt[..., 1].sum()
        out[name] = e
        print(f"lattice: {name} {c['chains']} x {c['size']}^2, beta "
              f"{c['beta']}, {c['steps']} steps: {wall!r} s, "
              f"{float(cnt[..., 1].sum()) / wall!r} {name} moves/s, mean "
              f"{'cluster size' if name == 'wolff' else 'clusters a sweep'} "
              f"{float(per)!r}, e/spin after step {burn} {float(e)!r} "
              f"[{card}]")
        s = chains.spins.float()
        full = -(s * (s.roll(1, 1) + s.roll(1, 2))).sum(dim=(1, 2))
        check(torch.equal(full, chains.energy),
              f"11b: {name} cached energies")
    check(abs(out["wolff"] - out["swendsen_wang"]) < 0.02,
          f"11b: Wolff {out['wolff']} against SW {out['swendsen_wang']}")


def lattice_exact(tmc, root, card):
    """11c: every sampler at an exactly enumerable size on the card, each in
    its reference test's band, at 512 chains (the reference tests' 128);
    the host-bound paths cut in depth: the generic single-site paths 400
    steps, not 2000, the Wolff samplers 600, not 1200, the 1-D ring 100
    sweeps, not 3000."""
    from montecarlo_tpu_torch.models import ising, ising2d, potts
    cases = [
        ("ising2d checkerboard", "i2", 4, None, 0.3,
         dict(algorithm=ising2d.CheckerboardMetropolis, seed=11), 1500, 200,
         0.02),
        ("ising2d single flip", "i2", 4, None, 0.3,
         dict(algorithm=tmc.Metropolis, pool=(ising2d.spin_flip_move(),),
              sweepstep=16, seed=11), 400, 150, 0.03),
        ("ising2d Wolff", "i2", 4, None, 0.44,
         dict(algorithm=ising2d.WolffCluster, clusters=2, seed=29), 600,
         100, 0.03),
        ("ising2d SW, odd", "i2", 3, None, 0.4,
         dict(algorithm=ising2d.SwendsenWang, seed=5), 900, 150, 0.03),
        ("potts q3 SW", "p", 3, 3, 0.6,
         dict(algorithm=potts.SwendsenWangPotts(3), seed=3), 900, 150, 0.03),
        ("potts q3 Wolff", "p", 3, 3, 0.6,
         dict(algorithm=potts.WolffPotts(3), clusters=4, seed=3), 600, 100,
         0.03),
        ("potts q2 checkerboard", "p", 4, 2, 0.5,
         dict(algorithm=potts.CheckerboardPotts(2), seed=11), 1500, 300,
         0.03),
        ("potts q3 single recolour", "p", 3, 3, 0.5,
         dict(algorithm=tmc.Metropolis, pool=(potts.color_flip_move(3),),
              sweepstep=9, seed=11), 400, 150, 0.04),
    ]
    for what, fam, size, q, beta, algo, steps, burn, band in cases:
        if fam == "i2":
            chains = ising2d.init_chains(512, size, beta=beta, seed=7)
            system = ising2d.make_system()
            cbs = (ising2d.callback_energy_per_spin,
                   ising2d.callback_magnetisation)
            exact = ising2d.exact_moments(size, beta)
            second = "magnetisation"
        else:
            chains = potts.init_chains(512, size, q=q, beta=beta, seed=7)
            system = potts.make_system(q)
            cbs = (potts.callback_energy_per_spin,
                   potts.callback_order_parameter(q))
            exact = potts.exact_moments(size, q, beta)
            second = "order_parameter"
        path = os.path.join(root, what.replace(" ", "_").replace(",", ""))
        sim = tmc.Simulation(system, chains, [
            algo,
            dict(algorithm=tmc.StoreCallbacks, callbacks=cbs,
                 scheduler=tmc.build_schedule(steps, burn, 1))],
            steps, path=path)
        wall = timed_run(sim)
        e = float(np.loadtxt(os.path.join(path, "energy_per_spin.dat"))[
            :, 1].mean())
        m = float(np.loadtxt(os.path.join(path, f"{second}.dat"))[
            :, 1].mean())
        print(f"lattice: {what} {size}x{size}, beta {beta}, 512 chains, "
              f"{steps} steps ({wall!r} s): e/spin {e!r} (exact "
              f"{exact[0]!r}), {second} {m!r} (exact {exact[1]!r}) [{card}]")
        check(abs(e - exact[0]) < band and abs(m - exact[1]) < band,
              f"11c: {what} outside +-{band} of the exact moments")
    n, beta = 64, 0.6
    chains = ising.init_chains(512, n, beta=beta, seed=11)
    sim = tmc.Simulation(ising.make_system(), chains, [
        dict(algorithm=tmc.Metropolis, pool=(ising.spin_flip_move(),),
             sweepstep=n, seed=11)], 100, path=os.path.join(root, "ising1d"))
    wall = timed_run(sim)
    e = float(sim.device_state["sys"].energy.mean()) / n
    exact = ising.exact_energy_per_spin(beta, n)
    print(f"lattice: 1-D ring N {n}, beta {beta}, 512 chains, 100 sweeps "
          f"({wall!r} s): e/spin {e!r} (transfer matrix {exact!r}) [{card}]")
    check(abs(e - exact) < 0.03, "11c: the 1-D ring off its exact energy")


class _RecordedEventDraws:
    """Event draws made on the CPU from the chains' keys and recorded, so
    that the card replays the very numbers the CPU used."""

    def __init__(self, m, seed):
        from montecarlo_tpu_torch.core.ecmc import KeyEventDraws
        from montecarlo_tpu_torch.utils import prng
        self.src = KeyEventDraws(prng.split(prng.key(seed, "cpu"), m))
        self.log = []

    def __getattr__(self, name):        # start, uniform, bernoulli, ...
        fn = getattr(self.src, name)

        def call(*args):
            self.log.append(fn(*args))
            return self.log[-1]
        return call

    def replay(self, device):
        return _EventReplay(self.log, device)


class _EventReplay:
    """The recorded draws in turn, on ``device``."""

    def __init__(self, log, device):
        self.log, self.device, self.i = log, device, 0

    def _next(self, *args):
        check(self.i < len(self.log), "11d: the card asked for more draws "
                                      "than the CPU made")
        v = self.log[self.i]
        self.i += 1
        return tuple(x.to(self.device) for x in v) if isinstance(
            v, tuple) else v.to(self.device)

    start = uniform = bernoulli = thresholds = _next


def lattice_card_vs_cpu(device, card):
    """11d: one step of each sampler on the card and on the CPU from the
    same inputs and the same draws: the lattice steps and the swap equal
    bit for bit, each ECMC hook within 1e-4 with its counts equal."""
    import torch
    from montecarlo_tpu_torch.core.tempering import (partner_permutations,
                                                     swap, tile_ladder)
    from montecarlo_tpu_torch.models import hard_disks as hd
    from montecarlo_tpu_torch.models import ising2d
    from montecarlo_tpu_torch.models import lennard_jones as lj
    from montecarlo_tpu_torch.models import particle1d as p1d
    from montecarlo_tpu_torch.models import polydisperse as poly
    from montecarlo_tpu_torch.models import potts
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(3)
    m, size, q = 64, 32, 3

    def on(t, dev):
        return dataclasses.replace(t, **{f.name: getattr(t, f.name).to(dev)
                                         for f in dataclasses.fields(t)})

    def same(a, b, what):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name).cpu(), getattr(b, f.name).cpu()
            check(torch.equal(x, y), f"11d: {what}: {f.name} differs")

    u = lambda *s: torch.rand(s, generator=gen)
    ri = lambda hi, *s: torch.randint(0, hi, s, generator=gen)
    i2 = ising2d.init_chains(m, size, beta=0.44, seed=1, device=cpu)
    pt = potts.init_chains(m, size, q=q, beta=1.0, seed=1, device=cpu)
    steps = [
        ("ising2d checkerboard sweep", ising2d.checkerboard_sweep, i2,
         (u(m, size, size), u(m, size, size))),
        ("ising2d Wolff step", ising2d.wolff_step, i2,
         (u(m, size, size), u(m, size, size), ri(size * size, m))),
        ("ising2d SW step", ising2d.swendsen_wang_step, i2,
         (u(m, size, size), u(m, size, size),
          2 * (u(m, size * size) < 0.5).to(torch.int8) - 1)),
        ("potts checkerboard sweep",
         lambda s, *a: potts.checkerboard_sweep(s, q, *a), pt,
         (ri(q - 1, m, size, size), u(m, size, size),
          ri(q - 1, m, size, size), u(m, size, size))),
        ("potts Wolff step", lambda s, *a: potts.wolff_step(s, q, *a), pt,
         (u(m, size, size), u(m, size, size), ri(size * size, m),
          ri(q - 1, m))),
        ("potts SW step", lambda s, *a: potts.swendsen_wang_step(s, q, *a),
         pt, (u(m, size, size), u(m, size, size), ri(q, m, size * size))),
    ]
    for what, fn, st, draws in steps:
        a, na = fn(st, *draws)
        b, nb = fn(on(st, device), *(d.to(device) for d in draws))
        same(a, b, what)
        check(torch.equal(na, nb.cpu()), f"11d: {what}: counts differ")
    p1 = p1d.init_chains(m, beta=tile_ladder([0.5, 1.0, 2.0, 4.0], m // 4),
                         seed=2, device=cpu)
    perm = torch.as_tensor(partner_permutations(m, 4)[1])
    uu = u(m)
    log_t = p1d.make_system().log_target
    a, ia = swap(p1, perm, uu, log_t, ("beta",), 4)
    b, ib = swap(on(p1, device), perm.to(device), uu.to(device), log_t,
                 ("beta",), 4)
    same(a, b, "replica exchange swap")
    check(torch.equal(ia, ib.cpu()), "11d: swap counters differ")
    worst = 0.0
    for what, st, model in (
            ("hard disks", hd.init_chains(m, 64, eta=0.7, seed=3,
                                          device=cpu),
             hd.ecmc_model(4.0, max_events_per_chain=512)),
            ("LJ", lj.init_chains(m, 64, rho=0.6, beta=1.0, frac_b=0.2,
                                  seed=3, device=cpu), lj.ecmc_model(1.5)),
            ("poly", poly.init_chains(m, 64, rho=1.0, beta=2.0, seed=3,
                                      device=cpu), poly.ecmc_model(1.0)),
            ("zigzag", p1d.init_chains(m, beta=2.0, seed=3, device=cpu),
             p1d.zigzag_model())):
        rec = _RecordedEventDraws(m, 5)
        lift = {"v": torch.ones(m)} if what == "zigzag" else {}
        a, _, sa = model.event_step(st, lift, rec)
        b, _, sb = model.event_step(
            on(st, device), {k: v.to(device) for k, v in lift.items()},
            rec.replay(device))
        for f in dataclasses.fields(a):
            err = float((getattr(a, f.name) - getattr(b, f.name).cpu()).abs()
                        .max())
            worst = max(worst, err)
            check(err < 1e-4, f"11d: {what} event: {f.name} off by {err}")
        for k, v in sa.items():
            if v.dtype == torch.int32:
                check(torch.equal(v, sb[k].cpu()), f"11d: {what}: {k}")
    print(f"lattice: card against CPU, same inputs and draws: 6 lattice "
          f"steps and a replica-exchange call equal bit for bit; one event "
          f"of each ECMC hook, counts equal, positions within {worst!r} "
          f"[{card}]")


def lattice_phases(tmc, device, kernels, card):
    """Phase 11: the lattice models on the card; no kernel is launched."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=ROOT) as tmp:
        _, counts = counted(kernels, lambda: (
            lattice_checkerboard(tmc, tmp, card),
            lattice_clusters(tmc, tmp, card),
            lattice_exact(tmc, tmp, card)))
        check(sum(counts.values()) == 0, f"phase 11 launched {counts}")
        lattice_card_vs_cpu(device, card)
    print(f"phase 11: {time.perf_counter() - t0!r} s [{card}]")


# -- phase 12: continuous and quantum lattice models, Wang-Landau (plain torch) --

# 12a and 12b: tools/bench_ising2d.py's widths (1024 chains x 64^2, 4
# sweeps a step, 200 steps), each Metropolis sweep followed by one
# over-relaxation sweep
SPIN_CB = dict(chains=1024, size=64, sweeps=4, overrelax=1, steps=200,
               beta=1.0, delta=1.0)
# 12c: the reference tests' own sizes and bands
SPIN_EXACT = dict(chains=256, size=2, cb=(1200, 200), rot=(2000, 400),
                  beta_xy=0.8, beta_hb=0.7, band=0.03, band_rot_hb=0.04)
TFIM_ED = dict(chains=256, n=6, m=48, beta=1.0, fields=(0.6, 1.2),
               steps=150, sweeps=15, burn=70,
               bands=(("sx", 0.025), ("szsz", 0.025), ("mz2", 0.035)))
# examples/tfim_quantum.py's widths, held to the same bands from its tail
TFIM_EXAMPLE = dict(n=8, m=64, beta=2.0, fields=(0.4, 1.0, 1.6), chains=256,
                    steps=200, sweeps=15)
# 12d: examples/wang_landau_ising.py's widths; the full depth runs if the
# measured rate fits it in WL_BUDGET_S, else the 3 x 3 gate runs in full
WL = dict(chains=8, size=4, steps=60_000, refine=250, log_f_min=1e-4,
          probe_steps=500)
WL_BUDGET_S = 240.0
WL_L3 = dict(chains=32, size=3, steps=3000, refine=250)


def _spin_energy64(kind, st):
    """Each chain's energy recomputed in float64 from the final state."""
    import torch
    if kind == "xy":
        th = st.theta.double()
        return -(torch.cos(th - th.roll(1, 1))
                 + torch.cos(th - th.roll(1, 2))).sum(dim=(1, 2))
    sp = st.spins.double()
    return -(sp * (sp.roll(1, 1) + sp.roll(1, 2))).sum(dim=(1, 2, 3))


def spin_checkerboard(tmc, root, card, kind):
    """12a (XY) and 12b (Heisenberg): the checkerboard sampler with
    over-relaxation at full width; attempts/s, launches a step, the card's
    busy share, and the cached energy against a float64 recompute."""
    import torch
    from montecarlo_tpu_torch.models import heisenberg, xy
    mod, algo, key = {
        "xy": (xy, xy.CheckerboardXY, "checkerboard_xy"),
        "heisenberg": (heisenberg, heisenberg.CheckerboardHeisenberg,
                       "checkerboard_heisenberg")}[kind]
    c = SPIN_CB
    chains = mod.init_chains(c["chains"], c["size"], beta=c["beta"], seed=42)
    sim = tmc.Simulation(mod.make_system(), chains, [
        dict(algorithm=algo, sweeps=c["sweeps"], overrelax=c["overrelax"],
             delta=c["delta"], seed=42)], c["steps"],
        path=os.path.join(root, kind))
    wall = timed_run(sim)
    attempts = c["chains"] * c["size"] ** 2 * c["sweeps"] * c["steps"]
    st = sim.device_state["sys"]
    err = float((st.energy.double() - _spin_energy64(kind, st)).abs().max())
    n_bonds = 2 * c["size"] ** 2
    cnt = sim.device_state[key]["counters"]
    acc = float(cnt[..., 0].sum()) / float(cnt[..., 1].sum())
    e_spin = float(st.energy.mean()) / c["size"] ** 2
    alg, ds = sim.device_algos[0], sim.device_state
    share, launches = _busy_share(
        lambda: alg.step(ds, c["steps"] + 1), card,
        f"{kind} checkerboard, one step of {c['sweeps']} sweeps")
    print(f"spins: {kind} checkerboard {c['chains']} x {c['size']}^2, beta "
          f"{c['beta']}, {c['sweeps']} sweeps + {c['overrelax']} "
          f"over-relaxation a step, {c['steps']} steps: {wall!r} s, "
          f"{attempts / wall!r} spin-update attempts/s, {launches} launches "
          f"a step, busy {100 * share!r} %, acceptance {acc!r}, e/spin "
          f"{e_spin!r}, cached energy within {err!r} of float64 (bound "
          f"{5e-5 * n_bonds!r}) [{card}]")
    check(err < 5e-5 * n_bonds, f"12: {kind} cached energy off by {err}")
    check(0.05 < acc < 0.95, f"12: {kind} acceptance {acc}")
    check(bool(torch.isfinite(st.energy).all()), f"12: {kind} energies")
    return attempts / wall, launches, share


def spin_exact(tmc, root, card):
    """12c: XY and Heisenberg on the 2 x 2 lattice against the quadrature
    and the ring's exact energy, checkerboard and single rotation; TFIM
    against ED at the reference test's size and at the example's."""
    from montecarlo_tpu_torch.models import heisenberg, xy
    c = SPIN_EXACT
    e_xy, m_xy = xy.exact_moments(c["beta_xy"])
    e_hb = heisenberg.exact_energy_2x2(c["beta_hb"])
    cases = [
        ("xy checkerboard", xy, c["beta_xy"], c["cb"],
         dict(algorithm=xy.CheckerboardXY, seed=3, delta=1.5, overrelax=1),
         (e_xy, m_xy), c["band"]),
        ("xy single rotation", xy, c["beta_xy"], c["rot"],
         dict(algorithm=tmc.Metropolis, pool=(xy.rotation_move(1.5),),
              sweepstep=4, seed=3), (e_xy, m_xy), c["band"]),
        ("heisenberg checkerboard", heisenberg, c["beta_hb"], c["cb"],
         dict(algorithm=heisenberg.CheckerboardHeisenberg, seed=3,
              delta=1.5, overrelax=1), (e_hb, None), c["band"]),
        ("heisenberg single rotation", heisenberg, c["beta_hb"], c["rot"],
         dict(algorithm=tmc.Metropolis, pool=(heisenberg.rotation_move(1.5),),
              sweepstep=4, seed=3), (e_hb, None), c["band_rot_hb"])]
    for what, mod, beta, (steps, burn), algo, (e_ex, m_ex), band in cases:
        path = os.path.join(root, what.replace(" ", "_"))
        sim = tmc.Simulation(
            mod.make_system(),
            mod.init_chains(c["chains"], c["size"], beta=beta, seed=7), [
                algo,
                dict(algorithm=tmc.StoreCallbacks,
                     callbacks=(mod.callback_energy_per_spin,
                                mod.callback_magnetisation),
                     scheduler=tmc.build_schedule(steps, burn, 1))],
            steps, path=path)
        wall = timed_run(sim)
        e = float(np.loadtxt(os.path.join(path, "energy_per_spin.dat"))[
            :, 1].mean())
        m = float(np.loadtxt(os.path.join(path, "magnetisation.dat"))[
            :, 1].mean())
        print(f"spins: {what} 2x2, beta {beta}, {c['chains']} chains, "
              f"{steps} steps ({wall!r} s): e/spin {e!r} (exact {e_ex!r}), "
              f"m {m!r}" + (f" (exact {m_ex!r})" if m_ex is not None else "")
              + f", band {band} [{card}]")
        check(abs(e - e_ex) < band, f"12c: {what} e/spin {e} off {e_ex}")
        check(m_ex is None or abs(m - m_ex) < band,
              f"12c: {what} magnetisation {m} off {m_ex}")
    tfim_gates(tmc, root, card)


def tfim_gates(tmc, root, card):
    """12c: PIMC against dense ED, at tests/test_tfim.py's size and at
    examples/tfim_quantum.py's widths (through the ported example)."""
    import importlib.util
    from montecarlo_tpu_torch.models import tfim
    c = TFIM_ED
    for h in c["fields"]:
        path = os.path.join(root, f"tfim_h{h}")
        chains = tfim.init_chains(c["chains"], c["n"], c["m"], c["beta"],
                                  h=h, seed=4)
        sim = tmc.Simulation(tfim.make_system(), chains, [
            dict(algorithm=tfim.TFIMCheckerboard, sweeps=c["sweeps"],
                 seed=4),
            dict(algorithm=tmc.StoreCallbacks,
                 callbacks=(tfim.make_sx_callback(c["beta"], h, c["m"]),
                            tfim.callback_szsz, tfim.callback_sz2),
                 scheduler=tmc.build_schedule(c["steps"], 0, 2))],
            c["steps"], path=path)
        wall = timed_run(sim)
        got = {}
        for key, name in (("sx", "sx"), ("szsz", "szsz"), ("mz2", "sz2")):
            d = np.loadtxt(os.path.join(path, f"{name}.dat"))
            got[key] = float(d[d[:, 0] >= c["burn"], 1].mean())
        _tfim_check(f"{c['chains']} x {c['n']} x {c['m']}, h {h}, "
                    f"{c['steps']} x {c['sweeps']} sweeps ({wall!r} s)",
                    got, tfim.ed_observables(c["n"], c["beta"], 1.0, h),
                    card)
    spec = importlib.util.spec_from_file_location(
        "tfim_quantum", os.path.join(ROOT, "examples", "torch",
                                     "tfim_quantum.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    e = TFIM_EXAMPLE
    t0 = time.perf_counter()
    out = example.main(n_sites=e["n"], m_slices=e["m"], beta=e["beta"],
                       n_chains=e["chains"], steps=e["steps"],
                       sweeps=e["sweeps"], fields=e["fields"],
                       root=os.path.join(root, "tfim_example"))
    wall = time.perf_counter() - t0
    for h, (qmc, ex) in out.items():
        _tfim_check(f"examples/torch/tfim_quantum.py, N {e['n']}, M "
                    f"{e['m']}, beta {e['beta']}, h {h} ({wall!r} s for "
                    f"all three)", qmc, ex, card)


def _tfim_check(what, got, exact, card):
    print(f"spins: tfim {what}: " + ", ".join(
        f"{k} {float(got[k])!r} (ED {exact[k]!r})"
        for k in ("sx", "szsz", "mz2"))
        + f" [{card}]")
    for key, band in TFIM_ED["bands"]:
        check(abs(got[key] - exact[key]) < band,
              f"12c: tfim {what}: {key} {got[key]} off ED {exact[key]}")


def _wl_sim(tmc, path, c, steps, seed=1):
    from montecarlo_tpu_torch.models import ising2d
    chains = ising2d.init_chains(c["chains"], c["size"], beta=1.0,
                                 seed=seed)
    return tmc.Simulation(ising2d.make_system(), chains, [
        dict(algorithm=tmc.WangLandau, model=ising2d.wl_model(c["size"]),
             moves_per_step=c["size"] ** 2, seed=seed),
        dict(algorithm=tmc.WangLandauRefine, flatness=0.8,
             log_f_min=WL["log_f_min"], dependencies=(tmc.WangLandau,),
             scheduler=np.arange(c["refine"], steps + 1, c["refine"]))],
        steps, path=path)


def _wl_gate(slc, size, what, card):
    """The reference test's gate on one run's walkers: the support found,
    max |d log g| < 0.35, <E> within 2 % and var E within 12 % at beta
    0.2, 0.4407 and 1.0, every walker's log f < 0.01."""
    from montecarlo_tpu_torch.core.wanglandau import mean_log_g, reweight
    from montecarlo_tpu_torch.models import ising2d
    log_g, support = mean_log_g(slc, anchor_bin=0, anchor_log_g=np.log(2.0))
    exact = ising2d.exact_log_g(size)
    energies = ising2d.wl_bin_energies(size)
    err = float(np.abs(log_g[support] - exact[support]).max())
    rel = []
    for beta in (0.2, 0.4406868, 1.0):
        _, e_wl, var_wl = reweight(log_g, energies, beta)
        _, e_ex, var_ex = reweight(exact, energies, beta)
        rel.append((abs(e_wl - e_ex) / abs(e_ex),
                    abs(var_wl - var_ex) / max(var_ex, 1.0)))
    log_f = float(slc["log_f"].max())
    print(f"wang-landau: {what}: max log f {log_f!r}, max |d log g| {err!r}, "
          f"(<E>, var E) relative errors at beta 0.2, 0.4407, 1.0: {rel!r} "
          f"[{card}]")
    check(np.array_equal(support, np.isfinite(exact)),
          f"12d: {what}: support {support} against {np.isfinite(exact)}")
    check(err < 0.35, f"12d: {what}: max |d log g| {err}")
    check(all(e < 0.02 and v < 0.12 for e, v in rel),
          f"12d: {what}: moments {rel}")
    check(log_f < 0.01, f"12d: {what}: log f {log_f}")


def wang_landau_phase(tmc, root, card):
    """12d: Wang-Landau at examples/wang_landau_ising.py's widths; the
    proposals/s of a probe run decide whether the full 60,000 steps fit in
    WL_BUDGET_S, else the 4 x 4 run is cut (where its log f got is printed)
    and the reference test's gate holds on the 3 x 3 lattice in full."""
    c = WL
    probe = _wl_sim(tmc, os.path.join(root, "wl_probe"), c,
                    c["probe_steps"])
    wall = timed_run(probe)
    rate = c["probe_steps"] * c["size"] ** 2 / wall
    alg, ds = probe.device_algos[0], probe.device_state
    share, launches = _busy_share(lambda: alg.step(ds, c["probe_steps"] + 1),
                                  card, f"Wang-Landau, one step of "
                                  f"{c['size'] ** 2} proposals")
    per = launches / c["size"] ** 2
    need = c["steps"] * c["size"] ** 2 / rate
    print(f"wang-landau: {c['chains']} walkers, L {c['size']}, "
          f"{c['size'] ** 2} proposals a step: {rate!r} proposals/s a "
          f"walker ({c['chains'] * rate!r} in all), {per!r} launches a "
          f"proposal, busy {100 * share!r} %; {c['steps']} steps would take "
          f"{need!r} s (budget {WL_BUDGET_S}) [{card}]")
    if need <= WL_BUDGET_S:
        sim = _wl_sim(tmc, os.path.join(root, "wl_full"), c, c["steps"])
        wall = timed_run(sim)
        print(f"wang-landau: the full {c['steps']} steps in {wall!r} s "
              f"[{card}]")
        _wl_gate(sim.device_state["wang_landau"], c["size"],
                 f"L {c['size']}, {c['chains']} walkers, {c['steps']} steps",
                 card)
    else:
        cut = int(WL_BUDGET_S / 4 * rate / c["size"] ** 2)
        cut = max(c["refine"], cut - cut % c["refine"])
        sim = _wl_sim(tmc, os.path.join(root, "wl_cut"), c, cut)
        wall = timed_run(sim)
        log_f = sim.device_state["wang_landau"]["log_f"].cpu().numpy()
        print(f"wang-landau: depth cut to {cut} of {c['steps']} steps "
              f"({wall!r} s): log f per walker {log_f.tolist()!r}; the gate "
              f"holds on L {WL_L3['size']} [{card}]")
        l3 = _wl_sim(tmc, os.path.join(root, "wl_l3"), WL_L3,
                     WL_L3["steps"], seed=3)
        wall = timed_run(l3)
        _wl_gate(l3.device_state["wang_landau"], WL_L3["size"],
                 f"L {WL_L3['size']}, {WL_L3['chains']} walkers, "
                 f"{WL_L3['steps']} steps ({wall!r} s)", card)
    return rate, per, share


def spins_card_vs_cpu(device, card):
    """12e: each new step on the card and on the CPU from the same inputs
    and draws: XY and Heisenberg within the CPU tests' tolerances against
    the reference, TFIM spins, one Wang-Landau step and a refinement equal
    outright."""
    import torch
    from montecarlo_tpu_torch.core.wanglandau import refine, wl_step
    from montecarlo_tpu_torch.models import heisenberg as hb
    from montecarlo_tpu_torch.models import ising2d, tfim, xy
    from montecarlo_tpu_torch.utils import prng
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(12)
    m, size = 16, 16
    u = lambda *s: torch.rand(s, generator=gen)
    on = lambda st, dev: dataclasses.replace(
        st, **{f.name: getattr(st, f.name).to(dev)
               for f in dataclasses.fields(st)})
    worst = {}

    def compare(what, a, b, field, atol=0.0, rtol=0.0, circle=False):
        x = getattr(a, field).double()
        y = getattr(b, field).cpu().double()
        d = (x - y).abs()
        if circle:
            d = torch.minimum(d, 2 * np.pi - d)
        bound = atol + rtol * y.abs()
        worst[f"{what} {field}"] = float(d.max())
        check(bool((d <= bound).all()),
              f"12e: {what}: {field} off by {float(d.max())}")

    sx = xy.init_chains(m, size, beta=0.9, seed=1, device=cpu)
    draws = [u(m, size, size) for _ in range(4)]
    a, na = xy.checkerboard_sweep(sx, 1.0, *draws)
    b, nb = xy.checkerboard_sweep(on(sx, device), 1.0,
                                  *(d.to(device) for d in draws))
    check(torch.equal(na, nb.cpu()), "12e: xy sweep acceptances")
    compare("xy sweep", a, b, "theta")
    compare("xy sweep", a, b, "energy", rtol=1e-5)
    for parity in (0, 1):
        a = xy.overrelax_half_sweep(sx, parity)
        b = xy.overrelax_half_sweep(on(sx, device), parity)
        th = sx.theta.double()
        h = torch.hypot(*(sum(f(th).roll(s, ax) for s in (1, -1)
                              for ax in (1, 2)) for f in (torch.cos,
                                                          torch.sin)))
        d = (a.theta.double() - b.theta.cpu().double()).abs()
        d = torch.minimum(d, 2 * np.pi - d)
        worst[f"xy over-relaxation {parity} theta"] = float(d.max())
        check(bool((d <= 2e-6 + 2e-6 / h).all()),
              f"12e: xy over-relaxation {parity}: {float(d.max())}")
    act = {"site": torch.arange(m) * 5 % (size * size),
           "dtheta": torch.linspace(-1.4, 1.4, m)}
    move = xy.rotation_move(0.7).move
    a, _ = move.apply(sx, act)
    b, _ = move.apply(on(sx, device), {k: v.to(device)
                                       for k, v in act.items()})
    compare("xy rotation", a, b, "theta")
    compare("xy rotation", a, b, "energy", rtol=1e-5)

    sh = hb.init_chains(m, size, beta=0.9, seed=1, device=cpu)
    draws = []
    for _ in range(2):
        draws += [torch.randn((m, size, size, 3), generator=gen),
                  u(m, size, size), u(m, size, size)]
    a, na = hb.checkerboard_sweep(sh, 1.0, *draws)
    b, nb = hb.checkerboard_sweep(on(sh, device), 1.0,
                                  *(d.to(device) for d in draws))
    check(torch.equal(na, nb.cpu()), "12e: heisenberg sweep acceptances")
    compare("heisenberg sweep", a, b, "spins", atol=2e-6)
    compare("heisenberg sweep", a, b, "energy", rtol=1e-5)
    for parity in (0, 1):
        a = hb.overrelax_half_sweep(sh, parity)
        b = hb.overrelax_half_sweep(on(sh, device), parity)
        sp = sh.spins.double()
        h = sum(sp.roll(s, ax) for s in (1, -1) for ax in (1, 2)).norm(
            dim=-1, keepdim=True)
        d = (a.spins.double() - b.spins.cpu().double()).abs()
        worst[f"heisenberg over-relaxation {parity} spins"] = float(d.max())
        check(bool((d <= 2e-6 + 2e-6 / h).all()),
              f"12e: heisenberg over-relaxation {parity}: {float(d.max())}")
    axis = torch.nn.functional.normalize(torch.randn((m, 3), generator=gen),
                                         dim=-1)
    act = {"site": torch.arange(m) * 5 % (size * size), "axis": axis,
           "alpha": torch.linspace(-1.4, 1.4, m)}
    move = hb.rotation_move(0.7).move
    a, _ = move.apply(sh, act)
    b, _ = move.apply(on(sh, device), {k: v.to(device)
                                       for k, v in act.items()})
    compare("heisenberg rotation", a, b, "spins", atol=2e-6)
    compare("heisenberg rotation", a, b, "energy", rtol=1e-5)

    st = tfim.init_chains(m, 8, 64, 2.0, h=1.0, seed=1, device=cpu)
    draws = [u(m, 8, 64).clamp(min=np.finfo(np.float32).tiny)
             for _ in range(2)]
    a, na = tfim.checkerboard_sweep(st, *draws)
    b, nb = tfim.checkerboard_sweep(on(st, device),
                                    *(d.to(device) for d in draws))
    check(torch.equal(a.spins, b.spins.cpu()) and torch.equal(na, nb.cpu()),
          "12e: tfim sweep spins")
    compare("tfim sweep", a, b, "energy", rtol=1e-6)

    model = ising2d.wl_model(4)
    wi = ising2d.init_chains(m, 4, beta=1.0, seed=2, device=cpu)
    nb_ = model.n_bins
    slc = {"log_g": torch.rand((m, nb_), generator=gen) * 8,
           "hist": torch.randint(0, 50, (m, nb_), generator=gen,
                                 dtype=torch.int32),
           "log_f": torch.full((m,), 0.25)}
    slc["visited"] = slc["hist"] + 3
    sites = model.draw(prng.split(prng.key(12, cpu), (m, 16)))
    uu = u(m, 16).clamp(min=np.finfo(np.float32).tiny)
    ca = wl_step(model, wi, slc["log_g"], slc["hist"], slc["visited"],
                 slc["log_f"], sites, uu)
    cb = wl_step(model, on(wi, device),
                 *(slc[k].to(device) for k in ("log_g", "hist", "visited",
                                               "log_f")),
                 sites.to(device), uu.to(device))
    check(torch.equal(ca[0].spins, cb[0].spins.cpu())
          and torch.equal(ca[0].energy, cb[0].energy.cpu())
          and all(torch.equal(x, y.cpu()) for x, y in zip(ca[1:], cb[1:])),
          "12e: the Wang-Landau step differs between the card and the CPU")
    ra = refine(slc, 0.5, 1e-4)
    rb = refine({k: v.to(device) for k, v in slc.items()}, 0.5, 1e-4)
    check(all(torch.equal(ra[k], rb[k].cpu()) for k in ra),
          "12e: the refinement differs between the card and the CPU")
    print(f"spins: card against CPU, same inputs and draws: XY, Heisenberg "
          f"and TFIM steps within the CPU tests' tolerances (worst "
          f"{worst!r}), acceptances and TFIM spins equal; one Wang-Landau "
          f"step of 16 proposals and a refinement equal outright [{card}]")


def spin_phases(tmc, device, kernels, card):
    """Phase 12: the continuous and quantum lattice models and Wang-Landau
    on the card; no kernel is launched."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=ROOT) as tmp:
        _, counts = counted(kernels, lambda: (
            spin_checkerboard(tmc, tmp, card, "xy"),
            spin_checkerboard(tmc, tmp, card, "heisenberg"),
            spin_exact(tmc, tmp, card),
            wang_landau_phase(tmc, tmp, card)))
        check(sum(counts.values()) == 0, f"phase 12 launched {counts}")
        spins_card_vs_cpu(device, card)
    print(f"phase 12: {time.perf_counter() - t0!r} s [{card}]")


# -- phase 13: the reference's per-chain streams (the threefry kernel) -----------
#
# 13a: the threefry kernel against its plain twin at 10^7 values (10^4 keys
# x 1000 counts) in every mode, timed there and at the generic path's shape
# (one value for each of config 2's 10^4 chains); 13b: config 2's system
# (10^4 chains) and config 4 (256 x N 256) on the generic path
# (fused='off'): moves a second, launches a step and the card's busy share,
# beside the parent commit's version when --parent-tree names it; 13c: a
# generic run on the card against the same run on the CPU; 13d: the generic
# path with PGMC on two gloo ranks against one process, and the ranks'
# backup resumed in one process.
STREAMS = dict(keys=10 ** 4, per_key=1000, reps=20, plain_reps=3,
               config2_steps=1000, config2_stride=100, config4_sweeps=2,
               profile_steps=20, twin_p1d=(1000, 200), twin_lj=(8, 64, 4),
               mesh_chains=10 ** 4, mesh_steps=40, mesh_backup=20)
# kernel against twin for normals: both call CUDA's log1pf and sqrt, so
# they are expected to agree bit for bit; a toolkit whose log1pf differs
# from the one torch was built with may move the last bits, by at most this
THREEFRY_NORMAL_ULPS = 4
# operations a value, counted from csrc/threefry.cu's source: a block is
# 20 rounds of add, funnel shift and xor, five injections of three adds and
# the parity word (2 + 60 + 15 + 2 = 79), with the grid-stride loop's index
# split and loads (~10); a bits value adds an xor, a uniform a shift, an
# or, a subtract, a multiply-add and a max, a normal the uniform's and
# log1pf (~20), a select, a sqrt, 8 multiply-adds and three products;
# randint is four blocks and three modulos
THREEFRY_OPS = {"words": 89, "bits": 90, "uniform": 95, "normal": 135,
                "randint": 4 * 79 + 40}
THREEFRY_OUT_BYTES = {"words": 8, "bits": 4, "uniform": 4, "normal": 4,
                      "randint": 4}


def _threefry_launches():
    """The threefry kernel's launch count, 0 where the package has none (a
    tree before it)."""
    try:
        from montecarlo_tpu_torch.ops.threefry import THREEFRY_KERNEL
    except ImportError:
        return 0
    return THREEFRY_KERNEL.launches


def threefry_bound(n_keys, per_key, mode):
    """The threefry function's bound: each key read once (8 bytes), each
    value written once, and its operations a value."""
    n = n_keys * per_key
    return bound(8 * n_keys + THREEFRY_OUT_BYTES[mode] * n,
                 n * THREEFRY_OPS[mode])


def threefry_vs_plain(device, card):
    """Phase 13a; returns (the largest |kernel - plain| over the float
    modes, the generic path's shape's (kernel ms, plain ms, (bound ms,
    bound by)))."""
    import torch
    from montecarlo_tpu_torch.ops.threefry import threefry
    from montecarlo_tpu_torch.utils import prng
    b, n = STREAMS["keys"], STREAMS["per_key"]
    keys = prng.split(prng.key(SEED, device), b)
    spans = (torch.arange(b, device=device, dtype=torch.int32) * 37) % 1024 + 1
    cases = {"words": {}, "bits": {}, "uniform": dict(lo=-1.0, hi=1.0),
             "normal": {}, "randint": dict(ilo=0, ihi=spans)}
    err = 0.0
    for mode, kw in cases.items():
        got = threefry(keys, n, mode, **kw)
        want = threefry(keys, n, mode, interpret=True, **kw)
        torch.cuda.synchronize()
        note = "bit for bit"
        if mode == "normal":
            ulps = (got.view(torch.int32).long()
                    - want.view(torch.int32).long()).abs()
            worst = int(ulps.max())
            same = float((ulps == 0).double().mean())
            note = (f"{100 * same!r} % bit for bit, at most {worst} ulps "
                    f"apart (bound {THREEFRY_NORMAL_ULPS})")
            check(worst <= THREEFRY_NORMAL_ULPS,
                  f"13a: threefry normals {worst} ulps from the plain twin")
        else:
            check(torch.equal(got, want),
                  f"13a: threefry {mode} differs from its plain twin")
        if got.is_floating_point():
            err = max(err, float((got - want).abs().max()))
        k_ms = cuda_time(lambda: threefry(keys, n, mode, **kw),
                         STREAMS["reps"])
        p_ms = cuda_time(lambda: threefry(keys, n, mode, interpret=True,
                                          **kw), STREAMS["plain_reps"])
        b_ms, by = threefry_bound(b, n, mode)
        print(f"13a: threefry {mode} at {b} keys x {n} values: kernel "
              f"{note} against its plain twin; {k_ms!r} ms a launch, plain "
              f"{p_ms!r} ms, bound {b_ms!r} ms (by {by}): "
              f"{100 * b_ms / k_ms!r} % of the bound's rate [{card}]")
    # the generic path's shape: one uniform a chain (the accept draw)
    k_ms = cuda_time(lambda: threefry(keys, 1, "uniform"), 200)
    p_ms = cuda_time(lambda: threefry(keys, 1, "uniform", interpret=True),
                     20)
    b_ms, by = threefry_bound(b, 1, "uniform")
    print(f"13a: threefry uniform at the generic path's shape ({b} keys x "
          f"1): {k_ms!r} ms a launch, plain {p_ms!r} ms, bound {b_ms!r} ms "
          f"(by {by}); no PyTorch call computes threefry2x32 [{card}]")
    return err, (k_ms, p_ms, (b_ms, by))


def generic_bench(tmc, device, root, card):
    """Phase 13b's two runs on the generic path with any tree of the package
    (the parent commit's too): {name: {first, wall, moves, rate,
    launches_step, busy}}: a short first run of each (its wall holds the
    process's first launches of every op), the timed run from an idle card
    to an idle card, then a short run under ``torch.profiler`` for the
    launches a Metropolis step and the card's busy share."""
    from montecarlo_tpu_torch.models import particle1d as p1d
    out = {}
    m, steps, stride = (CONFIG2_CHAINS, STREAMS["config2_steps"],
                        STREAMS["config2_stride"])
    short = STREAMS["profile_steps"]
    first = timed_run(config2_sim(tmc, p1d, device, os.path.join(
        root, "config2_first"), m, short, short, fused="off"))
    sim = config2_sim(tmc, p1d, device, os.path.join(root, "config2_off"), m,
                      steps, stride, fused="off")
    check(not sim.device_algos[0].supports_fused, "13b: config 2 fused")
    wall = timed_run(sim)
    config2_checks(tmc, sim.device_state["sys"].x.device.type, device,
                   os.path.join(root, "config2_off"), m, steps, stride, wall)
    prof = config2_sim(tmc, p1d, device, os.path.join(root, "config2_prof"),
                       m, short, short, fused="off")
    busy, launches = _busy_share(prof.run, card, "13b config 2 generic")
    out["config2"] = dict(first=first, wall=wall, moves=m * steps,
                          rate=m * steps / wall,
                          launches_step=launches / short, busy=busy)
    cfg = dict(CONFIG4, sweeps=STREAMS["config4_sweeps"], stride=1)
    first = timed_run(lj_sim(tmc, device, os.path.join(root, "config4_first"),
                             dict(cfg, sweeps=1), False, fused="off"))
    sim = lj_sim(tmc, device, os.path.join(root, "config4_off"), cfg, False,
                 fused="off")
    check(not sim.device_algos[0].supports_fused, "13b: config 4 fused")
    wall = timed_run(sim)
    moves = cfg["chains"] * cfg["n"] * cfg["sweeps"]
    cnt = sim.device_state["metropolis"]["counters"]
    check(int(cnt[..., 1].sum()) == moves and int(cnt[..., 0].sum()) > 0,
          "13b: config 4 attempts")
    prof = lj_sim(tmc, device, os.path.join(root, "config4_prof"),
                  dict(cfg, sweeps=1), False, fused="off")
    busy, launches = _busy_share(prof.run, card, "13b config 4 generic")
    out["config4"] = dict(first=first, wall=wall, moves=moves,
                          rate=moves / wall,
                          launches_step=launches / cfg["n"], busy=busy)
    for name, r in out.items():
        print(f"13b: {name} on the generic path: a first short run "
              f"{r['first']!r} s; {r['moves']} moves in "
              f"{r['wall']!r} s, {r['rate']!r} moves/s, "
              f"{r['launches_step']!r} kernel launches a Metropolis step, "
              f"the card {100 * r['busy']!r} % busy [{card}]")
    return out


def bench_tree(tree):
    """13b run by a child process on the package in ``tree``: its result."""
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--streams-bench", tree],
        capture_output=True, text=True, timeout=600)
    check(out.returncode == 0, f"13b on {tree}: {out.stderr[-3000:]}")
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("STREAMS_BENCH ")][-1]
    return json.loads(line.split(" ", 1)[1])


def streams_card_vs_cpu(tmc, device, root, card):
    """Phase 13c: the same seed's generic runs on the card and on the CPU:
    initial chains equal, counters equal, states within 1e-5 (energies rtol
    1e-5)."""
    import torch
    from montecarlo_tpu_torch.models import lennard_jones as lj
    from montecarlo_tpu_torch.models import particle1d as p1d
    cpu = torch.device("cpu")
    m, steps = STREAMS["twin_p1d"]
    mc_, n, sweeps = STREAMS["twin_lj"]
    cfg = dict(chains=mc_, n=n, sweeps=sweeps, stride=sweeps,
               w_disp=POOL5["w_disp"])
    runs = {}
    for dev in (device, cpu):
        a = config2_sim(tmc, p1d, dev, os.path.join(root, f"twin1_{dev.type}"),
                        m, steps, steps, fused="off")
        b = lj_sim(tmc, dev, os.path.join(root, f"twin4_{dev.type}"), cfg,
                   True, fused="off")
        inits = (a.chains0.x.cpu(), b.chains0.pos.cpu())
        a.run()
        b.run()
        runs[dev.type] = (inits, a.device_state, b.device_state)
    (ia, pa, la), (ib, pb, lb) = runs[device.type], runs["cpu"]
    check(all(torch.equal(x, y) for x, y in zip(ia, ib)),
          "13c: init_chains differ on the card and on the CPU")
    worst = 0.0
    for what, sa, sb, fields in (("config 2's system", pa, pb, ("x", "e")),
                                 ("the config-5 pool", la, lb,
                                  ("pos", "species", "energy"))):
        ca, cb = (s["metropolis"]["counters"].cpu() for s in (sa, sb))
        check(torch.equal(ca, cb), f"13c: {what} counters differ on the "
              f"card and on the CPU")
        for f in fields:
            x, y = (getattr(s["sys"], f).cpu().double() for s in (sa, sb))
            d = float((x - y).abs().max())
            tol = 1e-5 * (1 + float(y.abs().max())) if f in ("e", "energy") \
                else 1e-5
            check(d <= tol, f"13c: {what} {f} differs by {d!r}")
            if f not in ("e", "energy", "species"):
                worst = max(worst, d)
    print(f"13c: the same seed's generic runs on the card and on the CPU "
          f"({m} chains x {steps} steps of config 2's system, {mc_} x N {n} "
          f"x {sweeps} sweeps of the config-5 pool): initial chains and "
          f"counters equal, positions within {worst!r} [{card}]")


def generic_pgmc_sim(tmc, path, mesh, device=None):
    """Phase 13d: config 2's system on the generic path with PGMC (VPG on
    the second of two displacement moves, estimator every 2 steps, update
    every 10), a backup at ``mesh_backup``; no ``device=`` argument."""
    from montecarlo_tpu_torch import policy_guided as pg
    from montecarlo_tpu_torch.models import particle1d as p1d
    steps = STREAMS["mesh_steps"]
    pool = (p1d.displacement_move(sigma=0.2, weight=0.5),
            p1d.displacement_move(sigma=0.2, weight=0.5))
    return tmc.Simulation(
        p1d.make_system(p1d.harmonic),
        p1d.init_chains(STREAMS["mesh_chains"], beta=2.0, seed=42,
                        device=device), [
            dict(algorithm=tmc.Metropolis, pool=pool, seed=42, fused="off"),
            dict(algorithm=pg.PolicyGradientEstimator,
                 dependencies=(tmc.Metropolis,),
                 optimisers=(pg.Static(), pg.VPG(0.05)), q_batch_size=2,
                 scheduler=np.arange(2, steps + 1, 2)),
            dict(algorithm=pg.PolicyGradientUpdate,
                 dependencies=(pg.PolicyGradientEstimator,),
                 scheduler=np.arange(10, steps + 1, 10)),
            dict(algorithm=tmc.StoreParameters,
                 dependencies=(tmc.Metropolis,),
                 scheduler=np.arange(10, steps + 1, 10)),
            dict(algorithm=tmc.StoreBackups,
                 scheduler=np.asarray([STREAMS["mesh_backup"]]))],
        steps, path=path, mesh=mesh)


def streams_mesh(tmc, root, card):
    """Phase 13d; returns the threefry launches of the two ranks."""
    from montecarlo_tpu_torch import checkpoint
    gloo = os.path.join(root, "gloo")
    ranks = spawn_ranks(gloo, 2, "gloo", ("generic",))
    single = run_on_mesh(tmc, None, os.path.join(root, "single"),
                         ("generic",))["generic"]
    whole = state_arrays(single["sim"].device_state)
    m = STREAMS["mesh_chains"]
    for r in range(2):
        got = _load(gloo, r, "generic")
        check(sorted(got) == sorted(whole), f"13d: rank {r} state's leaves")
        for k, w in whole.items():
            if w.ndim and w.shape[0] == m:
                w = w[r * m // 2:(r + 1) * m // 2]
            check(np.array_equal(got[k], w),
                  f"13d: rank {r} {k} differs from one process")
    sigma = float(whole["params/1/sigma"])
    check(sigma != np.float32(0.2), "13d: sigma did not move")
    resumed = generic_pgmc_sim(tmc, os.path.join(root, "resumed"), None)
    checkpoint.resume_state(resumed, os.path.join(
        gloo, "runs", "generic", "checkpoints",
        f"ckpt_t{STREAMS['mesh_backup']}.npz"))
    check(resumed.t == STREAMS["mesh_backup"], "13d: resume step")
    timed_run(resumed)
    got = state_arrays(resumed.device_state)
    diff = [k for k in whole if not np.array_equal(got[k], whole[k])]
    check(not diff, f"13d: resumed on one rank differs: {diff}")
    n = [s["runs"]["generic"]["threefry"] for s in ranks]
    check(all(k > 0 for k in n), f"13d: threefry launches on the ranks {n}")
    print(f"13d: the generic path with PGMC ({m} chains, "
          f"{STREAMS['mesh_steps']} steps) on 2 gloo ranks equals one "
          f"process in every tensor of each rank's slice (positions, "
          f"counters, keys, sigma {sigma!r}, the estimator's sums); the "
          f"ranks' step-{STREAMS['mesh_backup']} backup resumed in one "
          f"process equals the uncut run; threefry launches on the ranks "
          f"{n}; walls {[s['runs']['generic']['wall'] for s in ranks]} s on "
          f"two ranks sharing the card, {single['wall']!r} s in one process "
          f"[{card}]")
    return sum(n)


def streams_phases(tmc, device, kernels, card, parent_tree=None):
    """Phase 13 (13a-13d); returns the threefry row's numbers."""
    from montecarlo_tpu_torch.ops.threefry import THREEFRY_KERNEL
    err, (k_ms, p_ms, (b_ms, by)) = threefry_vs_plain(device, card)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=ROOT) as tmp:
        for k in kernels:
            k.launches = 0
        THREEFRY_KERNEL.launches = 0
        bench = generic_bench(tmc, device, tmp, card)
        n_main = THREEFRY_KERNEL.launches
        row_counts = {k.symbol: k.launches for k in kernels}
        print(f"main path: 13b generic runs launched threefry {n_main} "
              f"times, the row kernels {row_counts}")
        check(n_main > 0, "13b: the generic path did not launch threefry")
        check(not any(row_counts.values()),
              "13b: the generic path launched a row kernel")
        if parent_tree is not None:
            turns = [("parent", parent_tree), ("change", ROOT),
                     ("change", ROOT), ("parent", parent_tree)]
            res = [(who, bench_tree(tree)) for who, tree in turns]
            for name in ("config2", "config4"):
                for who in ("parent", "change"):
                    rates = [r[name]["rate"] for w, r in res if w == who]
                    busy = [r[name]["busy"] for w, r in res if w == who]
                    lps = [r[name]["launches_step"] for w, r in res
                           if w == who]
                    firsts = [r[name]["first"] for w, r in res if w == who]
                    print(f"13b: {name} generic, {who} (turns parent, "
                          f"change, change, parent): moves/s {rates}, "
                          f"launches a step {lps}, busy {busy}, first "
                          f"short run {firsts} s [{card}]")
        streams_card_vs_cpu(tmc, device, tmp, card)
        n_mesh = streams_mesh(tmc, tmp, card)
    return dict(err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=by,
                launches=n_main + n_mesh, mesh_launches=n_mesh, bench=bench)


# -- phase 14: every sampler on the reference's per-chain keys ----------------

# 14a: the threefry kernel's split_uniform mode at the soft-potential event
# loop's shape (one key a chain of 14c's LJ pool, 64 x N 64) and at 10^7
# values (10^4 keys x 1000)
SPLIT_UNIFORM = dict(loop=(64, 64), big=(10 ** 4, 1000), reps=200,
                     big_reps=20, plain_reps=20, big_plain_reps=1)
# 14b: each sampler from one seed on the card and on the CPU, at the CPU
# tests' sizes (tests/test_torch_sampler_streams.py), a few steps each
TWIN_STEPS = 4
# a tie flipped at an ulp may send one chain (a swapped pair: two) its own
# way; more is a fault
TWIN_MAX_FLIPPED = 2
# 14c: each path at the width its phase uses, cut in depth (steps a timed
# run; a warm-up run and a profiled step besides): the cell path at phase
# 7's 32 x N 32768, four segments of 2 steps (~28 substeps each);
# hard-disk ECMC at tools/bench_ecmc.py 64 0.70 and LJ ECMC at
# tools/bench_ecmc_lj.py's 64 x N 64 (phase 10a, 10d); the
# checkerboard at tools/bench_ising2d.py's 1024 x 64^2 (11a); XY and
# Heisenberg at 1024 x 64^2 with over-relaxation (12a, 12b); Wang-Landau at
# examples/wang_landau_ising.py's widths (12d); replica exchange at 10c's
SAMPLER_BENCH = dict(cell_steps=2, cell_calls=4, ecmc_steps=2,
                     checkerboard_steps=60, spin_steps=24, wl_steps=200,
                     tempering_steps=5000)
THREEFRY_OPS["split_uniform"] = 2 * 79 + 16   # two blocks and the finish
TINY32 = float(np.finfo(np.float32).tiny)


def split_uniform_vs_plain(device, card):
    """14a: the split_uniform mode against its plain twin, bit for bit (the
    successor keys and the values), at the event loop's shape and at 10^7
    values; returns the loop shape's (max |error|, kernel ms, plain ms,
    (bound ms, bound by))."""
    import torch
    from montecarlo_tpu_torch.ops.threefry import threefry
    from montecarlo_tpu_torch.utils import prng
    c = SPLIT_UNIFORM
    out = None
    for label, (b, n), reps, plain_reps in (
            ("the LJ event loop's shape", c["loop"], c["reps"],
             c["plain_reps"]),
            ("10^7 values", c["big"], c["big_reps"], c["big_plain_reps"])):
        keys = prng.split(prng.key(SEED + 14, device), b)
        call = lambda interpret=False: threefry(
            keys, n, "split_uniform", lo=TINY32, hi=1.0, interpret=interpret)
        nk, got = call()
        pk, want = call(True)
        torch.cuda.synchronize()
        check(torch.equal(nk, pk) and torch.equal(got, want),
              f"14a: split_uniform at {b} x {n} differs from its plain twin")
        err = float((got - want).abs().max())
        k_ms = cuda_time(call, reps)
        p_ms = cuda_time(lambda: call(True), plain_reps, warm=False)
        # each key read once, its successor and the values written once
        b_ms, by = bound(16 * b + 4 * b * n,
                         b * n * THREEFRY_OPS["split_uniform"])
        print(f"14a: threefry split_uniform at {label} ({b} keys x {n} "
              f"values): successors and values bit for bit against the "
              f"plain twin; {k_ms!r} ms a launch, plain {p_ms!r} ms, bound "
              f"{b_ms!r} ms (by {by}): {100 * b_ms / k_ms!r} % of the "
              f"bound's rate; no PyTorch call computes threefry2x32 "
              f"[{card}]")
        if out is None:
            out = (err, k_ms, p_ms, (b_ms, by))
    return out


def _twin_builders():
    """14b's runs: name -> (build(tmc, device) -> (system, chains,
    algorithms), the state's periodic fields)."""
    from montecarlo_tpu_torch.models import hard_disks as hd
    from montecarlo_tpu_torch.models import heisenberg as hb
    from montecarlo_tpu_torch.models import ising2d
    from montecarlo_tpu_torch.models import lennard_jones as lj
    from montecarlo_tpu_torch.models import particle1d as p1d
    from montecarlo_tpu_torch.models import polydisperse as poly
    from montecarlo_tpu_torch.models import potts, tfim, xy

    def i2(cls, size, **kw):
        return lambda tmc, dev: (
            ising2d.make_system(),
            ising2d.init_chains(8, size, 0.44, seed=3, device=dev),
            [dict(algorithm=getattr(ising2d, cls), seed=5, **kw)])

    def pt(factory, q, size, **kw):
        return lambda tmc, dev: (
            potts.make_system(q),
            potts.init_chains(8, size, q, 0.9, seed=3, device=dev),
            [dict(algorithm=getattr(potts, factory)(q), seed=5, **kw)])

    def ecmc(mod, init, model):
        return lambda tmc, dev: (
            mod.make_system(mod.harmonic) if mod is p1d else
            mod.make_system(), init(dev),
            [dict(algorithm=tmc.EventChain, model=model(),
                  events_per_step=2, seed=11)])

    def wang_landau(tmc, dev):
        return (ising2d.make_system(),
                ising2d.init_chains(8, 4, 1.0, seed=3, device=dev),
                [dict(algorithm=tmc.WangLandau, model=ising2d.wl_model(4),
                      moves_per_step=16, seed=9),
                 dict(algorithm=tmc.WangLandauRefine, flatness=0.5,
                      log_f_min=1e-4, dependencies=(tmc.WangLandau,),
                      scheduler=np.arange(2, TWIN_STEPS + 1, 2))])

    def tempering(tmc, dev):
        return (p1d.make_system(p1d.harmonic),
                p1d.init_chains(16, beta=tmc.tile_ladder(
                    [0.5, 1.0, 2.0, 4.0], 4, device=dev), seed=3,
                    device=dev),
                [dict(algorithm=tmc.Metropolis,
                      pool=(p1d.displacement_move(0.8),), seed=2,
                      fused="off"),
                 dict(algorithm=tmc.ReplicaExchange, n_temps=4, seed=5)])

    def cell_lj(tmc, dev):
        return (lj.make_system(),
                lj.init_chains(4, 256, rho=1.0, beta=1.0, frac_b=0.2,
                               seed=6, device=dev),
                [dict(algorithm=tmc.Metropolis,
                      pool=(lj.lj_displacement_move(0.1, weight=0.8),
                            lj.lj_swap_move(weight=0.2)),
                      seed=3, sweepstep=64, fused="cell")])

    def cell_npt(tmc, dev):
        return (poly.make_system(),
                poly.init_chains(2, 512, rho=0.6, beta=1.0 / 0.4, seed=21,
                                 device=dev),
                [dict(algorithm=tmc.Metropolis,
                      pool=(poly.displacement_move(0.08, weight=0.75),
                            poly.swap_move(weight=0.2),
                            poly.volume_move(0.002, 4.0, weight=0.05)),
                      seed=4, sweepstep=64, fused="cell")])

    return {
        "ising2d checkerboard": (i2("CheckerboardMetropolis", 6, sweeps=2),
                                 ()),
        "ising2d wolff": (i2("WolffCluster", 5, clusters=2), ()),
        "ising2d swendsen-wang": (i2("SwendsenWang", 5, sweeps=2), ()),
        "potts checkerboard": (pt("CheckerboardPotts", 3, 6), ()),
        "potts wolff": (pt("WolffPotts", 3, 5, clusters=2), ()),
        "potts swendsen-wang": (pt("SwendsenWangPotts", 4, 5, sweeps=2),
                                ()),
        "xy checkerboard": (lambda tmc, dev: (
            xy.make_system(), xy.init_chains(8, 6, 1.0, seed=3, device=dev),
            [dict(algorithm=xy.CheckerboardXY, sweeps=2, delta=1.2,
                  seed=5)]), ("theta",)),
        "heisenberg checkerboard": (lambda tmc, dev: (
            hb.make_system(), hb.init_chains(8, 6, 1.0, seed=3, device=dev),
            [dict(algorithm=hb.CheckerboardHeisenberg, sweeps=2, delta=0.8,
                  seed=5)]), ()),
        "tfim checkerboard": (lambda tmc, dev: (
            tfim.make_system(),
            tfim.init_chains(8, 4, 8, 2.0, seed=3, device=dev),
            [dict(algorithm=tfim.TFIMCheckerboard, sweeps=2, seed=5)]), ()),
        "wang-landau": (wang_landau, ()),
        "ecmc zig-zag": (ecmc(p1d, lambda dev: p1d.init_chains(
            16, beta=2.0, seed=3, device=dev), p1d.zigzag_model), ()),
        "ecmc hard disks": (ecmc(hd, lambda dev: hd.init_chains(
            3, 30, 0.5, seed=42, device=dev), lambda: hd.ecmc_model(
                1.0, max_events_per_chain=512)), ("pos",)),
        "ecmc lj": (ecmc(lj, lambda dev: lj.init_chains(
            3, 20, 0.7, 1.0, frac_b=0.2, seed=5, device=dev),
            lambda: lj.ecmc_model(1.5)), ("pos",)),
        "ecmc poly": (ecmc(poly, lambda dev: poly.init_chains(
            3, 25, 0.9, 2.0, seed=2, device=dev),
            lambda: poly.ecmc_model(1.0)), ("pos",)),
        "replica exchange": (tempering, ()),
        "cell path lj": (cell_lj, ("pos",)),
        "cell path poly npt": (cell_npt, ("pos",)),
    }


def _twin_run(tmc, build, dev, steps, root):
    import torch
    system, chains, algos = build(tmc, dev)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=root) as tmp:
        sim = tmc.Simulation(system, chains, algos, steps, path=tmp)
        sim.run()
    torch.cuda.synchronize()
    return state_arrays(sim.device_state)


def _twin_compare(a, b, periodic):
    """(the rows of the chain-major leaves that differ, the largest float
    difference on the other rows, the leaves' names that differ) between
    the card's arrays ``a`` and the CPU's ``b``; floats within 1e-5 plus
    rtol 1e-5, integers equal, periodic fields (angles, positions) up to a
    period (2 pi; a box)."""
    bad_rows, bad_leaves, worst = set(), [], 0.0
    box = max((float(np.max(v)) for k, v in b.items()
               if k.endswith("/box")), default=None)
    for k, w in b.items():
        g = a[k]
        if g.shape != w.shape:
            bad_leaves.append(k)
            continue
        if np.issubdtype(w.dtype, np.floating):
            d = np.abs(g.astype(np.float64) - w.astype(np.float64))
            field = k.rsplit("/", 1)[-1]
            if field in periodic:
                period = 2 * np.pi if field == "theta" else box
                d = np.minimum(d, np.abs(period - d))
            off = d > 1e-5 + 1e-5 * np.abs(w.astype(np.float64))
        else:
            d = None
            off = g != w
        if off.any():
            if off.ndim and w.shape[0] > 1:
                rows = np.nonzero(off.reshape(w.shape[0], -1).any(1))[0]
                bad_rows.update(int(r) for r in rows)
            else:
                bad_leaves.append(k)
        if d is not None and d.size:
            keep = ~off.reshape(w.shape[0], -1).any(1) if off.ndim else None
            dd = d.reshape(w.shape[0], -1)[keep] if keep is not None else d
            if dd.size:
                worst = max(worst, float(dd.max()))
    return sorted(bad_rows), worst, bad_leaves


def samplers_card_vs_cpu(tmc, device, root, card):
    """14b: each sampler from one seed on the card and on the CPU: counters
    and discrete states equal, continuous ones within 1e-5 (energies rtol
    1e-5).  Where a chain went its own way, the first step at which it did
    is found (runs of 1, 2, ... steps) and printed with how far the two
    devices' states were apart before it, the accept test's margin there;
    at most TWIN_MAX_FLIPPED chains a sampler, and none once more than one
    sampler flipped."""
    import torch
    cpu = torch.device("cpu")
    flipped = 0
    worst_all = 0.0
    for name, (build, periodic) in _twin_builders().items():
        a = _twin_run(tmc, build, device, TWIN_STEPS, root)
        b = _twin_run(tmc, build, cpu, TWIN_STEPS, root)
        rows, worst, leaves = _twin_compare(a, b, periodic)
        check(not leaves, f"14b: {name}: {leaves} differ on the card and "
              f"on the CPU")
        if rows:
            flipped += 1
            first, before = None, 0.0
            for j in range(1, TWIN_STEPS + 1):
                aj = _twin_run(tmc, build, device, j, root)
                bj = _twin_run(tmc, build, cpu, j, root)
                rj, wj, _ = _twin_compare(aj, bj, periodic)
                if rj:
                    first = j
                    break
                before = wj
            print(f"14b: {name}: chains {rows} went their own way at step "
                  f"{first} of {TWIN_STEPS}, the two devices' states "
                  f"{before!r} apart before it (an accept test tied at that "
                  f"margin); the other chains within {worst!r} [{card}]")
            check(len(rows) <= TWIN_MAX_FLIPPED and flipped <= 1
                  and before <= 1e-5,
                  f"14b: {name}: {len(rows)} chains differ on the card "
                  f"and on the CPU (samplers with a flip: {flipped})")
        worst_all = max(worst_all, worst)
        print(f"14b: {name}, {TWIN_STEPS} steps from one seed: card and CPU "
              f"{'equal but for the flip above' if rows else 'equal'} "
              f"(counters and discrete states exactly, the rest within "
              f"{worst!r}) [{card}]")
    return worst_all


class _IterationCounter:
    """Counts the event loops' iterations (``core.ecmc.event_loop``'s
    ``body`` calls) while installed."""

    def __init__(self, ecmc):
        self.ecmc, self.n = ecmc, 0
        self.orig = ecmc.event_loop

    def __enter__(self):
        orig = self.orig

        def counted(body, carry, active, *args, **kw):
            def wrapped(c, i):
                self.n += 1
                return body(c, i)
            return orig(wrapped, carry, active, *args, **kw)

        self.ecmc.event_loop = counted
        return self

    def __exit__(self, *exc):
        self.ecmc.event_loop = self.orig


def samplers_bench(tmc, device, root, card):
    """14c on the package ``tmc`` (this tree's, or another's in a child
    process): each keyed path at its phase's width, cut in depth; {path:
    {wall, units, rate, unit, launches_unit, busy}}.  A warm-up run, the
    timed run from an idle card to an idle card, then one more step under
    ``torch.profiler`` for the launches a unit and the busy share."""
    import torch
    from montecarlo_tpu_torch.core import ecmc as ecmc_mod
    from montecarlo_tpu_torch.models import hard_disks as hd
    from montecarlo_tpu_torch.models import heisenberg as hb
    from montecarlo_tpu_torch.models import ising2d
    from montecarlo_tpu_torch.models import lennard_jones as lj
    from montecarlo_tpu_torch.models import particle1d as p1d
    from montecarlo_tpu_torch.models import xy
    c = SAMPLER_BENCH
    out = {}

    def record(name, wall, units, unit, launches, per, busy):
        out[name] = dict(wall=wall, units=units, rate=units / wall,
                         unit=unit, launches=launches, per=per, busy=busy)

    def sim_of(system, chains, algos, steps, name):
        return tmc.Simulation(system, chains, algos, steps,
                              path=os.path.join(root, name))

    # the cell path: segments of the cell route at phase 7's width, timed
    # through the algorithm's own advance (no recorder, so no O(N^2)
    # refresh); a unit is a substep
    cm = CELL_MAIN
    chains = lj.init_chains(cm["chains"], cm["n"], rho=cm["rho"],
                            beta=cm["beta"], frac_b=cm["frac_b"], seed=42,
                            device=device)
    sim = sim_of(lj.make_system(), chains, [
        dict(algorithm=tmc.Metropolis,
             pool=(lj.lj_displacement_move(cm["sigma"]),), seed=42,
             sweepstep=cm["n"] // 4, fused="cell")], c["cell_steps"], "cell")
    met = sim.device_algos[0]
    check(met._use_cell, "14c: the cell path not taken")
    per = met._cell_plan.nc ** 2 // 4
    ds = met.fused_advance(sim.init_device_state(), 1)
    torch.cuda.synchronize()

    def substeps(d):
        return float(d["metropolis"]["counters"][:, 0, 1].double().mean()
                     ) / per

    s0 = substeps(ds)
    t0 = time.perf_counter()
    for _ in range(c["cell_calls"]):
        ds = met.fused_advance(ds, c["cell_steps"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_sub = substeps(ds) - s0
    box = {}
    busy, launches = _busy_share(
        lambda: box.update(ds=met.fused_advance(ds, 1)), card,
        "14c cell path, one step")
    record("cell", wall, n_sub, "substep",
           launches / (substeps(box["ds"]) - substeps(ds)), "a substep",
           busy)

    # event-chain MC: hard disks (10a) and LJ (10d); a unit is an event (a
    # collision, as 10a counts them); launches an iteration of the loops
    for name, mod, chains, model, events in (
            ("ecmc_hard_disks", hd,
             hd.init_chains(ECMC_HD["chains"], ECMC_HD["n"],
                            eta=ECMC_HD["eta"], seed=42, device=device),
             None, ECMC_HD["events"]),
            ("ecmc_lj", lj,
             lj.init_chains(64, ECMC_LJ["n"], rho=ECMC_LJ["rho"], beta=1.0,
                            frac_b=0.0, seed=42, device=device),
             lj.ecmc_model(ECMC_LJ["ell"], max_events_per_chain=512),
             ECMC_LJ["events"])):
        if model is None:
            model = hd.ecmc_model(float(chains.box[0]) / 2.0,
                                  max_events_per_chain=ECMC_HD["cap"])
        algos = [dict(algorithm=tmc.EventChain, model=model,
                      events_per_step=events, seed=7)]
        warm = sim_of(mod.make_system(), chains, algos, 1, name + "_warm")
        warm.run()
        sim = sim_of(mod.make_system(), warm.device_state["sys"], algos,
                     c["ecmc_steps"], name)
        wall = timed_run(sim)
        stats = sim.device_state["ecmc"]["stats"]
        n_events = int(stats["collisions"].sum())
        check(int(stats["cap_hits"].sum()) == 0, f"14c: {name} cap hits")
        alg, ds = sim.device_algos[0], sim.device_state
        with _IterationCounter(ecmc_mod) as it:
            busy, launches = _busy_share(
                lambda: alg.step(ds, c["ecmc_steps"] + 1), card,
                f"14c {name}, one step")
        record(name, wall, n_events, "event", launches / max(it.n, 1),
               f"a loop iteration ({it.n} iterations a step)", busy)

    # the lattices: the checkerboard (11a), XY and Heisenberg (12a, 12b);
    # a unit is a spin-update attempt, launches counted a sweep
    for name, mod, algo, kw, steps in (
            ("checkerboard", ising2d, ising2d.CheckerboardMetropolis,
             dict(sweeps=CHECKERBOARD["sweeps"]), c["checkerboard_steps"]),
            ("xy", xy, xy.CheckerboardXY,
             dict(sweeps=SPIN_CB["sweeps"], overrelax=SPIN_CB["overrelax"],
                  delta=SPIN_CB["delta"]), c["spin_steps"]),
            ("heisenberg", hb, hb.CheckerboardHeisenberg,
             dict(sweeps=SPIN_CB["sweeps"], overrelax=SPIN_CB["overrelax"],
                  delta=SPIN_CB["delta"]), c["spin_steps"])):
        width = CHECKERBOARD if name == "checkerboard" else SPIN_CB
        chains = mod.init_chains(width["chains"], width["size"],
                                 beta=width["beta"], seed=42, device=device)
        algos = [dict(algorithm=algo, seed=42, **kw)]
        sim_of(mod.make_system(), chains, algos, 1, name + "_warm").run()
        sim = sim_of(mod.make_system(), chains, algos, steps, name)
        wall = timed_run(sim)
        alg, ds = sim.device_algos[0], sim.device_state
        busy, launches = _busy_share(lambda: alg.step(ds, steps + 1), card,
                                     f"14c {name}, one step")
        record(name, wall, width["chains"] * width["size"] ** 2
               * kw["sweeps"] * steps, "attempt", launches / kw["sweeps"],
               "a sweep", busy)

    # Wang-Landau at the example's widths (12d); a unit is a proposal
    w = WL
    steps = c["wl_steps"]
    wl_algos = [dict(algorithm=tmc.WangLandau,
                     model=ising2d.wl_model(w["size"]),
                     moves_per_step=w["size"] ** 2, seed=3)]
    chains = ising2d.init_chains(w["chains"], w["size"], beta=1.0, seed=3,
                                 device=device)
    sim_of(ising2d.make_system(), chains, wl_algos, 2, "wl_warm").run()
    sim = sim_of(ising2d.make_system(), chains, wl_algos, steps, "wl")
    wall = timed_run(sim)
    alg, ds = sim.device_algos[0], sim.device_state
    busy, launches = _busy_share(lambda: alg.step(ds, steps + 1), card,
                                 "14c Wang-Landau, one step")
    record("wang_landau", wall, w["chains"] * w["size"] ** 2 * steps,
           "proposal", launches / w["size"] ** 2, "a proposal", busy)

    # replica exchange between segments of kernel #1 (10c's width); a unit
    # is a chain's step, launches counted a swap call (its segment's one
    # launch of kernel #1 included)
    t = TEMPERING
    steps = c["tempering_steps"]
    t_n = len(t["betas"])

    def tempering_sim(n_steps, name):
        betas = tmc.tile_ladder(t["betas"], t["ladders"], device=device)
        return sim_of(p1d.make_system(), p1d.init_chains(
            t_n * t["ladders"], beta=betas, seed=42, device=device), [
            dict(algorithm=tmc.Metropolis,
                 pool=(p1d.displacement_move(sigma=1.0),), seed=42),
            dict(algorithm=tmc.ReplicaExchange, n_temps=t_n, seed=5,
                 scheduler=np.arange(t["every"], n_steps + 1,
                                     t["every"]))], n_steps, name)

    tempering_sim(10 * t["every"], "tempering_warm").run()
    sim = tempering_sim(steps, "tempering")
    wall = timed_run(sim)
    prof = tempering_sim(10 * t["every"], "tempering_prof")
    busy, launches = _busy_share(prof.run, card, "14c replica exchange, 10 "
                                 "swap calls and their segments")
    record("tempering", wall, t_n * t["ladders"] * steps, "chain step",
           launches / 10, "a swap call and its segment", busy)
    cnt = sim.device_state["replica_exchange"]["counters"]
    check(int(cnt[:, 0].sum()) > 0, "14c: no swap accepted")
    for name, r in out.items():
        print(f"14c: {name}: {r['units']!r} {r['unit']}s in {r['wall']!r} "
              f"s, {r['rate']!r} {r['unit']}s/s, {r['launches']!r} launches "
              f"{r['per']}, the card {100 * r['busy']!r} % busy [{card}]")
    return out


def samplers_bench_tree(tree):
    """14c run by a child process on the package in ``tree``: its
    result."""
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--samplers-bench",
         tree], capture_output=True, text=True, timeout=900)
    check(out.returncode == 0, f"14c on {tree}: {out.stderr[-3000:]}")
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("SAMPLERS_BENCH ")][-1]
    return json.loads(line.split(" ", 1)[1])


def sampler_phases(tmc, device, kernels, card, parent_tree=None):
    """Phase 14 (14a-14c); returns the threefry launches of 14c's runs (all
    modes, and split_uniform's) and the split_uniform row's numbers."""
    from montecarlo_tpu_torch.ops.threefry import (LAUNCHES_BY_MODE,
                                                   THREEFRY_KERNEL)
    err, k_ms, p_ms, (b_ms, by) = split_uniform_vs_plain(device, card)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=ROOT) as tmp:
        worst = samplers_card_vs_cpu(tmc, device, tmp, card)
        for k in kernels:
            k.launches = 0
        THREEFRY_KERNEL.launches = 0
        for mode in LAUNCHES_BY_MODE:
            LAUNCHES_BY_MODE[mode] = 0
        bench = samplers_bench(tmc, device, tmp, card)
        n_main = THREEFRY_KERNEL.launches
        n_split = LAUNCHES_BY_MODE["split_uniform"]
        by_mode = {m: n for m, n in LAUNCHES_BY_MODE.items() if n}
        row_counts = {k.symbol: k.launches for k in kernels}
        print(f"main path: 14c's keyed samplers launched threefry {n_main} "
              f"times ({by_mode}), the row kernels {row_counts} (kernel #1 "
              f"by replica exchange's segments)")
        check(n_main > 0 and n_split > 0,
              "14c: the keyed samplers did not launch threefry and its "
              "split_uniform mode")
        check(not any(n for k, n in row_counts.items()
                      if k != kernels[0].symbol),
              "14c: a sampler launched a particle row kernel")
        if parent_tree is not None:
            turns = [("parent", parent_tree), ("change", ROOT),
                     ("change", ROOT), ("parent", parent_tree)]
            res = [(who, samplers_bench_tree(tree)) for who, tree in turns]
            for name in bench:
                line = {}
                for who in ("parent", "change"):
                    rs = [r[name] for w, r in res if w == who]
                    line[who] = ([r["rate"] for r in rs],
                                 [r["launches"] for r in rs],
                                 [r["busy"] for r in rs])
                ratio = np.mean(line["change"][0]) / np.mean(
                    line["parent"][0])
                print(f"14c: {name} (turns parent, change, change, parent; "
                      f"{bench[name]['unit']}s/s, launches a unit, busy): "
                      f"parent {line['parent']}, change {line['change']}; "
                      f"change / parent {ratio!r} [{card}]")
    print(f"14: every sampler from one seed on the card equals the CPU's "
          f"(worst continuous difference {worst!r}); split_uniform bit for "
          f"bit [{card}]")
    return dict(launches=n_main, split_launches=n_split, err=err, ms=k_ms,
                plain_ms=p_ms, bound_ms=b_ms, bound_by=by, bench=bench)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", metavar="CSRC_DIR", default=None,
                        help="an earlier csrc/ (commit e6e7854's interface) "
                             "to compare and time against")
    parser.add_argument("--kernels-only", action="store_true",
                        help="stop after the kernels' checks (phase 4)")
    parser.add_argument("--cell-only", action="store_true",
                        help="after the build, run only the cell path's "
                             "phase 7")
    parser.add_argument("--npt-only", action="store_true",
                        help="after the build, run only phase 8 (NPT and "
                             "3-D)")
    parser.add_argument("--mesh-only", action="store_true",
                        help="after the build, run only phase 9 (the chain "
                             "mesh)")
    parser.add_argument("--ecmc-only", action="store_true",
                        help="after the build, run only phase 10 (event-"
                             "chain MC and replica exchange)")
    parser.add_argument("--lattice-only", action="store_true",
                        help="after the build, run only phase 11 (the "
                             "lattice models)")
    parser.add_argument("--spins-only", action="store_true",
                        help="after the build, run only phase 12 (the "
                             "continuous and quantum lattice models and "
                             "Wang-Landau)")
    parser.add_argument("--streams-only", action="store_true",
                        help="after the build, run only phase 13 (the "
                             "threefry streams)")
    parser.add_argument("--samplers-only", action="store_true",
                        help="after the build, run only phase 14 (every "
                             "sampler on per-chain keys)")
    parser.add_argument("--energy-only", action="store_true",
                        help="after the build, run only phase 4c (the LJ "
                             "energy kernel)")
    parser.add_argument("--parent-tree", metavar="TREE", default=None,
                        help="a checkout of an earlier commit whose generic "
                             "path (phase 13b) and keyed samplers (14c) are "
                             "timed against this one's, in turns")
    # phase 13b on the package of another tree, in a child process
    parser.add_argument("--streams-bench", metavar="TREE", default=None,
                        help=argparse.SUPPRESS)
    # phase 14c on the package of another tree, in a child process
    parser.add_argument("--samplers-bench", metavar="TREE", default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--nccl-pair", action="store_true",
                        help="after the build, only try two nccl ranks on "
                             "the one card and print what NCCL does (not a "
                             "phase)")
    # one rank of phase 9, started by the script itself
    for flag, kind in (("--mesh-rank", int), ("--mesh-world", int),
                       ("--mesh-port", int), ("--mesh-backend", str),
                       ("--mesh-root", str), ("--mesh-runs", str)):
        parser.add_argument(flag, type=kind, default=None,
                            help=argparse.SUPPRESS)
    opts = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    if opts.mesh_rank is not None:
        return mesh_worker(opts)
    if opts.streams_bench is not None:
        tree = os.path.abspath(opts.streams_bench)
        sys.path.insert(0, tree)
        import montecarlo_tpu_torch as tmc
        check(os.path.abspath(tmc.__file__).startswith(tree + os.sep),
              f"13b: imported {tmc.__file__}, not the package in {tree}")
        with tempfile.TemporaryDirectory(prefix=".chip_smoke-",
                                         dir=ROOT) as tmp:
            res = generic_bench(tmc, torch.device("cuda", 0), tmp,
                                card_line())
        print("STREAMS_BENCH " + json.dumps(res))
        return 0
    if opts.samplers_bench is not None:
        tree = os.path.abspath(opts.samplers_bench)
        sys.path.insert(0, tree)
        import montecarlo_tpu_torch as tmc
        check(os.path.abspath(tmc.__file__).startswith(tree + os.sep),
              f"14c: imported {tmc.__file__}, not the package in {tree}")
        with tempfile.TemporaryDirectory(prefix=".chip_smoke-",
                                         dir=ROOT) as tmp:
            res = samplers_bench(tmc, torch.device("cuda", 0), tmp,
                                 card_line())
        print("SAMPLERS_BENCH " + json.dumps(res))
        return 0
    sys.path.insert(0, ROOT)
    import montecarlo_tpu_torch as tmc
    from montecarlo_tpu_torch.core.simulation import _select_advance
    from montecarlo_tpu_torch.models import particle1d as p1d
    from montecarlo_tpu_torch.ops.fused_sweep import SWEEP_KERNEL
    from montecarlo_tpu_torch.ops.cell_mc import CELL_SUBSTEP_KERNEL
    from montecarlo_tpu_torch.ops.lj_energy import LJ_ENERGY_KERNEL
    from montecarlo_tpu_torch.ops.lj_sweep import LJ_KERNEL, LJ_MIXED_KERNEL
    from montecarlo_tpu_torch.ops.poly_sweep import POLY_KERNEL
    from montecarlo_tpu_torch.ops.threefry import THREEFRY_KERNEL
    kernels = (SWEEP_KERNEL, LJ_KERNEL, LJ_MIXED_KERNEL, POLY_KERNEL)

    start = time.perf_counter()

    def elapsed(what):
        print(f"time: {what} done, {time.perf_counter() - start!r} s into "
              f"the script's phases")

    # 1. device
    device = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)")

    # 2. build, one nvcc per source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=6) as pool:
        list(pool.map(lambda k: k.build(),
                      (SWEEP_KERNEL, LJ_KERNEL, POLY_KERNEL,
                       THREEFRY_KERNEL, LJ_ENERGY_KERNEL,
                       CELL_SUBSTEP_KERNEL)))
    for k in kernels + (THREEFRY_KERNEL, LJ_ENERGY_KERNEL,
                        CELL_SUBSTEP_KERNEL):
        k.build()
        print(f"build: {k.symbol} from {k.library_path()} "
              f"(nvcc wall {k.build_seconds!r} s)")
    print(f"build: all kernels ready in {time.perf_counter() - t0!r} s")

    if opts.cell_only:
        cell_phases(tmc, device, kernels, card)
        print("chip_smoke: --cell-only: stopping after phase 7")
        return 0
    if opts.npt_only:
        npt_phases(tmc, device, kernels, card)
        print("chip_smoke: --npt-only: stopping after phase 8")
        return 0
    if opts.mesh_only:
        mesh_phases(tmc, device, kernels, card)
        print("chip_smoke: --mesh-only: stopping after phase 9")
        return 0
    if opts.ecmc_only:
        ecmc_phases(tmc, device, kernels, card)
        print("chip_smoke: --ecmc-only: stopping after phase 10")
        return 0
    if opts.lattice_only:
        lattice_phases(tmc, device, kernels, card)
        print("chip_smoke: --lattice-only: stopping after phase 11")
        return 0
    if opts.spins_only:
        spin_phases(tmc, device, kernels, card)
        print("chip_smoke: --spins-only: stopping after phase 12")
        return 0
    if opts.streams_only:
        streams_phases(tmc, device, kernels, card, opts.parent_tree)
        print("chip_smoke: --streams-only: stopping after phase 13")
        return 0
    if opts.samplers_only:
        sampler_phases(tmc, device, kernels, card, opts.parent_tree)
        print("chip_smoke: --samplers-only: stopping after phase 14")
        return 0
    if opts.nccl_pair:
        nccl_pair(card)
        return 0
    if opts.energy_only:
        lj_energy_vs_plain(device, card)
        print("chip_smoke: --energy-only: stopping after phase 4c")
        return 0

    parent = None
    if opts.parent is not None:
        os.makedirs(os.path.dirname(SWEEP_KERNEL.library_path()),
                    exist_ok=True)
        parent = EarlierKernels(
            opts.parent, os.path.dirname(SWEEP_KERNEL.library_path()))

    # 3. the Gaussian kernel against its plain version
    potentials = (p1d.harmonic, p1d.double_well)
    max_err = kernel_vs_plain(device, potentials, parent)
    lanes_invariance(device, potentials)
    segmentation(device, potentials)

    # 4. the LJ kernels against their plain versions
    lj_err = lj_kernels_vs_plain(device, parent)
    lj_segmentation(device)

    # 4b. the poly kernel against its plain version
    poly_err = poly_kernel_vs_plain(device, parent)
    poly_segmentation(device)

    # 4c. the LJ energy kernel against the plain O(N^2) energy
    energy = lj_energy_vs_plain(device, card)

    if parent is not None:
        earlier_vs_present(parent, device, card)
    if opts.kernels_only:
        print("chip_smoke: --kernels-only: stopping before the main paths")
        return 0

    # 5. the main paths; each reads only its own launches
    def zero_counts():
        for k in kernels + (LJ_ENERGY_KERNEL,):
            k.launches = 0

    launches, walls = {}, {}
    with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=ROOT) as tmp:
        zero_counts()
        config1(tmc, p1d, os.path.join(tmp, "config1"))
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
            # init_chains' energies, then one launch a refresh
            n_energy = sim.counters.launches.get(LJ_ENERGY_KERNEL.symbol)
            print(f"main path: {LJ_ENERGY_KERNEL.symbol} launched "
                  f"{LJ_ENERGY_KERNEL.launches} times, {n_energy} in the run "
                  f"of {sim.counters.periods} refreshes")
            check(n_energy == sim.counters.periods > 0
                  and LJ_ENERGY_KERNEL.launches == n_energy + 1,
                  f"{name}: {LJ_ENERGY_KERNEL.launches} energy launches, "
                  f"{n_energy} in the run, {sim.counters.periods} refreshes")
            launches["lj_total_energy"] = (launches.get("lj_total_energy", 0)
                                           + LJ_ENERGY_KERNEL.launches)
            walls[name] = (wall, kernel.launches)
            lj_main_checks(sim, device, path, cfg, mixed, wall)
        path = os.path.join(tmp, "poly")
        zero_counts()
        sim, chains, wall_poly = poly_main(tmc, device, path)
        counts = {k.symbol: k.launches for k in kernels}
        print(f"main path: poly launches {counts}")
        check(POLY_KERNEL.launches > 0,
              "the main path did not launch fused_poly_mixed_sweep")
        n_poly = launches["fused_poly_mixed_sweep"] = POLY_KERNEL.launches
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

        # 5g. the poly pool and the one-move LJ pool with PGMC
        for kind, name, kernel in (
                ("poly", "fused_poly_mixed_sweep", POLY_KERNEL),
                ("lj", "fused_lj_sweep", LJ_KERNEL)):
            path = os.path.join(tmp, f"pgmc_{kind}")
            sim = pgmc_pool_sim(tmc, device, path, kind)
            check("hybrid" in _select_advance(sim).__qualname__,
                  f"the {kind} pool with PGMC did not take the hybrid "
                  f"stepper")
            wall, counts = counted(kernels, lambda: timed_run(sim))
            n_seg = sync_points(sim)
            print(f"main path: the {kind} pool with PGMC launches {counts}, "
                  f"{n_seg} segments between events and recorder points")
            check(counts[kernel.symbol] == n_seg
                  and sum(counts.values()) == n_seg,
                  f"the {kind} pool with PGMC: {counts} for {n_seg} "
                  f"segments")
            launches[name] += counts[kernel.symbol]
            pgmc_pool_checks(sim, kind, path, wall, card)
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
    for name, cfg, label in (("fused_lj_sweep", CONFIG4, "config 4"),
                             ("fused_lj_mixed_sweep", POOL5,
                              "config-5 pool")):
        wall, n_seg = walls[name]
        seg_ms = lj_ms[name][("kernel", 10 * cfg["n"])]
        steps = cfg["n"] * cfg["sweeps"]
        # the pool's first segment is shorter than the others: by steps
        in_kernel = seg_ms * steps / (10 * cfg["n"]) / 1e3
        print(f"time: {label} breakdown: {n_seg} kernel launches, {steps} "
              f"steps at {seg_ms!r} ms per {10 * cfg['n']} = {in_kernel!r} s "
              f"of {wall!r} s wall ({100 * in_kernel / wall!r} % in the "
              f"kernel) [{card}]")
    pgmc5_breakdown(sim5, n5, lj_ms["fused_lj_mixed_sweep"][
        ("kernel", 10 * POOL5["n"])], wall5, card)
    poly_ms = poly_times(device, card)
    seg = POLY["stride"] * POLY["n"]
    print(f"time: poly path breakdown: {n_poly} kernel launches x "
          f"{poly_ms[('kernel', seg)]!r} ms = "
          f"{n_poly * poly_ms[('kernel', seg)] / 1e3!r} s and "
          f"{n_poly} refreshes x {poly_ms['refresh']!r} ms of "
          f"{wall_poly!r} s wall, "
          f"{POLY['chains'] * POLY['n'] * POLY['sweeps'] / wall_poly!r}"
          f" moves/s with recorders [{card}]")
    elapsed("phases 1-6")
    # 7. the cell path: the substep kernel, the row kernels not launched
    n_cell, cell_ms = cell_phases(tmc, device, kernels, card)
    elapsed("phase 7")
    # 8. NPT and 3-D: the cell and generic paths, no kernel launched
    npt_phases(tmc, device, kernels, card)
    elapsed("phase 8")
    # 9. the chain mesh: the sharded entry points, ranks on the one card
    mesh_err, mesh_launches = mesh_phases(tmc, device, kernels, card)
    elapsed("phase 9")
    # 10. event-chain MC and replica exchange, the latter on kernel #1
    n_tempering, n_mh_lj = ecmc_phases(tmc, device, kernels, card)
    launches["fused_gaussian_sweep"] += n_tempering
    launches["fused_lj_sweep"] += n_mh_lj
    elapsed("phase 10")
    # 11. the lattice models: no kernel launched
    lattice_phases(tmc, device, kernels, card)
    elapsed("phase 11")
    # 12. XY, Heisenberg, TFIM and Wang-Landau: no kernel launched
    spin_phases(tmc, device, kernels, card)
    elapsed("phase 12")
    # 13. the reference's per-chain streams: the threefry kernel
    streams = streams_phases(tmc, device, kernels, card, opts.parent_tree)
    elapsed("phase 13")
    # 14. every sampler on the reference's per-chain keys
    samplers = sampler_phases(tmc, device, kernels, card, opts.parent_tree)
    elapsed("phase 14")

    m2 = CONFIG2_CHAINS
    specs = [(
        "fused_gaussian_sweep", "fused_sweep.cu",
        "montecarlo_tpu/ops/fused_sweep.py:104", max_err, ms, plain_ms,
        CONFIG2_STRIDE,
        bound(20 * m2 + 4, m2 * CONFIG2_STRIDE * GAUSS_INSTR_PER_STEP))]
    for name, mixed, cfg, line in (
            ("fused_lj_sweep", False, CONFIG4, 122),
            ("fused_lj_mixed_sweep", True, POOL5, 191)):
        seg = 10 * cfg["n"]
        specs.append((
            name, "lj_sweep.cu", f"montecarlo_tpu/ops/lj_sweep.py:{line}",
            lj_err[mixed], lj_ms[name][("kernel", seg)],
            lj_ms[name][("plain", seg)], seg,
            particle_bound(cfg["chains"], cfg["n"], lj_ms[name]["attempts"],
                           LJ_INSTR_PER_TERM, LJ_INSTR_PER_PICK)))
    seg = POLY["stride"] * POLY["n"]
    specs.append((
        "fused_poly_mixed_sweep", "poly_sweep.cu",
        "montecarlo_tpu/ops/poly_sweep.py:37", poly_err,
        poly_ms[("kernel", seg)], poly_ms[("plain", seg)], seg,
        particle_bound(POLY["chains"], POLY["n"], poly_ms["attempts"],
                       POLY_INSTR_PER_TERM)))
    rows = []
    sharded = {"fused_gaussian_sweep": ("sharded_gaussian_sweep",
                                        SWEEP_KERNEL),
               "fused_lj_sweep": ("sharded_lj_sweep", LJ_KERNEL),
               "fused_lj_mixed_sweep": ("sharded_lj_mixed_sweep",
                                        LJ_MIXED_KERNEL),
               "fused_poly_mixed_sweep": ("sharded_poly_mixed_sweep",
                                          POLY_KERNEL)}
    for name, source, replaces, err, k_ms, p_ms, steps, (b_ms, by) in specs:
        entry, kernel = sharded[name]
        n_mesh = mesh_launches[kernel.symbol]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"montecarlo_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches[name] + n_mesh,
            "max_abs_err": max(err, mesh_err[kernel.symbol]), "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": None, "steps": steps,
            "entry_points": [name, entry], "mesh_launches": n_mesh})
        print(f"bound: {name} at its main path's segment of {steps} steps: "
              f"{k_ms!r} ms per launch against a bound of {b_ms!r} ms (by "
              f"{by}): {100 * b_ms / k_ms!r} % of the bound's rate; plain "
              f"version {p_ms!r} ms; no single PyTorch call computes a "
              f"Metropolis sweep [{card}]")
    rows.append({
        "name": "threefry", "route": "cuda",
        "source": "montecarlo_tpu_torch/csrc/threefry.cu",
        "replaces": "jax/_src/prng.py:883 (XLA's threefry2x32 lowering; "
                    "no Pallas kernel)",
        "launches": streams["launches"] + samplers["launches"],
        "max_abs_err": streams["err"],
        "ms": streams["ms"], "plain_ms": streams["plain_ms"],
        "bound_ms": streams["bound_ms"], "bound_by": streams["bound_by"],
        "library_ms": None, "shape": [STREAMS["keys"], 1],
        "entry_points": ["threefry"],
        "mesh_launches": streams["mesh_launches"],
        "sampler_launches": samplers["launches"]})
    rows.append({
        "name": "threefry_split_uniform", "route": "cuda",
        "source": "montecarlo_tpu_torch/csrc/threefry.cu",
        "replaces": "montecarlo_tpu/models/lennard_jones.py:605 (split and "
                    "uniform of the event loop, fused by XLA; no Pallas "
                    "kernel)",
        "launches": samplers["split_launches"],
        "max_abs_err": samplers["err"], "ms": samplers["ms"],
        "plain_ms": samplers["plain_ms"], "bound_ms": samplers["bound_ms"],
        "bound_by": samplers["bound_by"], "library_ms": None,
        "shape": list(SPLIT_UNIFORM["loop"]),
        "entry_points": ["threefry(mode='split_uniform')",
                         "prng.split_uniform"]})
    rows.append({
        "name": "lj_total_energy", "route": "cuda",
        "source": "montecarlo_tpu_torch/csrc/lj_energy.cu",
        "replaces": "montecarlo_tpu/models/lennard_jones.py:115 (jnp "
                    "total_energy, fused by XLA; no Pallas kernel)",
        "launches": launches["lj_total_energy"],
        "max_abs_err": energy["err"], "max_rel_err_float64": energy["rel64"],
        "ms": energy["ms"], "plain_ms": energy["plain_ms"],
        "bound_ms": energy["bound_ms"], "bound_by": energy["bound_by"],
        "library_ms": None, "shape": energy["shape"],
        "entry_points": ["lj_total_energy", "lennard_jones._lj_energies"]})
    (k_ms, p_ms, b_ms, by), (ks_ms, ps_ms, bs_ms, _) = cell_ms[0], cell_ms[1]
    rows.append({
        "name": "cell_substep", "route": "cuda",
        "source": "montecarlo_tpu_torch/csrc/cell_substep.cu",
        "replaces": "montecarlo_tpu/ops/cell_mc.py:225 (jnp _make_substep, "
                    "fused by XLA; no Pallas kernel)",
        "launches": n_cell, "max_abs_err": 0.0, "ms": k_ms,
        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
        "swap_ms": ks_ms, "swap_plain_ms": ps_ms, "swap_bound_ms": bs_ms,
        "library_ms": None, "shape": [CELL_KERNEL["chains"],
                                      CELL_KERNEL["n"]],
        "entry_points": ["mc_cell_substep", "cell_mc._kernel_substeps"]})
    print(f"bound: threefry split_uniform at the LJ event loop's shape "
          f"({SPLIT_UNIFORM['loop'][0]} keys x {SPLIT_UNIFORM['loop'][1]}): "
          f"{samplers['ms']!r} ms a launch against a bound of "
          f"{samplers['bound_ms']!r} ms (by {samplers['bound_by']}); plain "
          f"version {samplers['plain_ms']!r} ms; no PyTorch call computes "
          f"threefry2x32 [{card}]")
    print(f"bound: threefry at the generic path's shape ({STREAMS['keys']} "
          f"keys x 1 uniform): {streams['ms']!r} ms a launch against a bound "
          f"of {streams['bound_ms']!r} ms (by {streams['bound_by']}); plain "
          f"version {streams['plain_ms']!r} ms; no PyTorch call computes "
          f"threefry2x32 [{card}]")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
