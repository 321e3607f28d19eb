#!/usr/bin/env python3
"""Where a step of the LJ sweep kernels spends its time, by ablation.

No profiler reaches inside a kernel on every machine, so this script
builds copies of ``csrc/lj_sweep.cu`` with one phase of a step cut out
(the results of such a copy are wrong; only its time is of use) and times
each copy beside the unchanged kernel, by CUDA events in one call, at the
main paths' shapes (64 chains x N 1024 and 256 x N 256, both pools):

- ``no_rows``: the pair-term loop over the slots runs no iteration, so what
  remains is a step's fixed part (draws read, probe read, reductions,
  barriers, accept, write);
- ``no_scan_hash``: the swap's pick draws are not hashed;
- ``no_accept_barrier``: no barrier after an accepted move;
- ``no_butterfly``: no shuffles in the warp sums;
- ``no_cross_warp``: the warp sums are not added up across the block.

The copies are made by replacing source lines, into a temporary directory;
a replacement that no longer finds its line fails.  Needs one NVIDIA GPU and
nvcc.

Usage: python3 chip_ablate.py
"""

import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

NO_ITERATION = " * (box < 0.0f)"      # false for every box, unknown to nvcc
CUTS = {  # name: (file, old, new)
    "no_rows": ("particle_rows.cuh",
                "for (int j = first; j < n; j += stride) {",
                f"for (int j = first; j < n{NO_ITERATION}; j += stride) {{"),
    "no_scan_hash": ("lj_sweep.cu",
                     "uniform_from_bits(draw_bits(hj, 1u))",
                     "__uint_as_float(0x3f000000u + (hj & 0xffffu))"),
    "no_accept_barrier": ("lj_sweep.cu",
                          "++acc_d;\n          __syncthreads();", "++acc_d;"),
    "no_butterfly": ("particle_rows.cuh",
                     "const float v = warp_sum(part[q]);",
                     "const float v = part[q];"),
    "no_cross_warp": ("particle_rows.cuh",
                      "for (int w = 1; w < warps; ++w) {",
                      f"for (int w = 1; w < warps{NO_ITERATION}; ++w) {{"),
}
# cuts that come in pairs
ALSO = {
    "no_scan_hash": ("lj_sweep.cu", "uniform_from_bits(draw_bits(hj, 0u))",
                     "__uint_as_float(0x3f000000u + (hj & 0xffffu))"),
    "no_accept_barrier": ("lj_sweep.cu",
                          "++acc_s;\n            __syncthreads();",
                          "++acc_s;"),
}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_ablate: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from montecarlo_tpu_torch.ops import _cuda
    from montecarlo_tpu_torch.ops import lj_sweep as ops
    device = torch.device("cuda", 0)
    card = cs.card_line()
    csrc = os.path.join(ROOT, "montecarlo_tpu_torch", "csrc")
    sources = {}
    for name in ("lj_sweep.cu", "particle_rows.cuh", "counter_hash.cuh"):
        with open(os.path.join(csrc, name)) as f:
            sources[name] = f.read()
    shapes = [cs.lj_inputs(cfg["chains"], cfg["n"], device, cs.SEED + 30)
              for cfg in (cs.POOL5, cs.CONFIG4)]
    kernels = (ops.LJ_KERNEL, ops.LJ_MIXED_KERNEL)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=ROOT) as tmp:
        # the unchanged kernel first and last: the spread between the two
        # says how far a cut's time can be trusted
        for run, variant in enumerate(("unchanged", *CUTS, "unchanged")):
            files = dict(sources)
            for name, old, new in filter(None, (CUTS.get(variant),
                                                ALSO.get(variant))):
                if files[name].count(old) != 1:
                    raise RuntimeError(f"{variant}: {old!r} is not once in "
                                       f"{name}")
                files[name] = files[name].replace(old, new)
            build = os.path.join(tmp, f"{run}-{variant}")
            os.makedirs(build)
            for name, text in files.items():
                with open(os.path.join(build, name), "w") as f:
                    f.write(text)
            lib = os.path.join(build, "lj_sweep.so")
            proc = subprocess.run(
                [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", lib,
                 os.path.join(build, "lj_sweep.cu")],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {variant}:\n"
                                   f"{proc.stderr}")
            loaded = ctypes.CDLL(lib)
            for k in kernels:               # the wrappers launch this copy
                fn = getattr(loaded, k.symbol)
                fn.argtypes, fn.restype = k.argtypes, ctypes.c_int
                k._fn = fn
            parts = []
            for st in shapes:
                m, n = st.pos.shape[:2]
                for mixed in (False, True):
                    ms = cs.cuda_time(lambda: cs.lj_call(
                        st, 10 * n, mixed, t0=0), 3)
                    parts.append(
                        f"{'mixed' if mixed else 'displacement'} {m} x N {n}: "
                        f"{ms!r} ms per {10 * n} steps "
                        f"({ms / (10 * n) * 1e3!r} us a step)")
            print(f"ablation: {variant}: " + "; ".join(parts) + f" [{card}]",
                  flush=True)
    for k in kernels:
        k._fn = None                        # back to the package's build
    return 0


if __name__ == "__main__":
    sys.exit(main())
