"""Probe of the accuracy of torch's first vector ``log`` call in a process.

Usage: python tests/torch_first_call_probe.py [processes] [elements]

Starts ``processes`` fresh Python processes (default 24, 8 at a time); each
calls ``torch.log`` three times on the same ``elements`` float32 uniforms
(default 200000, above the intra-op grain size, so several threads share
the first call) and prints the maximum relative error of each call against
numpy's float64 ``log``.  Prints how many processes had a first call above
1e-6 and how many had a later call above it.  On an MKL build of torch the
first call has come back with errors near 1e-4 in a few of every hundred
processes; no later call has.
"""

import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

CHILD = """
import sys, numpy as np, torch
u = torch.rand(int(sys.argv[1]), generator=torch.Generator().manual_seed(0))
u = u.clamp(min=1e-30)
w = np.log(u.double().numpy())
print(' '.join(repr(float(np.max(np.abs(torch.log(u).double().numpy() - w)
                                   / np.abs(w)))) for _ in range(3)))
"""


def one(n):
    out = subprocess.run([sys.executable, "-c", CHILD, str(n)],
                         capture_output=True, text=True, check=True)
    return [float(v) for v in out.stdout.split()]


def main():
    procs = int(sys.argv[1]) if len(sys.argv) > 1 else 24
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 200000
    with ThreadPoolExecutor(max_workers=8) as pool:
        errs = list(pool.map(one, [n] * procs))
    for e in errs:
        print(" ".join(f"{v:.2e}" for v in e))
    first = sum(e[0] > 1e-6 for e in errs)
    later = sum(any(v > 1e-6 for v in e[1:]) for e in errs)
    print(f"{procs} processes, {n} elements: first call off in {first}, "
          f"a later call off in {later}")


if __name__ == "__main__":
    main()
