"""Readings that a cell's limits are set from, in one process: the
program's numbers on many seeds and the control's (the reference in
bfloat16 put in the program's place) on some, each run at the cell's own
sizes with a window of ``--seconds``.

    python3 h100_bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 --seconds 5 [--out FILE]

Prints one JSON line a seed and, at the end, the largest program reading
and the smallest control reading of each number.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import run  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctl_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    lows, highs, lines = {}, {}, []
    for seed in seeds:
        t0 = time.perf_counter()
        r = run.run_cell(args.workload, seed, args.seconds, 0, t_start=t0,
                         control=seed in ctl_seeds)
        line = {"seed": seed, "checks": r["checks"], "path": r["path"],
                "launched": r["launched"], "periods": r["periods"],
                "metrics": r["metrics"], "control": r.get("control"),
                "check_s": r["check_s"], "wall": r["wall"],
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        lines.append(line)
        for k, v in r["checks"].items():
            lows[k] = max(lows.get(k, v), v)
        for k, v in (r.get("control") or {}).items():
            highs[k] = min(highs.get(k, v), v)
    summary = {"workload": args.workload, "lower": lows, "upper": highs}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for line in lines + [summary]:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
