"""Print what the program's spans and counters say of one traced window
of a cell:

    python3 h100_bench/trace_spans.py --workload <cell> --seed <n> \
        --seconds <s>

from the root of a checkout, on a machine with the cell's cards.  The
cell runs as ``run.py --trace 1`` runs it; the last line of standard
output is one JSON object: the run's per-layer metrics, ``correct`` and
``breakdown``, each ``mc.`` span's calls and host, self and device
seconds (``harness/spans.py``), the ten longest idle stretches of the
card named by the top-level span the host was in, the program's counters
(``Simulation.counters``) and the per-period readings of
``spans.readings``.  A program without spans or counters gives empty
ones."""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import run  # noqa: E402
from harness import cell, spans, spec  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    kept = {}
    window = cell.window

    def keep(sim, device, trace):
        wall, events, caught = window(sim, device, trace)
        c = getattr(sim, "counters", None)
        kept.update(events=events, counters=None if c is None
                    else dataclasses.asdict(c))
        return wall, events, caught

    cell.window = keep
    result = run.run_cell(args.workload, args.seed, args.seconds, 1)
    limits = spec.workload(args.workload).get("limits", {})
    correct, _, _ = run.judge(result, limits)
    summary = spans.summarize(kept.pop("events"))
    line = dict(
        workload=args.workload, seed=args.seed, correct=correct,
        periods=result["periods"], wall=result["wall"],
        metrics={k: v["value"] for k, v in result["metrics"].items()},
        device=result["device"], breakdown=result["breakdown"],
        spans=summary["spans"], top_s=summary["top_s"],
        top_sum_s=summary["top_sum_s"], idle_gaps=summary["idle_gaps"],
        counters=kept["counters"],
        readings=spans.readings(summary, kept["counters"],
                                result["periods"], result["wall"]))
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
