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
``spans.readings``, the same numbers as the run's per-layer metrics
that read them.  A program without spans gives empty ones; one without
counters, none.  As ``run.py``, it prints no line and exits non-zero
where no card is found or where the process holds JAX or the JAX
package once the window has closed."""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import run  # noqa: E402
from harness import guard, spans, spec  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    try:
        result = run.run_cell(args.workload, args.seed, args.seconds, 1)
    except run.NoCard as e:
        print(f"trace_spans: {e}; no result", file=sys.stderr)
        return 2
    bad = guard.forbidden_loaded(sys.modules)
    if bad:
        print(f"trace_spans: the process holds {bad}; no result",
              file=sys.stderr)
        return 3
    limits = spec.workload(args.workload).get("limits", {})
    correct, _, _ = run.judge(result, limits)
    summary, counters = (result["program"][k] for k in ("spans", "counters"))
    line = dict(
        workload=args.workload, seed=args.seed, correct=correct,
        periods=result["periods"], wall=result["wall"],
        metrics={k: v["value"] for k, v in result["metrics"].items()},
        device=result["device"], breakdown=result["breakdown"],
        spans=summary["spans"], top_s=summary["top_s"],
        top_sum_s=summary["top_sum_s"], idle_gaps=summary["idle_gaps"],
        counters=counters,
        readings=spans.readings(summary, counters, result["periods"],
                                result["wall"]))
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
