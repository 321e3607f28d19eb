"""Run one cell of the benchmark of ``montecarlo_tpu_torch`` once.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cell's NVIDIA cards.
Set-up makes the chains on the card from the seed, warms the cell's
shapes up and sizes the window in whole record periods; the window is one
``Simulation.run()`` to a final device synchronisation; then the
program's outputs are held to the plain reference.  The last line of
standard output is one JSON object; the numbers compared, each with its
limit, are the last lines of standard error.  Without the cards the cell
asks for, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)

from harness import cell, guard, spans, spec  # noqa: E402
from harness import trace as tracing  # noqa: E402

#: build and kernel caches at fixed paths inside the checkout
CACHE = os.path.join(ROOT, ".bench_cache")


class NoCard(RuntimeError):
    pass


def derive_seeds(seed: int) -> dict:
    """The chains' seed, the sampler's seed (both below 2**31) and the seed
    of the chains the comparison samples, from one ``--seed`` of any
    size."""
    h = hashlib.sha256(str(int(seed)).encode()).digest()
    return {"chains": int.from_bytes(h[0:4], "little") & 0x7FFFFFFF,
            "mc": int.from_bytes(h[4:8], "little") & 0x7FFFFFFF,
            "sample": int.from_bytes(h[8:16], "little")}


def require_cards(chips: int):
    import torch
    if not torch.cuda.is_available():
        raise NoCard("no CUDA device: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} cards, "
                     f"{torch.cuda.device_count()} present")


def power_limit() -> str:
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
        return p.stdout.strip().splitlines()[0] if p.returncode == 0 \
            else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def _numpy_tree(d):
    return {k: v.detach().cpu().numpy() for k, v in d.items()}


def run_cell(name, seed, seconds, trace, *, device=None, fused="auto",
             overrides=None, periods=None, t_start=None, control=False):
    """One run of cell ``name``; returns the result's dict (without the
    ``checks`` limits applied yet: see :func:`judge`).

    ``device`` None runs on the card and requires it; tests pass
    ``device='cpu'``, ``fused='interpret'`` (the row kernels' plain
    versions), workload ``overrides`` and a fixed number of ``periods``.
    With ``control``, the result also holds the control's readings: the
    reference in bfloat16 put in the program's place."""
    t_start = T_START if t_start is None else t_start
    bench = spec.benchmark()
    entry = spec.cell_entry(bench, name)
    wl = dict(spec.workload(name), **(overrides or {}))
    cfg = spec.config(entry["config"])
    cfgmod = spec.module("configs", entry["config"])
    if device is None:
        require_cards(entry["chips"])
        device = "cuda"
        os.makedirs(CACHE, exist_ok=True)
        os.environ.setdefault("TRITON_CACHE_DIR",
                              os.path.join(CACHE, "triton"))
        os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                              os.path.join(CACHE, "torch_extensions"))
    import numpy as np
    import torch
    import montecarlo_tpu_torch as mc
    on_card = torch.device(device).type == "cuda"
    if on_card:
        # torch's CPU work in this thread alone: no pool of workers shares
        # the host's cores with the time loop
        torch.set_num_threads(1)
    seeds = derive_seeds(seed)
    rundir = tempfile.mkdtemp(prefix="h100_bench-")
    try:
        made = cfgmod.make(cfg, wl, seeds, device)
        initial = _numpy_tree({k: getattr(made["chains"], k)
                               for k in cfgmod.STATE_LEAVES})
        if periods is None:
            periods = cell.size_periods(
                mc, cfgmod, made, wl, seeds["mc"],
                min(seconds, wl.get("trace_seconds", seconds)) if trace
                else seconds, rundir, fused, device)
        stride, sweepstep = wl["stride"], wl["sweepstep"]
        tap = cell.Tap(cfgmod.STATE_LEAVES, cfgmod.counters,
                       (periods - 1) * stride, periods,
                       timing=bool(trace) and on_card)
        out_dir = os.path.join(rundir, "window")
        sim = cell.build(mc, cfgmod, made, wl, seeds["mc"], periods * stride,
                         out_dir, fused, tap)
        kern = cfgmod.kernel(wl) if on_card else None
        launches0 = kern.launches if kern else 0
        cell.sync(device)
        setup_s = time.perf_counter() - t_start
        wall, events, caught = cell.window(sim, device, trace)
        mem_peak = torch.cuda.max_memory_allocated() if on_card else 0
        path = cfgmod.path(sim)
        fellback = [str(w.message) for w in caught
                    if issubclass(w.category, RuntimeWarning)
                    and "cell-MC bind" in str(w.message)]
        launched = (kern.launches - launches0) if kern else None
        fin = sim.device_state
        final = _numpy_tree({k: getattr(fin["sys"], k)
                             for k in cfgmod.STATE_LEAVES})
        final["counters"] = cfgmod.counters(fin).cpu().numpy()
        box = getattr(fin["sys"], "box", None)
        run = dict(
            cfg=cfg, wl=wl, chains=wl["chains"], periods=periods,
            stride=stride, sweepstep=sweepstep, mc_seed=seeds["mc"],
            t0=(periods - 1) * stride * sweepstep,
            n_steps=stride * sweepstep, device=device, final=final,
            box=None if box is None else float(box.reshape(-1)[0]),
            snap=_numpy_tree(tap.snap), initial=initial,
            pre_refresh=(_numpy_tree(tap.pre_refresh)
                         if tap.pre_refresh is not None else None))
        refresh_ms = tap.refresh_ms() if tap.timing else []
        # the traced run's readers take the program's own counters; None
        # where the program keeps none
        program_counters = (dataclasses.asdict(sim.counters)
                            if trace and hasattr(sim, "counters") else None)
        del sim, fin, made, tap
        if on_card:
            torch.cuda.empty_cache()
        run["files"], rows_off = cell.read_files(out_dir, wl, periods)
        rng = np.random.default_rng(seeds["sample"])
        run["sample"] = np.sort(rng.choice(
            wl["chains"], min(wl["check_chains"], wl["chains"]),
            replace=False))
        t_check = time.perf_counter()
        out = cfgmod.outputs(run)
        replayed = cfgmod.replay(run)
        checks = cfgmod.compare(run, out, replayed)
        checks["rows_off"] = rows_off
        check_s = time.perf_counter() - t_check
        moves = cfgmod.moves(final["counters"])
        # an end-to-end metric's name up to its first dot says what it
        # measures; what follows names the cells whose bound it takes
        e2e = {"moves_per_s": moves / wall, "setup_s": setup_s}
        result = dict(
            check_s=check_s,
            path=path, declared=wl["path"], fellback=fellback,
            launched=launched, periods=periods, wall=wall, checks=checks,
            device={"platform": "gpu" if on_card else device,
                    "kind": (torch.cuda.get_device_name(0) if on_card
                             else device),
                    "count": 1, "memory_peak_bytes": int(mem_peak)})
        metrics = {}
        if not trace:
            for m in spec.metrics_of(bench, name, "end_to_end"):
                metrics[m["name"]] = {"value": e2e[m["name"].split(".")[0]],
                                      "unit": m["unit"]}
        else:
            summary = tracing.summarize(events, wall)
            program_spans = spans.summarize(events)
            del events
            result["device"].update(busy_s=summary["busy_s"],
                                    window_s=summary["window_s"])
            result["breakdown"] = summary["breakdown"]
            result["program"] = dict(spans=program_spans,
                                     counters=program_counters)
            ctx = dict(trace=summary, periods=periods, wl=wl, cfg=cfg,
                       counters=final["counters"], refresh_ms=refresh_ms,
                       spans=program_spans,
                       program_counters=program_counters,
                       count=lambda k: spec.module("counts", k))
            for m in spec.metrics_of(bench, name, "per_layer"):
                value = spec.module("layer_metrics", m["name"]).read(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        if control:
            result["control"] = cfgmod.compare(
                run, cfgmod.control_outputs(run, out), replayed)
        return result
    finally:
        shutil.rmtree(rundir, ignore_errors=True)


def judge(result, limits):
    """``correct``, ``failed`` and the ``checks`` line: every number
    compared beside its limit; a number without a limit fails."""
    checks = {}
    failed = 0
    for k, v in result["checks"].items():
        lim = limits.get(k)
        ok = lim is not None and v <= lim
        failed += not ok
        checks[k] = {"value": v, "limit": lim}
    path_ok = (result["path"] == result["declared"] and not result["fellback"]
               and result["launched"] != 0)
    checks["path"] = {"value": result["path"], "limit": result["declared"]}
    if result["launched"] is not None:
        checks["kernel_launches"] = {"value": result["launched"],
                                     "limit": "> 0"}
    failed += not path_ok
    return failed == 0, failed, checks


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds, args.trace)
    except NoCard as e:
        print(f"h100_bench: {e}; no result", file=sys.stderr)
        return 2
    bad = guard.forbidden_loaded(sys.modules)
    if bad:
        print(f"h100_bench: the process holds {bad}; no result",
              file=sys.stderr)
        return 3
    limits = spec.workload(args.workload).get("limits", {})
    correct, failed, checks = judge(result, limits)
    result["device"]["power_limit"] = power_limit()
    line = {"correct": correct, "attempted": result["periods"],
            "failed": failed, "metrics": result["metrics"],
            "device": result["device"]}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["checks"] = checks
    print(f"h100_bench: {args.workload} seed {args.seed}: {result['periods']} "
          f"periods, window {result['wall']!r} s, comparison "
          f"{result['check_s']!r} s", file=sys.stderr)
    sys.stdout.flush()
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
