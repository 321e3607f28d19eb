"""The port's spans and counters (``utils/observability.py``): where the
time loop's ``mc.`` spans fall under a CPU ``torch.profiler``, that nothing
is recorded, and no ``record_function`` entered, without one, that the
output files do not depend on it, and that ``Simulation.counters`` equals
what the schedule implies.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import montecarlo_tpu_torch as tmc
from montecarlo_tpu_torch.core import ecmc, simulation
from montecarlo_tpu_torch.models import lennard_jones as lj
from montecarlo_tpu_torch.models import particle1d as p1d
from montecarlo_tpu_torch.utils import observability

M, STRIDE, CHUNK = 64, 2, 4
TOP = ("mc.initialise", "mc.schedule", "mc.advance", "mc.refresh",
       "mc.observe", "mc.flush", "mc.record", "mc.host_algorithm",
       "mc.finalise")


@pytest.fixture(autouse=True)
def _small_chunks(monkeypatch):
    """Chunks of a few periods, so a short run flushes several."""
    monkeypatch.setattr(simulation, "_CHUNK", CHUNK)


def _harmonic(path, steps, extra=(), met=None, sched=None):
    sched = np.arange(STRIDE, steps + 1, STRIDE) if sched is None else sched
    algos = [dict(algorithm=tmc.Metropolis, pool=(p1d.displacement_move(0.5),),
                  seed=3, **(met or {"fused": "interpret"})),
             dict(algorithm=tmc.StoreCallbacks,
                  callbacks=(p1d.callback_energy, tmc.callback_acceptance),
                  scheduler=sched)]
    chains = p1d.init_chains(M, beta=2.0, seed=5, device="cpu")
    return tmc.Simulation(p1d.make_system(), chains, algos + list(extra),
                          steps, path=str(path))


def _cell(path, steps):
    chains = lj.init_chains(2, 512, rho=1.0, beta=1.0, frac_b=0.2, seed=6,
                            device="cpu")
    algos = [dict(algorithm=tmc.Metropolis,
                  pool=(lj.lj_displacement_move(0.1),), seed=1,
                  sweepstep=64, fused="cell"),
             dict(algorithm=tmc.StoreCallbacks,
                  callbacks=(lj.callback_energy_per_particle,),
                  scheduler=np.arange(1, steps + 1))]
    return tmc.Simulation(lj.make_system(), chains, algos, steps,
                          path=str(path))


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return _spans(prof.events())


def _spans(events):
    """``(name, start, end, enclosing mc. span's name or None)`` of every
    ``mc.`` span on the host rows, in start order."""
    out = []
    for ev in events:
        if ev.device_type != DeviceType.CPU or not ev.name.startswith("mc."):
            continue
        parent = ev.cpu_parent
        while parent is not None and not parent.name.startswith("mc."):
            parent = parent.cpu_parent
        out.append((ev.name, ev.time_range.start, ev.time_range.end,
                    None if parent is None else parent.name))
    return sorted(out, key=lambda s: s[1])


def _names(spans, parent=None):
    return [s[0] for s in spans if s[3] == parent]


def test_buffered_run_spans(tmp_path):
    steps = 40
    periods = steps // STRIDE
    sim = _harmonic(tmp_path, steps)
    spans = _profiled(sim.run)
    top = [s for s in spans if s[3] is None]
    names = [s[0] for s in top]
    assert set(names) <= set(TOP)
    assert names.count("mc.advance") == names.count("mc.observe") == periods
    assert names.count("mc.flush") == periods // CHUNK
    assert names.count("mc.initialise") == names.count("mc.schedule") == 1
    assert names.count("mc.finalise") == 2
    assert "mc.refresh" not in names      # the oscillator has no cache
    # the top-level spans do not overlap
    for (_, _, end, _), (_, start, _, _) in zip(top, top[1:]):
        assert end <= start
    # each flush holds its three parts, in order, inside it
    for name, start, end, _ in top:
        if name != "mc.flush":
            continue
        kids = [s for s in spans if s[3] == "mc.flush"
                and start <= s[1] and s[2] <= end]
        assert [k[0] for k in kids] == ["mc.flush.check", "mc.flush.to_host",
                                        "mc.flush.write"]
    # the one-deep pipeline: a chunk's flush follows the next chunk's work
    first_flush = names.index("mc.flush")
    assert names[:first_flush].count("mc.observe") == 2 * CHUNK


@pytest.mark.parametrize("case", ["per_event", "generic", "hybrid", "cell"])
def test_other_paths_spans(tmp_path, case):
    if case == "per_event":
        # a host algorithm on the recorder's times turns the buffer off
        sched = np.arange(STRIDE, 9, STRIDE)
        sim = _harmonic(tmp_path, 8, extra=[dict(
            algorithm=tmc.Throughput, scheduler=sched)], sched=sched)
        want_top, want_kids = {"mc.record": 4, "mc.host_algorithm": 4}, {}
    elif case == "generic":
        # a Metropolis on every other step takes the generic loop
        sim = _harmonic(tmp_path, 8, met={"fused": "off", "scheduler":
                                          np.arange(2, 9, 2)})
        want_top, want_kids = {"mc.advance": 4}, {
            ("mc.step", "mc.advance"): 4, ("mc.prng", "mc.step"): None}
    elif case == "hybrid":
        # the fused sweep between the events of a sparse device algorithm
        sim = _harmonic(tmp_path, 8, extra=[dict(
            algorithm=tmc.ReplicaExchange, n_temps=2,
            scheduler=np.arange(4, 9, 4))])
        want_top, want_kids = {"mc.advance": 4}, {
            ("mc.step", "mc.advance"): 2}
    else:
        sim = _cell(tmp_path, 2)
        want_top, want_kids = {"mc.advance": 2, "mc.observe": 0}, {
            ("mc.cell.substep", "mc.advance"): None,
            ("mc.prng", "mc.cell.substep"): None}
    spans = _profiled(sim.run)
    top = _names(spans)
    assert set(top) <= set(TOP)
    for name, n in want_top.items():
        assert top.count(name) == n, name
    for (name, parent), n in want_kids.items():
        got = _names(spans, parent).count(name)
        assert got == n if n is not None else got > 0, (name, parent)
    # a span's children are never spans of its own name
    assert all(s[0] != s[3] for s in spans)


def test_cell_segment_bind_spans_and_counter(tmp_path):
    """Each cell-path segment binds once and unbinds once, in spans under
    ``mc.advance`` around its substeps, and the run counts its binds (off,
    the spans enter no ``record_function``:
    ``test_no_record_function_without_a_profiler``)."""
    sim = _cell(tmp_path, 2)
    spans = _profiled(sim.run)
    kids = [s for s in spans if s[3] == "mc.advance"]
    binds = [s for s in kids if s[0] == "mc.cell.bind"]
    unbinds = [s for s in kids if s[0] == "mc.cell.unbind"]
    assert len(binds) == len(unbinds) == 2
    for b, u in zip(binds, unbinds):
        inside = [s[0] for s in kids if b[2] <= s[1] and s[2] <= u[1]]
        assert inside and set(inside) == {"mc.cell.substep"}
    assert sim.counters.cell_binds == 2
    assert sim.counters.cell_substeps > 0
    report = open(tmp_path / "summary.log").read().split("Report:\n")[1]
    assert "cell_binds 2, cell_substeps " in report


def test_ecmc_iteration_spans():
    def body(carry, i):
        return (carry[0] + 1,)

    def active(carry):
        return carry[0] < torch.tensor([3, 5])

    spans = _profiled(lambda: ecmc.event_loop(
        body, (torch.zeros(2, dtype=torch.int64),), active, check_every=2))
    assert _names(spans) == ["mc.ecmc.iteration"] * 6


def test_no_record_function_without_a_profiler(tmp_path, monkeypatch):
    """With no profiler recording, a span is one shared no-op and the run
    enters no ``record_function``; under one, every span does."""
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert observability.span("mc.a") is observability.span("mc.b")
    _harmonic(tmp_path / "off", 16).run()
    _cell(tmp_path / "cell", 1).run()
    assert entered == []
    spans = _profiled(_harmonic(tmp_path / "on", 16).run)
    assert sorted(entered) == sorted(s[0] for s in spans)


def test_files_do_not_depend_on_the_profiler(tmp_path):
    _harmonic(tmp_path / "off", 40).run()
    _profiled(_harmonic(tmp_path / "on", 40).run)
    for name in ("energy.dat", "acceptance.dat"):
        with open(tmp_path / "off" / name, "rb") as a, \
                open(tmp_path / "on" / name, "rb") as b:
            assert a.read() == b.read()


def _row_bytes(sim):
    view = sim.view(sim.device_state)
    return sum(np.asarray(cb(view)).nbytes
               for cb in sim.algorithms[1].callbacks)


@pytest.mark.parametrize("case", ["buffered", "per_event", "cell"])
def test_counters_follow_the_schedule(tmp_path, case):
    if case == "buffered":
        steps, periods = 40, 20
        sim = _harmonic(tmp_path, steps)
        chunks = periods // CHUNK
        # the first record's pull, a pull a chunk, the final device sync
        syncs = 1 + chunks + 1
    elif case == "per_event":
        steps, periods = 6, 3
        sim = _harmonic(tmp_path, steps)      # 3 periods: below the buffer
        chunks = 0
        syncs = 1 + periods + 1
    else:
        steps, periods = 2, 2
        sim = _cell(tmp_path, steps)
        chunks = 0
        # and a read of the latched bind flag at every record point
        syncs = 1 + 2 * periods + 1
    sim.run()
    c = sim.counters
    assert (c.periods, c.chunks, c.records, c.host_syncs) == (
        periods, chunks, periods + 1, syncs)
    assert c.bytes_to_host == (periods + 1) * _row_bytes(sim)
    if case == "cell":
        assert c.cell_substeps > 0 and c.prng_draws > 1
    else:
        # the fused path's one draw: the chains' keys, at initialise
        assert (c.cell_substeps, c.prng_draws) == (0, 1)
    assert c.launches == {}           # no hand-written kernel on the CPU
    report = open(tmp_path / "summary.log").read().split("Report:\n")[1]
    assert (f"\tCounters: periods {periods}, chunks {chunks}, records "
            f"{periods + 1}, host_syncs {syncs}, ") in report
    assert "\tKernel launches: none\n" in report


def test_profiler_trace_exports_spans(tmp_path):
    sched = np.asarray([2, 6])
    sim = _harmonic(tmp_path, 8, extra=[dict(
        algorithm=tmc.ProfilerTrace, scheduler=sched)])
    sim.run()
    with open(tmp_path / "trace" / "trace_t6.json") as f:
        names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
    assert {"mc.advance", "mc.record"} <= names
    assert not os.path.exists(tmp_path / "trace" / "trace_t2.json")
