"""The comparison that decides ``correct``: a sound run passes every
limit, the control (the reference in bfloat16 put in the program's
place) fails, and so does a run with the timed path broken underneath:
a step that returns its state unchanged, half of the batch left out of
the mean, an answer altered where it is produced (each configuration's
``faults/<config>.py``).  On the CPU, at each cell's small sizes
(``small/<cell>.json``); the look for a card is skipped."""

import pytest

from bench_helpers import SMALL, faults, judged, run_small, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_control_is_not(cell):
    r = run_small(cell, control=True)
    correct, failed, checks = judged(cell, r)
    assert correct, checks
    c_correct, _, c_checks = judged(cell, r, "control")
    assert not c_correct
    assert r["control"]["chains_off"] == \
        SMALL[cell]["overrides"]["check_chains"]
    assert r["path"] == spec.workload(cell)["path"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    mod, attr, make = faults(spec.workload(cell)["config"])[fault]
    monkeypatch.setattr(mod, attr, make(getattr(mod, attr)))
    r = run_small(cell)
    correct, failed, checks = judged(cell, r)
    assert not correct, checks
    assert failed >= 1


def test_bin_frames_reach_the_store_and_are_checked():
    # no cell records trajectories yet; a cell file that asks for BIN frames
    # gets them compared with the final and the tapped state
    r = run_small("harmonic1d.fine", control=True, trajectories="bin")
    assert r["checks"]["frame_gap"] == 0.0
    assert r["checks"]["rows_off"] == 0
    assert r["control"]["frame_gap"] > 0.0
