"""The comparison that decides ``correct``: a sound run passes every
limit, the control (the reference in bfloat16 put in the program's
place) fails, and so does a run with the timed path broken underneath:
a step that returns its state unchanged, half of the batch left out of
the mean, an answer altered where it is produced.  On the CPU, at small
sizes, with the row kernels' plain versions; the look for a card is
skipped."""

import dataclasses

import pytest
import torch

import montecarlo_tpu_torch.ops.fused_sweep as fs
import montecarlo_tpu_torch.ops.lj_sweep as ls
from montecarlo_tpu_torch.models import lennard_jones as lj
from montecarlo_tpu_torch.models import particle1d as p1d

from bench_helpers import SMALL, judged, run_small, spec

CELLS = sorted(SMALL)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_control_is_not(cell):
    r = run_small(cell, control=True)
    correct, failed, checks = judged(cell, r)
    assert correct, checks
    c_correct, _, c_checks = judged(cell, r, "control")
    assert not c_correct
    assert r["control"]["chains_off"] == SMALL[cell][0]["check_chains"]
    assert r["path"] == spec.workload(cell)["path"]


def _unchanged_gaussian(real):
    def sweep(x, beta, sigma, seed, t0, n_steps, **kw):
        _, _, acc = real(x, beta, sigma, seed, t0, n_steps, **kw)
        return x.clone(), kw["potential"](x), torch.zeros_like(acc)
    return sweep


def _altered_gaussian(real):
    def sweep(*a, **kw):
        x, e, acc = real(*a, **kw)
        return x + 1e-6, e, acc
    return sweep


def _unchanged_lj(real):
    def sweep(pos, species, beta, energy, *a, **kw):
        _, _, _, acc, tot = real(pos, species, beta, energy, *a, **kw)
        return (pos.clone(), species.clone(), energy.clone(),
                torch.zeros_like(acc), tot)
    return sweep


def _altered_lj(real):
    def sweep(*a, **kw):
        pos, species, energy, acc, tot = real(*a, **kw)
        return pos, species, energy + 1e-3, acc, tot
    return sweep


def _half_mean(real, field):
    def callback(view):
        half = dataclasses.replace(view.sys, **{
            f.name: getattr(view.sys, f.name)[: view.sys.beta.shape[0] // 2]
            for f in dataclasses.fields(view.sys)})
        return real(dataclasses.replace(view, sys=half))
    callback.__name__ = real.__name__
    return callback


FAULTS = {
    "harmonic1d": {
        "unchanged": (fs, "fused_gaussian_sweep", _unchanged_gaussian),
        "half_batch": (p1d, "callback_energy",
                       lambda f: _half_mean(f, "e")),
        "altered": (fs, "fused_gaussian_sweep", _altered_gaussian),
    },
    "ka2d": {
        "unchanged": (ls, "fused_lj_mixed_sweep", _unchanged_lj),
        "half_batch": (lj, "callback_energy_per_particle",
                       lambda f: _half_mean(f, "energy")),
        "altered": (ls, "fused_lj_mixed_sweep", _altered_lj),
    },
}


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    mod, attr, make = FAULTS[spec.workload(cell)["config"]][fault]
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
