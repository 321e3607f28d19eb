"""How the benchmark drives ``montecarlo_tpu_torch`` on the ``ka2d_large``
configuration, the 2-D Kob-Andersen mixture at a size that ``'auto'``
gives the checkerboard cell path, and how a run of it is judged against
the plain reference (``ka2d_large_reference.py``)."""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import ka2d  # noqa: E402
import ka2d_large_reference as ref  # noqa: E402
from ka2d import _columns, _energies  # noqa: E402
from harness.metropolis import (algorithms, counters,  # noqa: E402,F401
                                moves, path)

#: the per-chain state leaves a snapshot keeps
STATE_LEAVES = ka2d.STATE_LEAVES
#: the cell path's default plan, which the run leaves as it is: the halo
#: and the capacity's multiple of the mean occupancy
D_CAP, CAP_SLACK = 0.45, 2.0


def make(cfg, wl, seeds, device):
    """``ka2d``'s system, initial chains, move pool and callbacks: the same
    mixture, at this cell's size.  A program whose cell path states no sum
    order cannot be replayed by the reference: it raises."""
    import torch

    from montecarlo_tpu_torch.ops import cell_mc
    if wl["path"] != "cell":
        raise ValueError("the reference replays the cell path only")
    if getattr(cell_mc, "ACCUMULATE", None) is not torch.float64:
        raise RuntimeError(
            "the program's cell path states no sum order (ops/cell_mc.py: "
            "ACCUMULATE): its float32 sums follow torch's reduction order, "
            "which the reference cannot replay")
    # ka2d's path check guards its own row reference; the Metropolis entry
    # (harness/metropolis.py) leaves the path to fused='auto' either way
    return ka2d.make(cfg, dict(wl, path="row"), seeds, device)


def kernel(wl):
    """No row kernel: the cell path is plain torch."""
    return None


def _plan(run):
    cfg, init = run["cfg"], run["initial"]
    rcut_max = cfg["rcut"] * max(max(row) for row in cfg["sig"])
    return ref.plan(init["pos"].shape[1], float(init["box"].reshape(-1)[0]),
                    rcut_max, init["pos"], D_CAP, CAP_SLACK)


def _last_segment(run, nc):
    """The last period's substeps and the displacement's share of a
    substep."""
    w = [run["wl"]["pool"][c]["weight"] for c in _columns(run["wl"])]
    counts, w_disp = ref.substeps(run["periods"], run["stride"],
                                  run["sweepstep"], nc, ref.move_shares(w))
    return counts[-1], w_disp


def replay(run, precision="float32"):
    """The reference's last period of the sampled chains, from the
    program's state entering it."""
    cfg, snap, s = run["cfg"], run["snap"], run["sample"]
    nc, cap = _plan(run)
    n_sub, w_disp = _last_segment(run, nc)
    return ref.segment(
        snap["pos"][s], snap["species"][s], snap["energy"][s],
        snap["beta"][s], snap["box"][s], s,
        ref.pair_constants(cfg["eps"], cfg["sig"], cfg["rcut"]),
        cfg["sigma_disp"], D_CAP, nc, cap, run["mc_seed"], run["t0"], n_sub,
        w_disp, run["device"], precision)


def outputs(run):
    """The program's outputs that are judged, as numpy: the sampled
    chains' state after the last period's segment (its own incremental
    energy, before the refresh) and their counts over it, every chain's
    attempts over it, every chain's refreshed energy, the files' last
    rows."""
    fin, snap, pre = run["final"], run["snap"], run["pre_refresh"]
    s = run["sample"]
    cols = _columns(run["wl"])
    cnt = fin["counters"][:, cols].astype(np.int64)
    prev = snap["counters"][:, cols].astype(np.int64)
    return dict(
        pos=pre["pos"][s], species=pre["species"][s].astype(np.float32),
        energy=pre["energy"][s],
        accepted=(cnt - prev)[s, :, 0], attempted=(cnt - prev)[s, :, 1],
        attempted_last=(cnt - prev)[..., 1], counters=fin["counters"],
        cache=fin["energy"].astype(np.float64),
        energy_row=run["files"]["energy_per_particle"][-1],
        acceptance_row=run["files"]["acceptance"][-1])


def control_outputs(run, out):
    """The control put in the program's place: the reference in bfloat16
    over the last period and in the refresh, its files' rows in
    bfloat16."""
    pos, spc, e, acc, att = replay(run, "bfloat16")
    ctl = dict(out)
    ctl.update(pos=pos, species=spc, energy=e, accepted=acc, attempted=att)
    fin = run["final"]
    ctl["cache"] = _energies(run, fin["pos"], fin["species"], "bfloat16")
    n = fin["pos"].shape[1]
    ctl["energy_row"] = float(ref.bf16(np.float32(
        ref.bf16(np.float32(ctl["cache"].mean())) / np.float32(n))))
    from harmonic1d_reference import acceptance
    ctl["acceptance_row"] = acceptance(out["counters"], "bfloat16")
    return ctl


def _last_attempts(run):
    """Every chain's attempts over the last period, from its bind at the
    period's start: the occupancy of a cell does not change within a
    segment, nor its count of A and of B."""
    snap = run["snap"]
    nc, cap = _plan(run)
    n_sub, w_disp = _last_segment(run, nc)
    base = ref.segment_keys(run["mc_seed"], run["t0"])
    m = snap["pos"].shape[0]
    s = ref.fractions(snap["pos"].astype(np.float32),
                      snap["box"].astype(np.float32),
                      ref.origins(base, np.arange(m)))
    return ref.attempts(s, snap["species"], nc, cap,
                        ref.variants(base, n_sub, w_disp))


def compare(run, out, replayed):
    """Each number compared: the sampled chains' last period, every
    chain's attempts over it, the cache refresh, the recorder flush."""
    pos, spc, e, acc, att = replayed
    fin = run["final"]
    n = fin["pos"].shape[1]
    off = (np.any(out["pos"] != pos, axis=(1, 2))
           | np.any(out["species"] != spc, axis=1)
           | (out["energy"] != e)
           | np.any(out["accepted"] != acc, axis=1)
           | np.any(out["attempted"] != att, axis=1))
    e_ref = _energies(run, fin["pos"], fin["species"])
    from harmonic1d_reference import acceptance
    row_ref = e_ref.mean() / n
    return dict(
        chains_off=int(off.sum()),
        attempts_off=int(np.any(out["attempted_last"] != _last_attempts(run),
                                axis=1).sum()),
        cache_gap=float(np.abs(out["cache"] - e_ref).max() / n),
        energy_row_gap=abs(out["energy_row"] - row_ref) / abs(row_ref),
        accept_row_gap=abs(out["acceptance_row"]
                           - acceptance(out["counters"])),
    )
