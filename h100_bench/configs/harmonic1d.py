"""How the benchmark drives ``montecarlo_tpu_torch`` on the ``harmonic1d``
configuration, and how a run of it is judged against the plain reference
(``harmonic1d_reference.py``)."""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import harmonic1d_reference as ref  # noqa: E402
from harness.metropolis import algorithms, counters, moves, path  # noqa: E402,F401

#: the per-chain state leaves a snapshot keeps
STATE_LEAVES = ("x", "e", "beta")


def make(cfg, wl, seeds, device):
    """The system, the initial chains (made on ``device`` from the seed),
    the move pool and the callbacks by name."""
    import montecarlo_tpu_torch as mc
    from montecarlo_tpu_torch.models import particle1d as p1d
    if cfg["potential"] != "harmonic":
        raise ValueError(f"no potential {cfg['potential']!r}")
    by_kind = {"displacement": lambda w: p1d.displacement_move(
        sigma=cfg["sigma"], weight=w)}
    return dict(
        system=p1d.make_system(p1d.harmonic),
        chains=p1d.init_chains(wl["chains"], beta=cfg["beta"],
                               seed=seeds["chains"], device=device),
        pool=tuple(by_kind[p["move"]](p["weight"]) for p in wl["pool"]),
        callbacks={"energy": p1d.callback_energy,
                   "acceptance": mc.callback_acceptance},
    )


def kernel(wl):
    """The row kernel a run of this cell launches."""
    from montecarlo_tpu_torch.ops.fused_sweep import SWEEP_KERNEL
    return SWEEP_KERNEL


def replay(run, precision="float32"):
    """The reference's last period of the sampled chains, from the
    program's state entering it."""
    s = run["sample"]
    snap = run["snap"]
    return ref.replay(snap["x"][s], snap["beta"][s], s, run["chains"],
                      run["cfg"]["sigma"], run["mc_seed"], run["t0"],
                      run["n_steps"], run["device"], precision)


def outputs(run):
    """The program's outputs that are judged, as numpy: the sampled
    chains' final state and accept counts over the last period, every
    chain's attempts, the files' last rows and the BIN frames."""
    fin, snap = run["final"], run["snap"]
    s = run["sample"]
    cnt = fin["counters"].astype(np.int64)
    return dict(
        x=fin["x"][s], e=fin["e"][s],
        accepted=(cnt[s, 0, 0] - snap["counters"][s, 0, 0].astype(np.int64)),
        attempted_all=cnt[:, :, 1],
        energy_row=run["files"]["energy"][-1],
        acceptance_row=run["files"]["acceptance"][-1],
        frames=run["files"].get("frames"),
        x_all=fin["x"], counters=cnt)


def control_outputs(run, out):
    """The control put in the program's place: the reference in bfloat16
    over the last period, its files' rows computed in bfloat16."""
    x, e, acc = replay(run, "bfloat16")
    ctl = dict(out)
    ctl.update(x=x, e=e, accepted=acc.astype(np.int64))
    x_all = out["x_all"].copy()
    x_all[run["sample"]] = x
    ctl["x_all"] = x_all
    ctl["energy_row"] = ref.mean_energy(x_all, "bfloat16")
    ctl["acceptance_row"] = ref.acceptance(out["counters"], "bfloat16")
    if out["frames"] is not None:
        frames = out["frames"].copy()
        frames[-1] = ref.bf16(frames[-1])
        ctl["frames"] = frames
    return ctl


def compare(run, out, replayed):
    """Each number compared: the kernel's output on the sampled chains,
    every chain's attempts, the recorder flush.  ``replayed`` is the fp32
    reference's ``(x, e, accepted)``."""
    x, e, acc = replayed
    steps = run["periods"] * run["stride"] * run["sweepstep"]
    off = ((out["x"] != x) | (out["e"] != e) | (out["accepted"] != acc))
    e_ref = ref.mean_energy(out["x_all"])
    nums = dict(
        chains_off=int(off.sum()),
        attempts_off=int(np.any(out["attempted_all"] != steps, axis=1).sum()),
        energy_row_gap=abs(out["energy_row"] - e_ref) / abs(e_ref),
        accept_row_gap=abs(out["acceptance_row"]
                           - ref.acceptance(out["counters"])),
    )
    if out["frames"] is not None:
        nums["frame_gap"] = float(max(
            np.abs(out["frames"][-1] - out["x_all"]).max(),
            np.abs(out["frames"][-2] - run["snap"]["x"]).max()))
    return nums
