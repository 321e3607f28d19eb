"""How the benchmark drives ``montecarlo_tpu_torch`` on the ``ka2d``
configuration, and how a run of it is judged against the plain reference
(``ka2d_reference.py``)."""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import ka2d_reference as ref  # noqa: E402
from harness.metropolis import algorithms, counters, moves, path  # noqa: E402,F401

#: the per-chain state leaves a snapshot keeps
STATE_LEAVES = ("pos", "species", "energy", "beta", "box")


def _params(cfg):
    from montecarlo_tpu_torch.models import lennard_jones as lj
    return lj.LJParams(eps=tuple(map(tuple, cfg["eps"])),
                       sig=tuple(map(tuple, cfg["sig"])), rcut=cfg["rcut"])


def make(cfg, wl, seeds, device):
    """The system, the initial chains (made on ``device`` from the seed),
    the move pool and the callbacks by name."""
    import montecarlo_tpu_torch as mc
    from montecarlo_tpu_torch.models import lennard_jones as lj
    if cfg["dimensions"] != 2:
        raise ValueError("the ka2d configuration is 2-D")
    if wl["path"] != "row":
        raise ValueError("the reference replays the row kernel's path only")
    params = _params(cfg)
    by_kind = {
        "displacement": lambda w: lj.lj_displacement_move(
            sigma=cfg["sigma_disp"], weight=w, params=params),
        "swap": lambda w: lj.lj_swap_move(weight=w, params=params)}
    return dict(
        system=lj.make_system(params),
        chains=lj.init_chains(wl["chains"], wl["n_particles"],
                              rho=cfg["rho"], beta=1.0 / cfg["temperature"],
                              frac_b=cfg["frac_b"], seed=seeds["chains"],
                              params=params, device=device),
        pool=tuple(by_kind[p["move"]](p["weight"]) for p in wl["pool"]),
        callbacks={"energy_per_particle": lj.callback_energy_per_particle,
                   "acceptance": mc.callback_acceptance},
    )


def kernel(wl):
    """The row kernel a run of this cell launches."""
    from montecarlo_tpu_torch.ops.lj_sweep import LJ_MIXED_KERNEL
    return LJ_MIXED_KERNEL


def _table(run):
    cfg = run["cfg"]
    return ref.pair_table(cfg["eps"], cfg["sig"], cfg["rcut"], run["box"])


def _w_disp(wl):
    w = np.asarray([p["weight"] for p in wl["pool"]], np.float32)
    kinds = [p["move"] for p in wl["pool"]]
    return float(w[kinds.index("displacement")] / w.sum())


def _columns(wl):
    """The counters' move columns of the displacement and the swap."""
    kinds = [p["move"] for p in wl["pool"]]
    return [kinds.index(k) for k in ("displacement", "swap") if k in kinds]


def replay(run, precision="float32"):
    """The reference's last period of the sampled chains, from the
    program's state entering it."""
    s = run["sample"]
    snap = run["snap"]
    return ref.replay(snap["pos"][s], snap["species"][s], snap["energy"][s],
                      snap["beta"][s], s, run["chains"], _table(run),
                      run["cfg"]["sigma_disp"], _w_disp(run["wl"]),
                      run["mc_seed"], run["t0"], run["n_steps"],
                      run["device"], precision)


def _energies(run, pos, spc, precision="float64"):
    cfg = run["cfg"]
    return ref.total_energy(pos, spc, run["box"], cfg["eps"], cfg["sig"],
                            cfg["rcut"], run["device"], precision)


def outputs(run):
    """The program's outputs that are judged, as numpy: the sampled
    chains' state after the last period's sweep (the kernel's own
    incremental energy, before the refresh) and their counts over it,
    every chain's attempts and refreshed energy, the files' last rows."""
    fin, snap, pre = run["final"], run["snap"], run["pre_refresh"]
    s = run["sample"]
    cols = _columns(run["wl"])
    cnt = fin["counters"][:, cols].astype(np.int64)
    prev = snap["counters"][s][:, cols].astype(np.int64)
    return dict(
        pos=pre["pos"][s], species=pre["species"][s].astype(np.float32),
        energy=pre["energy"][s],
        accepted=cnt[s, :, 0] - prev[..., 0],
        attempted=cnt[s, :, 1] - prev[..., 1],
        attempted_all=cnt[..., 1], counters=fin["counters"],
        cache=fin["energy"].astype(np.float64),
        energy_row=run["files"]["energy_per_particle"][-1],
        acceptance_row=run["files"]["acceptance"][-1])


def control_outputs(run, out):
    """The control put in the program's place: the reference in bfloat16
    over the last period and in the refresh, its files' rows in
    bfloat16."""
    pos, spc, e, acc, att = replay(run, "bfloat16")
    ctl = dict(out)
    ctl.update(pos=pos, species=spc, energy=e, accepted=acc.astype(np.int64),
               attempted=att.astype(np.int64))
    fin = run["final"]
    ctl["cache"] = _energies(run, fin["pos"], fin["species"], "bfloat16")
    n = fin["pos"].shape[1]
    ctl["energy_row"] = float(ref.bf16(np.float32(
        ref.bf16(np.float32(ctl["cache"].mean())) / np.float32(n))))
    from harmonic1d_reference import acceptance
    ctl["acceptance_row"] = acceptance(out["counters"], "bfloat16")
    return ctl


def _window_attempts(run):
    """Every chain's attempts over the window, from the block-shared kind
    draws of all its steps."""
    m = run["chains"]
    steps = run["periods"] * run["stride"] * run["sweepstep"]
    bc = min(256, max(8, m))
    pids = np.arange(-(-m // bc))
    kinds = ref.step_kinds(run["mc_seed"], 0, steps, pids,
                           np.float32(_w_disp(run["wl"])))
    n_disp = kinds.sum(axis=0)[np.arange(m) // bc]
    return np.stack([n_disp, steps - n_disp], axis=1)


def compare(run, out, replayed):
    """Each number compared: the kernel's output on the sampled chains,
    every chain's attempts, the cache refresh, the recorder flush."""
    pos, spc, e, acc, att = replayed
    fin = run["final"]
    n = fin["pos"].shape[1]
    off = (np.any(out["pos"] != pos, axis=(1, 2))
           | np.any(out["species"] != spc, axis=1)
           | (out["energy"] != e)
           | np.any(out["accepted"] != acc, axis=1)
           | np.any(out["attempted"] != att, axis=1))
    want = _window_attempts(run)
    e_ref = _energies(run, fin["pos"], fin["species"])
    from harmonic1d_reference import acceptance
    row_ref = e_ref.mean() / n
    return dict(
        chains_off=int(off.sum()),
        attempts_off=int(np.any(out["attempted_all"] != want, axis=1).sum()),
        cache_gap=float(np.abs(out["cache"] - e_ref).max() / n),
        energy_row_gap=abs(out["energy_row"] - row_ref) / abs(row_ref),
        accept_row_gap=abs(out["acceptance_row"]
                           - acceptance(out["counters"])),
    )
