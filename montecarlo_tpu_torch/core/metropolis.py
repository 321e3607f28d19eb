"""Metropolis–Hastings step and the Metropolis algorithm.

Port of ``montecarlo_tpu/core/metropolis.py`` (ref
``src/metropolis.jl:176-309``).  One step of every chain is a handful of
tensor operations over the chain axis (:func:`mc_step`), a sweep is a
Python loop of steps (:func:`mc_sweep`), and rejection is a ``torch.where``
select.

Randomness, the reference's design (``src/metropolis.jl:262-263``
replaced by counter-based keys): each chain owns the threefry key
``fold_in(key(seed), chain_id)``; step t of the generic path folds t into
it, a sweep splits that key ``sweepstep`` ways, and a step splits its key
into three: the move pick (``categorical`` over the log weights), the
policy's sample and the accept uniform (``utils/prng.py``, the
``jax.random`` stream bit for bit).  So the same seed gives the JAX
package's numbers on any device, and a chain's numbers do not depend on
how the chains are split over ranks.  The fused path draws from the
reference's counter-hash stream and reproduces its interpret-mode results
(``ops/fused_sweep.py``); on a chain mesh its ``sharded_*`` entry points
fold the rank into the sweep seed, as the reference's do.  The
checkerboard cell-MC path (``ops/cell_mc.py``) derives a segment's numbers
from the base key ``fold_in(key(seed), micro_t0)`` of its first
micro-step, chain c's from ``fold_in(base, c)`` over the global chain ids
(:class:`~montecarlo_tpu_torch.ops.cell_mc.KeyDraws`), as the reference's
``cell_mc_segment`` does.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops import cell_mc
from ..utils import prng
from ..utils.observability import count
from ..utils.tree import tree_leaves, tree_map
from .algorithms import DeviceAlgorithm, ObservableRecorder, SimView
from .moves import Move, MoveDef, tree_select

__all__ = [
    "CELL_AUTO_MIN_N",
    "mc_step",
    "mc_sweep",
    "grouped_mc_step",
    "build_move_groups",
    "Metropolis",
    "callback_acceptance",
    "StoreParameters",
]


#: The smallest N at which ``fused='auto'`` takes the cell path for a
#: plannable pool, the reference's.  The port's divergence: a pool that a
#: row kernel takes on the card stays with the row kernel at every N the
#: kernel holds.  That rule rests on the crossover with the eager cell
#: path in plain torch (``chip_smoke.py`` phase 7c), measured before the
#: substep kernel ``csrc/cell_substep.cu``; the cell ``ka2d.n4096.cell``
#: is queued to measure it again.
CELL_AUTO_MIN_N = 2048


def build_move_groups(pool):
    """Group pool moves with identical structure (same ``kind``, aux payload,
    policy class, and flat parameter size) so each group's proposal runs
    once per step.  Returns ``(groups, group_of, within_of)`` with groups a
    tuple of ``(movedef, member_ids)`` and the two lookup arrays mapping
    global move id → (group index, index within group)."""
    keys = []
    for m in pool:
        md = m.move
        size = sum(int(np.asarray(leaf).size) for leaf in tree_leaves(m.params))
        if md.kind:
            keys.append((md.kind, id(md.aux), type(md.policy), size))
        else:
            keys.append(("unique", id(md), id(m)))
    order, members = [], {}
    for k in keys:
        if k not in members:
            members[k] = []
            order.append(k)
    for i, k in enumerate(keys):
        members[k].append(i)
    groups = tuple((pool[members[k][0]].move, tuple(members[k]))
                   for k in order)
    group_of = np.zeros(len(pool), np.int32)
    within_of = np.zeros(len(pool), np.int32)
    for gi, k in enumerate(order):
        for wi, mid in enumerate(members[k]):
            group_of[mid] = gi
            within_of[mid] = wi
    return groups, group_of, within_of


def _pick_moves(log_weights, n_moves, kid):
    """Per-chain categorical move choice from the keys ``kid`` (all zeros
    for a one-move pool, which draws nothing)."""
    if n_moves == 1:
        return torch.zeros(kid.shape[0], dtype=torch.int64,
                           device=kid.device)
    return prng.categorical(kid, log_weights.to(kid.device))


def _propose(md, p, state, ksample, kaccept):
    """Stages 1-7 of ``mc_step!`` for all chains: sample, forward logq,
    apply, invert, backward logq, accept test.  Returns the selected state
    and the (M,) accept mask."""
    action = md.policy.sample(p, ksample, state)
    logq_f = md.policy.log_density(p, action, state)
    new_st, dlogp = md.apply(state, action)
    inv = md.invert(action, new_st)
    logq_b = md.policy.log_density(p, inv, new_st)
    log_ratio = dlogp + logq_b - logq_f
    u = prng.uniform(kaccept, (), log_ratio.dtype)
    accept = torch.log(u) < log_ratio
    return tree_select(accept, new_st, state), accept


def _count(counters, move_id, accept, n_moves):
    onehot = torch.nn.functional.one_hot(move_id, n_moves).to(counters.dtype)
    inc = torch.stack([onehot * accept.to(counters.dtype)[:, None], onehot],
                      dim=-1)
    return counters + inc


def mc_step(movedefs: Sequence[MoveDef], params: Sequence, log_weights,
            state, counters, key):
    """One Metropolis–Hastings step on every chain.

    The 8-stage recipe of ``mc_step!`` + the categorical move selection of
    ``mc_sweep!`` (``src/metropolis.jl:176-212``): each chain splits its key
    in three (pick, sample, accept), picks a move, every move's proposal
    runs over all chains with the same sample and accept keys (as the
    reference's ``lax.switch`` branches do under ``vmap``), and each chain
    keeps the result of its own pick.

    Args:
      movedefs: tuple of :class:`MoveDef` (the pool).
      params: tuple of parameter trees, one per move.
      log_weights: ``log(weight)`` tensor, shape ``(K,)``.
      state: chain-batched system state.
      counters: ``(M, K, 2)`` int32 tensor of (accepted, total) per move.
      key: ``(M, 2)`` uint32 tensor of this step's per-chain keys.

    Returns:
      ``(new_state, new_counters)``.
    """
    n_moves = len(movedefs)
    kid, ksample, kaccept = prng.split(key, 3).unbind(-2)
    move_id = _pick_moves(log_weights, n_moves, kid)
    new_state, accept = _propose(movedefs[0], params[0], state, ksample,
                                 kaccept)
    for k in range(1, n_moves):
        st_k, acc_k = _propose(movedefs[k], params[k], state, ksample,
                               kaccept)
        mine = move_id == k
        new_state = tree_select(mine, st_k, new_state)
        accept = torch.where(mine, acc_k, accept)
    return new_state, _count(counters, move_id, accept, n_moves)


def grouped_mc_step(groups, group_of, within_of, params, log_weights,
                    n_moves, state, counters, key):
    """Like :func:`mc_step`, but moves with identical structure are grouped:
    a group's proposal runs once, with each chain's parameters gathered from
    the members' stacked parameters, instead of once per move.  Selection,
    per-move counters and the acceptance rule are those of :func:`mc_step`.

    Args:
      groups: tuple of ``(movedef, member_move_ids)``.
      group_of / within_of: int arrays mapping global move id to (group
        index, index within the group's stacked params).
    """
    device = counters.device
    kid, ksample, kaccept = prng.split(key, 3).unbind(-2)
    move_id = _pick_moves(log_weights, n_moves, kid)
    w = torch.as_tensor(within_of, device=device).long()[move_id]
    g = torch.as_tensor(group_of, device=device).long()[move_id]
    new_state = accept = None
    for gi, (md, members) in enumerate(groups):
        if len(members) == 1:
            p = params[members[0]]
        else:
            p = tree_map(lambda *xs: torch.stack(xs)[w],
                         *[params[lid] for lid in members])
        st_g, acc_g = _propose(md, p, state, ksample, kaccept)
        if new_state is None:
            new_state, accept = st_g, acc_g
        else:
            mine = g == gi
            new_state = tree_select(mine, st_g, new_state)
            accept = torch.where(mine, acc_g, accept)
    return new_state, _count(counters, move_id, accept, n_moves)


def mc_sweep(movedefs, params, log_weights, state, counters, key,
             mc_steps: int = 1, step_fn=None):
    """``mc_steps`` MH steps on every chain (ref ``mc_sweep!``,
    ``src/metropolis.jl:203-212``): one step takes ``key`` itself, more
    split it ``mc_steps`` ways, a key a step, as the reference's scan."""
    if step_fn is None:
        step_fn = lambda st, cnt, k: mc_step(
            movedefs, params, log_weights, st, cnt, k)
    if mc_steps == 1:
        return step_fn(state, counters, key)
    keys = prng.split(key, mc_steps)
    for s in range(mc_steps):
        state, counters = step_fn(state, counters, keys[:, s])
    return state, counters


class Metropolis(DeviceAlgorithm):
    """Metropolis sampler over all chains (ref ``Metropolis``,
    ``src/metropolis.jl:232-309``).

    Owns the move pool; move parameters are stored once in device state
    (``dstate['params']``) and shared by every chain.

    ``fused`` selects the path:

    - ``'auto'``: a CUDA sweep kernel when the chains are on a CUDA device
      and the pool is fusable (:attr:`supports_fused`), else the generic
      path;
    - ``'off'``: always the generic path;
    - ``'interpret'``: the fused path through the kernel's plain torch
      version, on any device (CPU tests);
    - ``'cell'``: the checkerboard cell-MC path (``ops/cell_mc.py``, 2-D
      or 3-D, with volume substeps for a pool that carries a volume move),
      plain torch on any device.  ``'auto'`` takes it too for a plannable
      pool at N >= :data:`CELL_AUTO_MIN_N` that no row kernel takes.

    ``cell_opts`` tunes the cell-MC plan: ``d_cap`` (the anchor halo, real
    units, default 0.45), ``cap_slack`` (the cell capacity as a multiple
    of the mean occupancy, default 2.0) and ``box_margin`` (NPT compression
    headroom as a fraction of the box, default 0.15 when the pool carries a
    volume move, else 0).
    """

    state_key = "metropolis"
    #: device-state slot holding this instance's move parameters; the
    #: orchestrator reassigns it (``params_<state_key>``) for a second
    #: params-owning algorithm in the same simulation
    params_key = "params"

    def __init__(self, sim, pool: Sequence[Move] = (), sweepstep: int = 1,
                 seed: int = 1, fused: str = "auto", cell_opts: dict = None,
                 dependencies=(), **_):
        if not pool:
            raise ValueError("Metropolis requires a non-empty move pool")
        if fused not in ("auto", "off", "interpret", "cell"):
            raise ValueError(
                "fused must be 'auto' (CUDA kernel on a CUDA device when the "
                "pool is fusable), 'off' (always the generic path), "
                "'interpret' (force the fused path through the kernel's "
                "plain torch version — CPU testing), or 'cell' (force the "
                "checkerboard cell-MC path for large-N particle systems)")
        unknown = set(cell_opts or {}) - {"d_cap", "cap_slack", "box_margin"}
        if unknown:
            raise ValueError(f"cell_opts takes 'd_cap', 'cap_slack' and "
                             f"'box_margin', not {sorted(unknown)}")
        self.fused = fused
        self.pool = tuple(pool)
        self.movedefs = tuple(m.move for m in self.pool)
        self.weights = np.asarray([m.weight for m in self.pool], np.float32)
        if not np.all(self.weights > 0):
            raise ValueError("move weights must be positive")
        self.log_weights = torch.as_tensor(
            np.log(self.weights / self.weights.sum()))
        self.sweepstep = int(sweepstep)
        self.seed = int(seed)
        self.mesh = getattr(sim, "mesh", None)
        self.n_chains = sim.n_chains
        self.n_moves = len(self.pool)
        self.device = sim.device
        self.groups, self.group_of, self.within_of = build_move_groups(
            self.pool)
        # spatial dimension of particle states (None for other systems)
        pos0 = getattr(sim.chains0, "pos", None)
        self._pos_dim = None if pos0 is None else int(pos0.shape[-1])
        # the fast paths are those of the family every move carries
        family = self.movedefs[0].family
        if any(md.family is not family for md in self.movedefs):
            family = None
        # on a mesh, the row sweep's sharded entry point: this rank's
        # chains, the rank folded into the seed
        mesh = () if self.mesh is None else (self.mesh, self.mesh.axis)
        self._row = family and family.row and family.row(
            self.pool, sim.chains0, mesh, fused == "interpret")
        self._cell_disabled = False
        self._plan_cell_mc(sim, cell_opts or {}, family)

    def _plan_cell_mc(self, sim, opts, family):
        """Plan the checkerboard cell-MC decomposition (``ops/cell_mc.py``):
        per-move cost O(3^dim C) instead of O(N), ~N/2^dim moves in parallel
        per substep, 2-D and 3-D.  ``opts`` is ``cell_opts``."""
        self._cell_plan = None
        self._cell_model = None
        self._cell_plan_error = None

        def unsupported(reason):
            # an EXPLICIT fused='cell' request must fail loudly instead of
            # silently degrading to a slower path
            self._cell_plan_error = reason
            if self.fused == "cell":
                raise ValueError(f"fused='cell' requested but {reason}")

        if self._pos_dim not in (None, 2, 3):
            return unsupported(
                f"the cell decomposition is 2-D/3-D only (state has "
                f"{self._pos_dim}-D positions)")
        kinds = tuple(m.move.kind for m in self.pool)
        roles = [md.family.roles.get(md.kind) if md.family else None
                 for md in self.movedefs]
        if None in roles:
            return unsupported(
                f"the pool kinds {kinds} have no cell-MC mapping (need a "
                f"single LJ/poly/hard-disk displacement move, optionally + "
                f"the matching swap and/or volume move)")
        if family is None or roles.count("disp") != 1 \
                or roles.count("swap") > 1 or roles.count("vol") > 1:
            return unsupported(
                f"the pool kinds {kinds} have no cell-MC mapping (need "
                f"one family with one displacement move, at most one swap "
                f"and one volume move)")
        disp, swap, vol = (roles.index(r) if r in roles else None
                           for r in ("disp", "swap", "vol"))
        aux = self.pool[disp].move.aux
        if swap is not None and self.pool[swap].move.aux != aux:
            return unsupported(
                "the displacement and swap moves carry different "
                "interaction tables (no shared cell geometry)")
        pressure = None
        if vol is not None:
            vaux = self.pool[vol].move.aux
            if (not isinstance(vaux, tuple) or len(vaux) != 2
                    or vaux[0] != aux):
                return unsupported(
                    "the volume move carries a different interaction table "
                    "than the displacement move (no shared cell geometry)")
            pressure = float(vaux[1])
        try:
            model = family.cell(aux)
            if swap is None:
                model = dataclasses.replace(model, swap_mode=None)
            state0 = sim.chains0
            box0 = float(state0.box.reshape(-1)[0])
            n_particles = int(state0.pos.shape[-2])
            dim = self._pos_dim
            kw = dict(d_cap=float(opts.get("d_cap", 0.45)),
                      cap_slack=float(opts.get("cap_slack", 2.0)), dim=dim,
                      box_margin=float(opts.get(
                          "box_margin", 0.15 if vol is not None else 0.0)))
            plan0 = cell_mc.plan_grid(n_particles, box0, model.rcut_max, **kw)
            # capacity from the initial configuration's observed maximum
            # per-cell occupancy (a mean multiple under-sizes clustered
            # states), scaled for the compression volume moves may bring
            max_occ = _max_cell_occupancy(state0, plan0.nc, dim)
            if vol is not None:
                max_occ = int(np.ceil(
                    max_occ * (box0 / plan0.box_min) ** dim))
            self._cell_plan = cell_mc.plan_grid(
                n_particles, box0, model.rcut_max, max_occupancy=max_occ, **kw)
            self._cell_model = CellPool(model, disp, swap, vol, pressure)
            self._cell_n = n_particles
        except (ValueError, AttributeError) as e:
            self._cell_plan = None  # box too small / no geometry
            self._cell_plan_error = str(e)
            if self.fused == "cell":
                raise ValueError(
                    f"fused='cell' requested but the cell decomposition "
                    f"cannot be planned: {e}") from e

    def disable_cell_path(self):
        """Orchestrator fallback hook: permanently drop the cell path (an
        auto-selected cell bind overflowed mid-run); the row or generic
        path takes over."""
        self._cell_disabled = True
        self._cell_plan_error = (
            "disabled mid-run: a cell bind exceeded the planned capacity; "
            "fell back to the row or generic path")

    @property
    def _use_cell(self) -> bool:
        if self._cell_plan is None or self._cell_disabled:
            return False
        if self.fused == "cell":
            return True   # explicit opt-in (validate_state surfaces misuse)
        return (self.fused == "auto" and self._cell_n >= CELL_AUTO_MIN_N
                and not self._row_takes)

    class CellBindInvalid(RuntimeError):
        """An auto-selected cell bind overflowed; the orchestrator catches
        this at the next host sync point and falls back (the offending
        segments were skipped as no-ops)."""

        def __init__(self, alg):
            self.alg = alg
            super().__init__("cell-MC bind became invalid during the run")

    def init_state(self, sim):
        # chain c's key fold_in(key(seed), c) over the global chain ids: a
        # mesh slices it with the chains, so streams do not depend on ranks
        chain_ids = torch.arange(self.n_chains, device=self.device)
        keys = prng.fold_in(prng.key(self.seed, self.device)[None],
                            chain_ids)
        counters = torch.zeros((self.n_chains, self.n_moves, 2),
                               dtype=torch.int32, device=self.device)
        slc = {"keys": keys, "counters": counters}
        if self._cell_plan is not None:
            # a latched flag, read on the host at every sync point: a cell
            # bind became invalid.  cell_debt carries the fractional-substep
            # credit between segments, in the reference's float32
            # arithmetic; it stays on the host, so a segment's substep count
            # needs no read from the card.
            slc["cell_overflow"] = torch.zeros((), dtype=torch.bool,
                                               device=self.device)
            slc["cell_debt"] = torch.zeros((), dtype=torch.float32)
        return slc

    def validate_state(self, dstate):
        """Host-side check at every sync point: surface a latched
        invalid-cell-bind flag (the affected segments were skipped as
        no-ops, so the state is whole but under-sampled).  Auto-selected
        runs raise :class:`CellBindInvalid`, which the orchestrator catches
        to fall back; an explicit ``fused='cell'`` run fails loudly.  On a
        mesh the flag is first reduced over the ranks (MAX), so every rank
        raises, or none."""
        if self._cell_disabled:
            return
        flag = dstate.get(self.state_key, {}).get("cell_overflow")
        if flag is None:
            return
        if self.mesh is not None:
            flag = self.mesh.all_reduce(flag.to(torch.int32), "max")
        count("host_syncs")
        if bool(flag):
            if self.fused != "cell":
                raise Metropolis.CellBindInvalid(self)
            raise RuntimeError(
                "cell-MC bind became invalid during the run: a cell "
                "exceeded its static capacity, or a chain's box shrank "
                "below the planned grid's validity floor.  The affected "
                "segments were skipped (no-op, zero counters).  Enlarge "
                "cell_opts={'cap_slack': ...}, or use fused='off'.")

    def init_params(self):
        """Initial shared move parameters (tuple, one tree per move)."""
        return tuple(
            tree_map(lambda x: torch.as_tensor(x).to(self.device), m.params)
            for m in self.pool)

    # -- generic step --------------------------------------------------------
    def step(self, dstate, t):
        slc = dstate[self.state_key]
        params = dstate[self.params_key]

        def step_fn(st, cnt, k):
            return grouped_mc_step(self.groups, self.group_of, self.within_of,
                                   params, self.log_weights, self.n_moves,
                                   st, cnt, k)

        sys, counters = mc_sweep(self.movedefs, params, self.log_weights,
                                 dstate["sys"], slc["counters"],
                                 prng.fold_in(slc["keys"], t),
                                 self.sweepstep, step_fn=step_fn)
        return {**dstate, "sys": sys,
                self.state_key: {**slc, "counters": counters}}

    # -- fused fast path -----------------------------------------------------
    @property
    def supports_fused(self) -> bool:
        """True when the fused path runs this pool: its family's row sweep
        (on a CUDA device; under ``'interpret'`` its plain version on any
        device) or the cell path (:attr:`_use_cell`, any device)."""
        if self.fused == "off":
            return False
        if self.fused == "cell":
            return self._cell_plan is not None
        return self._use_cell or self._row_takes

    @property
    def _row_takes(self) -> bool:
        return self._row is not None and (self.fused == "interpret"
                                          or self.device.type == "cuda")

    def fused_advance(self, dstate, n_steps: int):
        """Advance all chains ``n_steps * sweepstep`` MH steps in one sweep
        call; counters and cached energies as :meth:`step` keeps them."""
        slc = dstate[self.state_key]
        t0, n = dstate["t"], int(n_steps)
        # seeding off the absolute micro-step keeps results invariant to how
        # recorder schedules cut the run into segments
        args = (dstate["sys"], dstate[self.params_key], self.seed,
                t0 * self.sweepstep, n * self.sweepstep)
        if self._use_cell:
            sys, inc, slc = self._cell_segment(slc, *args)
        else:
            sys, inc = self._row(*args)
        return {**dstate, "sys": sys, "t": t0 + n,
                self.state_key: {**slc, "counters": slc["counters"] + inc}}

    def _cell_segment(self, slc, sys, params, seed, micro_t0, n_moves):
        """The checkerboard cell-MC segment for ``n_moves`` requested moves
        per chain (``ops/cell_mc.py``): the new state, the counters'
        increment and the device-state slot's new debt and flag."""
        plan, pool = self._cell_plan, self._cell_model
        wsum = float(self.weights.sum())
        w = [float(self.weights[i]) / wsum if i is not None else 0.0
             for i in (pool.disp, pool.swap, pool.vol)]
        # a displacement or swap substep delivers ~a_att attempts per chain,
        # a volume substep one; z substeps per requested move, the
        # fractional remainder carried in cell_debt (float32, as the
        # reference computes it) so fine recorder strides do not round
        # every segment up to a whole substep
        a_att = plan.nc ** plan.dim // 2 ** plan.dim
        z = (w[0] + w[1]) / a_att + w[2]
        want = np.float32(n_moves) * np.float32(z) + slc["cell_debt"].numpy()
        substeps = int(np.floor(want))
        vol, dlnv = None, 0.0
        if pool.vol is not None:
            vol, dlnv = (self._cell_n, pool.pressure), params[pool.vol]["dlnv"]
        m = sys.pos.shape[0]
        # the global ids of this rank's chains (the mesh's contiguous slice)
        lo = 0 if self.mesh is None else self.mesh.rank * m
        draws = cell_mc.KeyDraws(
            seed, micro_t0, torch.arange(lo, lo + m, device=sys.pos.device))
        pos, attr, energy, box, att, acc, ovf = cell_mc.cell_mc_segment(
            plan, pool.model, draws, sys.pos, *pool.model.leaves(sys),
            tree_leaves(params[pool.disp])[0], substeps,
            w_disp=(w[0] / a_att) / z, w_swap=(w[1] / a_att) / z,
            box=sys.box, vol=vol, dlnv=dlnv)
        # an NVT pool keeps the box as given (0-d too)
        upd = {"pos": pos, **({} if vol is None else {"box": box})}
        inc = torch.zeros_like(slc["counters"])
        for col, idx in enumerate((pool.disp, pool.swap, pool.vol)):
            if idx is not None:
                inc[:, idx] = torch.stack([acc[:, col], att[:, col]], dim=-1)
        debt = torch.tensor(want - np.float32(substeps), dtype=torch.float32)
        return (pool.model.update(sys, upd, attr, energy), inc,
                {**slc, "cell_debt": debt,
                 "cell_overflow": slc["cell_overflow"] | torch.any(ovf)})

    # -- summary -------------------------------------------------------------
    def write_summary(self, io, scheduler):
        from .algorithms import _n_calls
        n_dev = _n_devices(self.mesh, self.device)
        io.write("\tMetropolis\n")
        io.write(f"\t\tCalls: {_n_calls(scheduler)}\n")
        io.write(f"\t\tMC steps per simulation step: {self.sweepstep}\n")
        io.write(f"\t\tSeed: {self.seed}\n")
        io.write(f"\t\tParallel: {n_dev > 1}\n")
        io.write(f"\t\tDevices: {n_dev}\n")
        if self._use_cell:
            io.write(f"\t\tCell MC: enabled ({self._cell_plan!r})\n")
        elif self._pos_dim is not None and self._cell_plan_error is not None:
            # a particle system without a cell plan: record why
            io.write(f"\t\tCell MC: unavailable — "
                     f"{self._cell_plan_error}\n")
        elif (self.fused == "auto" and self._cell_plan is not None
              and self._cell_n >= CELL_AUTO_MIN_N):
            # the reference would take the cell path here
            io.write(f"\t\tCell MC: off — a row kernel takes this pool at "
                     f"N {self._cell_n}, where it was faster than the cell "
                     f"path on the H100; fused='cell' forces "
                     f"{self._cell_plan!r}\n")
        io.write("\t\tMoves:\n")
        for k, move in enumerate(self.pool):
            io.write(f"\t\t\tMove {k + 1}:\n")
            io.write(f"\t\t\t\tAction: {move.move.name}\n")
            io.write(f"\t\t\t\tPolicy: {type(move.move.policy).__name__}\n")
            io.write(f"\t\t\t\tParameters: {_fmt_params(move.params)}\n")
            io.write(f"\t\t\t\tWeight: {move.weight}\n")


@dataclasses.dataclass(frozen=True)
class CellPool:
    """A pool's cell-path plan: the cell model (``swap_mode`` None without
    a swap), the indices of the displacement, swap and volume moves in the
    pool (None: absent) and the volume move's pressure."""

    model: cell_mc.CellModel
    disp: int
    swap: Optional[int]
    vol: Optional[int]
    pressure: Optional[float]


def _n_devices(mesh, device) -> int:
    """The ``Devices:`` count of ``summary.log``: the mesh's ranks, or
    without a mesh the CUDA devices (1 on the CPU)."""
    if mesh is not None:
        return mesh.size
    return torch.cuda.device_count() if device.type == "cuda" else 1


def _fmt_params(params) -> str:
    flat = np.concatenate(
        [np.ravel(torch.as_tensor(x).detach().cpu().numpy())
         for x in tree_leaves(params)])
    return "[" + ", ".join(repr(float(v)) for v in flat) + "]"


def _max_cell_occupancy(state0, nc: int, dim: int,
                        max_chains: int = 64) -> int:
    """Max per-cell particle count of the initial configuration (host-side
    numpy, over at most ``max_chains`` chains): sizes the cell capacity
    from an observed maximum instead of the mean.  A 0-d box (one edge for
    every chain) plans as well as a per-chain one."""
    pos = state0.pos[:max_chains].detach().cpu().numpy()
    box = state0.box.reshape(-1)[:max_chains].detach().cpu().numpy()
    ci = np.clip((pos / box.reshape(-1, 1, 1) * nc).astype(np.int64), 0,
                 nc - 1)
    cid = ci[..., 0]
    for a in range(1, dim):
        cid = cid * nc + ci[..., a]
    m = pos.shape[0]
    cid = cid + nc ** dim * np.arange(m)[:, None]
    return int(np.bincount(cid.ravel()).max())


def callback_acceptance(view: SimView):
    """Mean acceptance rate over chains and moves of EVERY Metropolis
    instance (ref ``callback_acceptance``, ``src/metropolis.jl:319-321``).
    Entries with zero attempts (e.g. the t=0 ``store_first`` row) are
    excluded from the mean instead of producing 0/0 = nan."""
    num = den = None
    for key in view.state:
        if not key.startswith("metropolis"):
            continue
        slc = view.state[key]
        if not isinstance(slc, dict) or "counters" not in slc:
            continue
        counters = slc["counters"]                       # (M, K, 2)
        acc = counters[..., 0].to(torch.float32)
        tot = counters[..., 1].to(torch.float32)
        valid = tot > 0
        n = torch.sum(torch.where(valid, acc / torch.clamp(tot, min=1.0),
                                  0.0))
        d = torch.sum(valid.to(torch.float32))
        num = n if num is None else num + n
        den = d if den is None else den + d
    if num is None:
        return torch.zeros((), dtype=torch.float32)
    return num / torch.clamp(den, min=1.0)


class StoreParameters(ObservableRecorder):
    """Snapshot shared move parameters to ``parameters/<k>/parameters.dat``
    (ref ``StoreParameters``, ``src/metropolis.jl:380-450``)."""

    def __init__(self, sim, dependencies=(), ids=None, store_first: bool = True,
                 store_last: bool = False, **_):
        deps = [d for d in dependencies if isinstance(d, Metropolis)]
        if len(deps) != 1:
            raise ValueError(
                "StoreParameters requires a single Metropolis dependency "
                "(with two samplers, disambiguate with an index: "
                "dependencies=(0,))")
        self.metropolis = deps[0]
        n_moves = self.metropolis.n_moves
        self.ids = list(range(n_moves)) if ids is None else list(ids)
        self.store_first = store_first
        self.store_last = store_last
        self._root = sim.path
        self.dirs = []
        self.paths = []
        self.files = []

    def _resolve_paths(self):
        # the primary sampler keeps the reference layout
        # parameters/<k>/parameters.dat; further samplers are namespaced by
        # their state key.  Deferred to initialise: state keys are final
        # only after Simulation construction.
        base = os.path.join(self._root, "parameters")
        if self.metropolis.params_key != "params":
            base = os.path.join(base, self.metropolis.state_key)
        self.dirs = [os.path.join(base, str(k + 1)) for k in self.ids]
        self.paths = [os.path.join(d, "parameters.dat") for d in self.dirs]

    def initialise(self, sim):
        from .algorithms import _io_host
        self._resolve_paths()
        if not _io_host(sim):
            return
        if sim.verbose:
            print("Opening parameter files...")
        for d in self.dirs:
            os.makedirs(d, exist_ok=True)
        self.files = [open(p, "w") for p in self.paths]

    def observable(self, view: SimView):
        params = view.state[self.metropolis.params_key]
        return tuple(params[k] for k in self.ids)

    def write(self, sim, t, value):
        for f, p in zip(self.files, value):
            f.write(f"{t} {_fmt_params(p)}\n")
            f.flush()

    def finalise(self, sim):
        if sim.verbose:
            print("Closing parameter files...")
        for f in self.files:
            f.close()
        self.files = []
