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
from typing import Sequence

import numpy as np
import torch

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
#: kernel holds, where the eager cell path was slower on an H100
#: (``chip_smoke.py`` phase 7c; ``ROADMAP.md`` queue 3).
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
        self._n_particles = None if pos0 is None else int(pos0.shape[-2])
        self._fused_pool = self._recognise_pool()
        self._box = None
        if self._fused_pool in ("lj", "lj_mixed", "poly_mixed"):
            # the kernels take one box for all chains, as the reference
            # passes sys.box[0]; read once here, never per segment
            self._box = float(sim.chains0.box.reshape(-1)[0])
        self._cell_disabled = False
        self._plan_cell_mc(sim, cell_opts or {})

    def _recognise_pool(self):
        """Which fused sweep the pool's structure maps onto: ``'gaussian'``
        (one Gaussian displacement of a 1-D particle), ``'lj'`` (one 2-D LJ
        displacement), ``'lj_mixed'`` (2-D LJ displacement + swap sharing
        one interaction table), ``'poly_mixed'`` (2-D polydisperse
        displacement + diameter swap sharing one ``PolyParams``, N >= 2), or
        None.  A lone polydisperse displacement has no kernel, in the
        reference as here."""
        kinds = tuple(m.move.kind for m in self.pool)
        if kinds == ("gaussian_displacement_1d",):
            return "gaussian"
        if self._pos_dim != 2:
            return None       # the particle row kernels are 2-D
        if kinds == ("lj_displacement_2d",):
            return "lj"
        if len(kinds) != 2 or self.pool[0].move.aux != self.pool[1].move.aux:
            return None
        if set(kinds) == {"lj_displacement_2d", "lj_swap"}:
            return "lj_mixed"
        if set(kinds) == {"poly_displacement_2d", "poly_swap"}:
            # a swap needs two particles; the reference's kernel draws
            # j = -1 at N = 1, the port leaves that pool to the generic path
            return "poly_mixed" if self._n_particles >= 2 else None
        return None

    #: kind tag -> (family, role): a pool maps onto the cell path when it is
    #: one displacement move of a single family, optionally + the matching
    #: swap and/or volume move
    _CELL_KINDS = {
        "lj_displacement_2d": ("lj", "disp"),
        "lj_swap": ("lj", "swap"),
        "lj_volume": ("lj", "vol"),
        "poly_displacement_2d": ("poly", "disp"),
        "poly_swap": ("poly", "swap"),
        "poly_volume": ("poly", "vol"),
        "hard_disk_displacement_2d": ("hd", "disp"),
        "hard_disk_volume": ("hd", "vol"),
    }

    def _plan_cell_mc(self, sim, opts):
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
        if not kinds or any(k not in self._CELL_KINDS for k in kinds):
            return unsupported(
                f"the pool kinds {kinds} have no cell-MC mapping (need a "
                f"single LJ/poly/hard-disk displacement move, optionally + "
                f"the matching swap and/or volume move)")
        families = {self._CELL_KINDS[k][0] for k in kinds}
        roles = [self._CELL_KINDS[k][1] for k in kinds]
        if len(families) != 1 or roles.count("disp") != 1 \
                or roles.count("swap") > 1 or roles.count("vol") > 1:
            return unsupported(
                f"the pool kinds {kinds} have no cell-MC mapping (need "
                f"one family with one displacement move, at most one swap "
                f"and one volume move)")
        family = families.pop()
        disp_idx = roles.index("disp")
        swap_idx = roles.index("swap") if "swap" in roles else None
        vol_idx = roles.index("vol") if "vol" in roles else None
        swap_mode = {"lj": "species", "poly": "pair", "hd": None}[family] \
            if swap_idx is not None else None
        proposal = "square" if family == "hd" else "gaussian"
        if swap_idx is not None and (
                self.pool[disp_idx].move.aux != self.pool[swap_idx].move.aux):
            return unsupported(
                "the displacement and swap moves carry different "
                "interaction tables (no shared cell geometry)")
        pressure = None
        if vol_idx is not None:
            vaux = self.pool[vol_idx].move.aux
            if (not isinstance(vaux, tuple) or len(vaux) != 2
                    or vaux[0] != self.pool[disp_idx].move.aux):
                return unsupported(
                    "the volume move carries a different interaction table "
                    "than the displacement move (no shared cell geometry)")
            pressure = float(vaux[1])
        try:
            from ..ops.cell_mc import plan_grid
            state0 = sim.chains0
            box0 = float(state0.box.reshape(-1)[0])
            n_particles = int(state0.pos.shape[-2])
            if family == "lj":
                from ..models.lennard_jones import cell_closures
                pe, rc2, rcut_max = cell_closures(
                    self.pool[disp_idx].move.aux)
            elif family == "poly":
                from ..models.polydisperse import cell_closures
                pe, rc2, rcut_max = cell_closures(
                    self.pool[disp_idx].move.aux)
            else:
                from ..models.hard_disks import cell_closures
                pe, rc2, rcut_max = cell_closures()
            dim = self._pos_dim
            kw = dict(d_cap=float(opts.get("d_cap", 0.45)),
                      cap_slack=float(opts.get("cap_slack", 2.0)), dim=dim,
                      box_margin=float(opts.get(
                          "box_margin", 0.15 if vol_idx is not None else 0.0)))
            plan0 = plan_grid(n_particles, box0, rcut_max, **kw)
            # capacity from the initial configuration's observed maximum
            # per-cell occupancy (a mean multiple under-sizes clustered
            # states), scaled for the compression volume moves may bring
            max_occ = _max_cell_occupancy(state0, plan0.nc, dim)
            if vol_idx is not None:
                max_occ = int(np.ceil(
                    max_occ * (box0 / plan0.box_min) ** dim))
            self._cell_plan = plan_grid(n_particles, box0, rcut_max,
                                        max_occupancy=max_occ, **kw)
            self._cell_model = (pe, rc2, family, swap_mode, disp_idx,
                                swap_idx, vol_idx, pressure, proposal)
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
                and not self._row_kernel_takes())

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
        """True when the fused path runs this pool: one Gaussian
        displacement move of a 1-D particle, one 2-D LJ displacement move,
        the 2-D LJ displacement + swap pool, or the 2-D polydisperse
        displacement + diameter-swap pool (N >= 2); or the cell path
        (:attr:`_use_cell`, any device).  Under ``'auto'`` the
        chains must be on a CUDA device, with a potential the Gaussian kernel
        knows or at most
        :data:`~montecarlo_tpu_torch.ops.lj_sweep.MAX_PARTICLES` particles;
        under ``'interpret'`` any device and any elementwise potential.  Any
        other pool takes the generic path."""
        if self.fused == "off":
            return False
        if self.fused == "cell":
            return self._cell_plan is not None
        return self._use_cell or self._row_kernel_takes()

    def _row_kernel_takes(self) -> bool:
        """True when a sweep kernel (or, under ``'interpret'``, its plain
        version) runs this pool on its device."""
        if self._fused_pool is None:
            return False
        if self.fused == "interpret":
            return True
        if self.device.type != "cuda":
            return False
        if self._fused_pool == "gaussian":
            from ..ops.fused_sweep import kernel_potential
            return kernel_potential(self.pool[0].move.aux) is not None
        from ..ops.lj_sweep import MAX_PARTICLES
        return self._n_particles <= MAX_PARTICLES

    def fused_advance(self, dstate, n_steps: int):
        """Advance all chains ``n_steps * sweepstep`` MH steps in one sweep
        call; counters and cached energies as :meth:`step` keeps them."""
        if self._use_cell:
            return self._cell_advance(dstate, n_steps)
        slc = dstate[self.state_key]
        sys = dstate["sys"]
        params = dstate[self.params_key]
        t0 = dstate["t"]
        total = int(n_steps) * self.sweepstep
        # seeding off the absolute micro-step keeps results invariant to how
        # recorder schedules cut the run into segments
        micro_t0 = t0 * self.sweepstep
        interp = self.fused == "interpret"
        # on a mesh, each sweep's sharded entry point: this rank's chains,
        # the rank folded into the seed
        mesh = () if self.mesh is None else (self.mesh, self.mesh.axis)
        from ..ops import fused_sweep, lj_sweep, poly_sweep
        if self._fused_pool == "gaussian":
            sweep = (fused_sweep.sharded_gaussian_sweep if mesh
                     else fused_sweep.fused_gaussian_sweep)
            sigma = tree_leaves(params[0])[0]
            x, e, acc = sweep(
                *mesh, sys.x, sys.beta, sigma, self.seed, micro_t0, total,
                potential=self.pool[0].move.aux, interpret=interp)
            new_sys = dataclasses.replace(sys, x=x, e=e)
        else:
            kinds = tuple(m.move.kind for m in self.pool)
            disp = kinds.index("poly_displacement_2d"
                               if self._fused_pool == "poly_mixed"
                               else "lj_displacement_2d")
            sigma = tree_leaves(params[disp])[0]
            aux = self.pool[disp].move.aux
            w_disp = float(self.weights[disp] / self.weights.sum())
            kw = dict(params=aux, interpret=interp)
            if self._fused_pool == "poly_mixed":
                sweep = (poly_sweep.sharded_poly_mixed_sweep if mesh
                         else poly_sweep.fused_poly_mixed_sweep)
                pos, diam, energy, acc, tot = sweep(
                    *mesh, sys.pos, sys.diam, sys.beta, sys.energy, self._box,
                    sigma, w_disp, self.seed, micro_t0, total, **kw)
                new_sys = dataclasses.replace(sys, pos=pos, diam=diam,
                                              energy=energy)
            else:
                args = (*mesh, sys.pos, sys.species, sys.beta, sys.energy,
                        self._box, sigma)
                if self._fused_pool == "lj":
                    sweep = (lj_sweep.sharded_lj_sweep if mesh
                             else lj_sweep.fused_lj_sweep)
                    pos, energy, acc = sweep(
                        *args, self.seed, micro_t0, total, **kw)
                    new_sys = dataclasses.replace(sys, pos=pos, energy=energy)
                else:
                    sweep = (lj_sweep.sharded_lj_mixed_sweep if mesh
                             else lj_sweep.fused_lj_mixed_sweep)
                    pos, species, energy, acc, tot = sweep(
                        *args, w_disp, self.seed, micro_t0, total, **kw)
                    new_sys = dataclasses.replace(
                        sys, pos=pos, species=species, energy=energy)
        if self._fused_pool in ("lj_mixed", "poly_mixed"):
            # (M, kind, [accepted, attempted]), kinds in the pool's order
            inc = torch.stack([acc, tot], dim=-1)
            if disp == 1:
                inc = inc.flip(1)
        else:
            inc = torch.stack([acc, torch.full_like(acc, total)],
                              dim=-1)[:, None, :]
        return {**dstate, "sys": new_sys, "t": t0 + int(n_steps),
                self.state_key: {**slc, "counters": slc["counters"] + inc}}

    def _cell_advance(self, dstate, n_steps: int):
        """The checkerboard cell-MC segment for ``n_steps * sweepstep``
        requested moves per chain (``ops/cell_mc.py``)."""
        from ..ops.cell_mc import KeyDraws, cell_mc_segment
        slc = dstate[self.state_key]
        sys = dstate["sys"]
        params = dstate[self.params_key]
        t0 = dstate["t"]
        plan = self._cell_plan
        (pe, rc2, family, swap_mode, disp_idx, swap_idx, vol_idx, pressure,
         proposal) = self._cell_model
        sigma = tree_leaves(params[disp_idx])[0]
        wsum = float(self.weights.sum())
        w = [float(self.weights[i]) / wsum if i is not None else 0.0
             for i in (disp_idx, swap_idx, vol_idx)]
        # a displacement or swap substep delivers ~a_att attempts per chain,
        # a volume substep one; z substeps per requested move, the
        # fractional remainder carried in cell_debt (float32, as the
        # reference computes it) so fine recorder strides do not round
        # every segment up to a whole substep
        a_att = plan.nc ** plan.dim // 2 ** plan.dim
        z = (w[0] + w[1]) / a_att + w[2]
        want = (np.float32(int(n_steps) * self.sweepstep) * np.float32(z)
                + slc["cell_debt"].numpy())
        substeps = int(np.floor(want))
        new_debt = want - np.float32(substeps)
        if vol_idx is not None:
            vol, dlnv = (self._cell_n, pressure), params[vol_idx]["dlnv"]
        else:
            vol, dlnv = None, 0.0
        if family == "lj":
            attr = sys.species.to(torch.float32)
        elif family == "poly":
            attr = sys.diam
        else:                    # hard disks: no attributes, no energy
            attr = torch.zeros(sys.pos.shape[:-1], dtype=torch.float32,
                               device=sys.pos.device)
        m = sys.pos.shape[0]
        beta = getattr(sys, "beta", None)
        energy = getattr(sys, "energy", None)
        if beta is None:
            beta = torch.ones(m, dtype=torch.float32, device=sys.pos.device)
            energy = torch.zeros_like(beta)
        # the global ids of this rank's chains (the mesh's contiguous slice)
        lo = 0 if self.mesh is None else self.mesh.rank * m
        draws = KeyDraws(self.seed, t0 * self.sweepstep,
                         torch.arange(lo, lo + m, device=sys.pos.device))
        pos, attr_out, energy, box, att, acc, ovf = cell_mc_segment(
            plan, pe, rc2, sys.pos, attr, beta, energy, sigma, draws,
            substeps, w_disp=(w[0] / a_att) / z, w_swap=(w[1] / a_att) / z,
            swap_mode=swap_mode, box=sys.box, proposal=proposal, vol=vol,
            dlnv=dlnv, lj_params=(self.pool[disp_idx].move.aux
                                  if family == "lj" else None))
        upd = {"pos": pos}
        if vol_idx is not None:
            upd["box"] = box   # an NVT pool keeps the box as given (0-d too)
        if family == "lj":
            upd.update(species=attr_out.to(sys.species.dtype), energy=energy)
        elif family == "poly":
            upd.update(diam=attr_out, energy=energy)
        new_sys = dataclasses.replace(sys, **upd)
        inc = torch.zeros_like(slc["counters"])
        for col, idx in enumerate((disp_idx, swap_idx, vol_idx)):
            if idx is not None:
                inc[:, idx] = torch.stack([acc[:, col], att[:, col]], dim=-1)
        out_slc = {**slc, "counters": slc["counters"] + inc,
                   "cell_debt": torch.tensor(new_debt, dtype=torch.float32),
                   "cell_overflow": slc["cell_overflow"] | torch.any(ovf)}
        return {**dstate, "sys": new_sys, "t": t0 + int(n_steps),
                self.state_key: out_slc}

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
