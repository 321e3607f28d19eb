"""Transverse-field Ising model — path-integral (quantum) Monte Carlo.

Port of ``montecarlo_tpu/models/tfim.py``.  The 1-D transverse-field Ising
chain

    H = -J sum_i sigma^z_i sigma^z_{i+1} - h sum_i sigma^x_i     (periodic)

at inverse temperature beta maps, by the Suzuki-Trotter decomposition with
``M`` imaginary-time slices, onto a classical anisotropic Ising model on an
(N, M) space-time torus with couplings

    K_x   = (beta/M) J                     (spatial, within a slice)
    K_tau = -1/2 ln tanh((beta/M) h)       (temporal, between slices)

and weight ``exp(sum K_x s s + sum K_tau s s)``.  Sampling it gives quantum
thermal expectations up to O((beta/M)^2) Trotter error: equal-time
``<sigma^z_i sigma^z_j>`` from same-slice correlations, ``<sigma^x>`` from
temporal-bond statistics.

The sampler is a whole-lattice checkerboard sweep over the (i+m)-parity
2-colouring of the space-time torus, all chains' (M_chains, N, M) int8
spins at once; its half-sweep (:func:`_half_sweep`) takes its uniforms as a
tensor.  Exact-diagonalization ground truth for small N:
:func:`ed_observables`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.algorithms import SimView, _n_calls
from ..core.system import SystemDef
from ..utils import prng
from ..utils.device import resolve_device
from .ising import random_spins
from .ising2d import LatticeSampler, parity_mask

__all__ = [
    "TFIMState",
    "couplings",
    "make_system",
    "init_chains",
    "TFIMCheckerboard",
    "callback_sz2",
    "callback_szsz",
    "make_sx_callback",
    "ed_observables",
]

TINY = float(np.finfo(np.float32).tiny)


@dataclasses.dataclass(frozen=True)
class TFIMState:
    """Chain-batched space-time configurations."""
    spins: torch.Tensor   # (M_chains, N, M) int8 in {-1, +1}; space, time
    kx: torch.Tensor      # (M_chains,) spatial coupling  (beta J / M)
    ktau: torch.Tensor    # (M_chains,) temporal coupling
    energy: torch.Tensor  # (M_chains,) cached classical action (-log weight)


def couplings(beta: float, j: float, h: float, m_slices: int):
    """(K_x, K_tau) of the Suzuki-Trotter classical lattice, in float64."""
    dtau = beta / m_slices
    if not (h > 0):
        raise ValueError("transverse field h must be positive (K_tau "
                         "diverges at h=0; use the classical Ising model)")
    kx = dtau * j
    ktau = -0.5 * np.log(np.tanh(dtau * h))
    return float(kx), float(ktau)


def _action_energy(spins, kx, ktau):
    """E_cl = -sum(K_x s s_x+1) - sum(K_tau s s_tau+1) (periodic), per
    chain."""
    s = spins.to(torch.float32)
    return -(kx * torch.sum(s * torch.roll(s, 1, 1), dim=(1, 2))
             + ktau * torch.sum(s * torch.roll(s, 1, 2), dim=(1, 2)))


def make_system() -> SystemDef:
    def log_target(state: TFIMState):
        return -state.energy           # beta_cl = 1, couplings carry beta

    def frame(state: TFIMState):
        return torch.mean(state.spins.to(torch.float32), dim=(1, 2))

    def format_frame(t, mz):
        return f"{t} {float(mz)!r}"

    return SystemDef(name="TransverseFieldIsing1D", log_target=log_target,
                     frame=frame, format_frame=format_frame)


def init_chains(n_chains: int, n_sites: int, m_slices: int, beta: float,
                j: float = 1.0, h: float = 1.0, seed: int = 42,
                device=None) -> TFIMState:
    """Random space-time spins from ``key(seed)`` as the reference draws
    them (the same seed gives its chains), made on ``device``, the card
    (``cuda``) when it is None.  Needs even ``n_sites`` and
    ``m_slices``."""
    if m_slices % 2 or n_sites % 2:
        raise ValueError("need even n_sites and m_slices (periodic "
                         "checkerboard 2-colouring)")
    kx, ktau = couplings(beta, j, h, m_slices)
    device = resolve_device(device)
    spins = random_spins((n_chains, n_sites, m_slices), seed, device)
    full = lambda v: torch.full((n_chains,), v, dtype=torch.float32,
                                device=device)
    kx_, ktau_ = full(kx), full(ktau)
    return TFIMState(spins=spins, kx=kx_, ktau=ktau_,
                     energy=_action_energy(spins, kx_, ktau_))


def _half_sweep(state: TFIMState, parity: int, u):
    """Metropolis-update every site of one (i+m)-parity sublattice at once,
    with the (M_chains, N, M) uniforms ``u`` in (0, 1) (from the smallest
    normal float32 up, so ``log u`` is finite).  Returns
    ``(new_state, n_accepted)``."""
    sp = state.spins
    s = sp.to(torch.float32)
    kx = state.kx[:, None, None]
    ktau = state.ktau[:, None, None]
    nbr = (kx * (torch.roll(s, 1, 1) + torch.roll(s, -1, 1))
           + ktau * (torch.roll(s, 1, 2) + torch.roll(s, -1, 2)))
    d_logp = -2.0 * s * nbr                      # flip: dlog pi per site
    mask = parity_mask(sp.shape[1], sp.shape[2], parity, sp.device)
    accept = mask & (torch.log(u) < d_logp)
    spins = torch.where(accept, -sp, sp)
    energy = state.energy - torch.sum(torch.where(accept, d_logp, 0.0),
                                      dim=(1, 2))
    return (dataclasses.replace(state, spins=spins, energy=energy),
            torch.sum(accept, dim=(1, 2), dtype=torch.int32))


def checkerboard_sweep(state: TFIMState, u0, u1):
    """One full sweep of the space-time lattice, the even then the odd
    half-sweep, with their uniforms ``u0`` and ``u1``."""
    state, a0 = _half_sweep(state, 0, u0)
    state, a1 = _half_sweep(state, 1, u1)
    return state, a0 + a1


class TFIMCheckerboard(LatticeSampler):
    """Whole-space-time-lattice checkerboard sweeps, ``sweeps`` a step.
    Device state: ``keys`` (from ``fold_in(key(seed), 0x7F1)``, the
    reference's tag, so the stream is not the one ``init_chains`` drew the
    spins from with the same seed) and ``counters[chain, 0] = (accepted,
    attempted)``."""

    state_key = "tfim_cb"
    stream_tag = 0x7F1

    def __init__(self, sim, sweeps: int = 1, seed: int = 1, dependencies=(),
                 **_):
        super().__init__(sim, seed)
        self.sweeps = int(sweeps)

    def step(self, dstate, t):
        slc = dstate[self.state_key]
        sys, acc = dstate["sys"], None
        keys = self.unit_keys(slc, t, self.sweeps)
        shape = tuple(sys.spins.shape[1:])
        for s in range(self.sweeps):
            # k0, k1 = split(key): uniforms in [tiny, 1), so log u is finite
            u = prng.uniform(prng.split(keys[:, s]), shape, minval=TINY)
            sys, a = checkerboard_sweep(sys, u[:, 0], u[:, 1])
            acc = a if acc is None else acc + a
        attempts = self.sweeps * int(np.prod(self.lattice_shape))
        return self.count(dstate, sys, acc, attempts)

    def write_summary(self, io, scheduler):
        io.write("\tTFIMCheckerboard\n")
        io.write(f"\t\tCalls: {_n_calls(scheduler)}\n")
        io.write(f"\t\tLattice sweeps per simulation step: {self.sweeps}\n")
        io.write(f"\t\tSpace-time lattice: {self.lattice_shape}\n")
        io.write(f"\t\tSeed: {self.seed}\n")


# -- quantum observables ----------------------------------------------------

def callback_sz2(view: SimView):
    """<(M_z/N)^2>: the same-slice squared magnetization, averaged over
    slices and chains."""
    s = view.sys.spins.to(torch.float32)       # (chains, N, M)
    mz = torch.mean(s, dim=1)                  # per-slice magnetization
    return torch.mean(mz * mz)


def callback_szsz(view: SimView):
    """Nearest-neighbour equal-time correlation <sigma^z_i sigma^z_{i+1}>."""
    s = view.sys.spins.to(torch.float32)
    return torch.mean(s * torch.roll(s, 1, 1))


def make_sx_callback(beta: float, h: float, m_slices: int):
    """<sigma^x> from temporal-bond statistics: each time bond contributes
    tanh(dtau h) if its spins are equal, else coth(dtau h)."""
    dtau = beta / m_slices
    t_eq = float(np.tanh(dtau * h))
    t_ne = float(1.0 / np.tanh(dtau * h))

    def callback_sx(view: SimView):
        s = view.sys.spins.to(torch.float32)
        same = s * torch.roll(s, 1, 2)         # +1 equal, -1 flipped
        return torch.mean(torch.where(same > 0, t_eq, t_ne))

    return callback_sx


# -- exact diagonalization ground truth (small N) ---------------------------

def ed_observables(n_sites: int, beta: float, j: float, h: float):
    """Thermal <sigma^x>, <sigma^z_i sigma^z_{i+1}>, <(M_z/N)^2> by exact
    diagonalization (dense 2^N: keep N <= 12)."""
    dim = 2 ** n_sites
    sz = np.array([[1.0, 0.0], [0.0, -1.0]])
    sx = np.array([[0.0, 1.0], [1.0, 0.0]])

    def site_op(op, i):
        out = np.eye(1)
        for k in range(n_sites):
            out = np.kron(out, op if k == i else np.eye(2))
        return out

    ham = np.zeros((dim, dim))
    for i in range(n_sites):
        ham -= j * site_op(sz, i) @ site_op(sz, (i + 1) % n_sites)
        ham -= h * site_op(sx, i)
    w, v = np.linalg.eigh(ham)
    w -= w.min()
    boltz = np.exp(-beta * w)
    z = boltz.sum()

    def expval(op):
        return float(np.einsum("ij,ji->", (v * boltz) @ v.T, op) / z)

    ex_sx = np.mean([expval(site_op(sx, i)) for i in range(n_sites)])
    ex_zz = np.mean([expval(site_op(sz, i) @ site_op(sz, (i + 1) % n_sites))
                     for i in range(n_sites)])
    mz = sum(site_op(sz, i) for i in range(n_sites)) / n_sites
    ex_mz2 = expval(mz @ mz)
    return {"sx": float(ex_sx), "szsz": float(ex_zz), "mz2": float(ex_mz2)}
