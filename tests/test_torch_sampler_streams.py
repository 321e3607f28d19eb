"""Every sampler of the port against the JAX package's, from one seed.

Both packages build the same script from the same seed, with no chains,
slices or draws carried across (no ``interop``), and run it through
``Simulation`` on the CPU:

- each lattice model's ``init_chains`` (the reference draws the whole
  ``(M, L, L)`` shape from ``key(seed)``);
- the checkerboard, Wolff and Swendsen-Wang drivers of the 2-D Ising and
  Potts models, the XY, Heisenberg and TFIM checkerboards, Wang-Landau on
  ``ising2d.wl_model``, event-chain MC on each of the four hooks (the 1-D
  zig-zag, hard disks, LJ and polydisperse), replica exchange over the
  generic path, a cell-path segment of the 2-D LJ displacement + swap
  pool (``fused='cell'``) and an NPT cell-path run of the polydisperse
  displacement + swap + volume pool.

Gates: counters equal; discrete spins equal; continuous states within
1e-5, energies and ECMC statistics within rtol 1e-5 (float32 sums of a
few dozen terms in each package's own order).  The packages agree to the
float32 ulps of XLA's and torch's transcendentals (``log``, ``cos``,
``atan2``, the normals' ``log1p``), so an accept test whose two sides tie
to an ulp would flip and send one chain its own way; the seeds and depths
here are ones where none does, which is what these pin.  The XY and
Heisenberg runs leave over-relaxation out: its reflections carry the
ulps of ``atan2`` and of the local field into every later accept test,
and within a few sweeps one flips.
"""

import types

import numpy as np
import pytest
import torch

import montecarlo_tpu as mc
import montecarlo_tpu_torch as tmc
from montecarlo_tpu.models import hard_disks as ref_hd
from montecarlo_tpu.models import heisenberg as ref_heis
from montecarlo_tpu.models import ising as ref_ising
from montecarlo_tpu.models import ising2d as ref_i2
from montecarlo_tpu.models import lennard_jones as ref_lj
from montecarlo_tpu.models import particle1d as ref_p1d
from montecarlo_tpu.models import polydisperse as ref_poly
from montecarlo_tpu.models import potts as ref_potts
from montecarlo_tpu.models import tfim as ref_tfim
from montecarlo_tpu.models import xy as ref_xy
from montecarlo_tpu_torch.models import hard_disks as hd
from montecarlo_tpu_torch.models import heisenberg as heis
from montecarlo_tpu_torch.models import ising
from montecarlo_tpu_torch.models import ising2d
from montecarlo_tpu_torch.models import lennard_jones as lj
from montecarlo_tpu_torch.models import particle1d as p1d
from montecarlo_tpu_torch.models import polydisperse as poly
from montecarlo_tpu_torch.models import potts
from montecarlo_tpu_torch.models import tfim
from montecarlo_tpu_torch.models import xy
from torch_lattice_helpers import warm_up_transcendentals

warm_up_transcendentals()

ATOL, RTOL = 1e-5, 1e-5

REF = types.SimpleNamespace(
    pkg=mc, kw={}, ising=ref_ising, ising2d=ref_i2, potts=ref_potts,
    xy=ref_xy, heis=ref_heis, tfim=ref_tfim, p1d=ref_p1d, hd=ref_hd,
    lj=ref_lj, poly=ref_poly)
PORT = types.SimpleNamespace(
    pkg=tmc, kw={"device": "cpu"}, ising=ising, ising2d=ising2d,
    potts=potts, xy=xy, heis=heis, tfim=tfim, p1d=p1d, hd=hd, lj=lj,
    poly=poly)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test runner runs several files at once, and
    the plain threefry version's small ops slow down when threads
    contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, rtol=0.0, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def _both(build, steps, tmp_path):
    """The final device states of ``build(ns)``'s (system, chains,
    algorithms) run for ``steps`` steps in the reference (``ns`` REF) and
    in the port (``ns`` PORT)."""
    out = []
    for name, ns in (("ref", REF), ("port", PORT)):
        system, chains, algos = build(ns)
        sim = ns.pkg.Simulation(system, chains, algos, steps,
                                path=str(tmp_path / name))
        sim.run()
        out.append(sim.device_state)
    return out


def _same_fields(ref_sys, sys, exact=(), close=(), energies=("energy",)):
    for f in exact:
        np.testing.assert_array_equal(_np(getattr(sys, f)),
                                      _np(getattr(ref_sys, f)), err_msg=f)
    for f in close:
        _close(getattr(sys, f), getattr(ref_sys, f))
    for f in energies:
        _close(getattr(sys, f), getattr(ref_sys, f), rtol=RTOL)


def _same_counters(ref_ds, ds, key):
    np.testing.assert_array_equal(_np(ds[key]["counters"]),
                                  _np(ref_ds[key]["counters"]))


# -- lattice init_chains ----------------------------------------------------------

INITS = {
    "ising": (lambda ns: ns.ising.init_chains(5, 12, 0.5, seed=7, **ns.kw),
              ("spins",), ()),
    "ising2d": (lambda ns: ns.ising2d.init_chains(5, 6, 0.5, seed=7,
                                                  **ns.kw), ("spins",), ()),
    "potts": (lambda ns: ns.potts.init_chains(5, 6, 3, 0.5, seed=7,
                                              **ns.kw), ("spins",), ()),
    "xy": (lambda ns: ns.xy.init_chains(5, 6, 0.5, seed=7, **ns.kw), (),
           ("theta",)),
    # normals within a few ulps (utils/prng.py), so the unit spins too
    "heisenberg": (lambda ns: ns.heis.init_chains(5, 6, 0.5, seed=7,
                                                  **ns.kw), (), ("spins",)),
    "tfim": (lambda ns: ns.tfim.init_chains(5, 4, 8, 2.0, seed=7, **ns.kw),
             ("spins",), ()),
}


@pytest.mark.parametrize("name", sorted(INITS))
def test_lattice_init_chains_equal_reference(name):
    make, exact, close = INITS[name]
    ref, got = make(REF), make(PORT)
    _same_fields(ref, got, exact, close)
    for f in exact:
        assert _np(getattr(got, f)).dtype == _np(getattr(ref, f)).dtype


# -- lattice drivers --------------------------------------------------------------

def _i2(cls, size, **kw):
    return lambda ns: (ns.ising2d.make_system(),
                       ns.ising2d.init_chains(4, size, 0.44, seed=3,
                                              **ns.kw),
                       [dict(algorithm=getattr(ns.ising2d, cls), seed=5,
                             **kw)])


def _potts(factory, q, size, **kw):
    return lambda ns: (ns.potts.make_system(q),
                       ns.potts.init_chains(4, size, q, 0.9, seed=3,
                                            **ns.kw),
                       [dict(algorithm=getattr(ns.potts, factory)(q),
                             seed=5, **kw)])


DRIVERS = {
    # one sweep a step sweeps with the step's key, two split it
    "ising2d_checkerboard": (_i2("CheckerboardMetropolis", 6, sweeps=1),
                             "checkerboard", "spins", None),
    "ising2d_checkerboard_2sweeps": (
        _i2("CheckerboardMetropolis", 6, sweeps=2), "checkerboard", "spins",
        None),
    "ising2d_wolff": (_i2("WolffCluster", 5, clusters=2), "wolff", "spins",
                      None),
    "ising2d_swendsen_wang": (_i2("SwendsenWang", 5, sweeps=2),
                              "swendsen_wang", "spins", None),
    "potts_checkerboard": (_potts("CheckerboardPotts", 3, 6, sweeps=1),
                           "checkerboard_potts", "spins", None),
    "potts_wolff": (_potts("WolffPotts", 3, 5, clusters=2), "wolff",
                    "spins", None),
    "potts_swendsen_wang": (_potts("SwendsenWangPotts", 4, 5, sweeps=2),
                            "swendsen_wang", "spins", None),
    "xy_checkerboard": (
        lambda ns: (ns.xy.make_system(),
                    ns.xy.init_chains(4, 6, 1.0, seed=3, **ns.kw),
                    [dict(algorithm=ns.xy.CheckerboardXY, sweeps=2,
                          delta=1.2, seed=5)]),
        "checkerboard_xy", None, "theta"),
    "heisenberg_checkerboard": (
        lambda ns: (ns.heis.make_system(),
                    ns.heis.init_chains(4, 6, 1.0, seed=3, **ns.kw),
                    [dict(algorithm=ns.heis.CheckerboardHeisenberg,
                          sweeps=2, delta=0.8, seed=5)]),
        "checkerboard_heisenberg", None, "spins"),
    "tfim_checkerboard": (
        lambda ns: (ns.tfim.make_system(),
                    ns.tfim.init_chains(4, 4, 8, 2.0, seed=3, **ns.kw),
                    [dict(algorithm=ns.tfim.TFIMCheckerboard, sweeps=2,
                          seed=5)]),
        "tfim_cb", "spins", None),
}


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_lattice_driver_equals_reference(name, tmp_path):
    build, key, exact, close = DRIVERS[name]
    ref_ds, ds = _both(build, 5, tmp_path)
    _same_counters(ref_ds, ds, key)
    assert int(_np(ds[key]["counters"])[..., 0].sum()) > 0
    _same_fields(ref_ds["sys"], ds["sys"], [exact] if exact else (),
                 [close] if close else ())


# -- Wang-Landau ------------------------------------------------------------------

def _wang_landau(ns):
    size, steps = 4, 24
    return (ns.ising2d.make_system(),
            ns.ising2d.init_chains(8, size, 1.0, seed=3, **ns.kw),
            [dict(algorithm=ns.pkg.WangLandau,
                  model=ns.ising2d.wl_model(size), moves_per_step=16,
                  seed=9),
             dict(algorithm=ns.pkg.WangLandauRefine, flatness=0.5,
                  log_f_min=1e-4, dependencies=(ns.pkg.WangLandau,),
                  scheduler=np.arange(8, steps + 1, 8))])


def test_wang_landau_equals_reference(tmp_path):
    """Walkers' spins, energies, ``log g``, histograms and ``log f`` after
    24 steps of 16 proposals and three refinements: ``log g`` sums
    ``log f`` in float32 in the same order in both, so it is equal."""
    ref_ds, ds = _both(_wang_landau, 24, tmp_path)
    _same_fields(ref_ds["sys"], ds["sys"], ("spins", "energy"), (), ())
    for k in ("log_g", "hist", "visited", "log_f"):
        np.testing.assert_array_equal(_np(ds["wang_landau"][k]),
                                      _np(ref_ds["wang_landau"][k]),
                                      err_msg=k)
    assert float(_np(ds["wang_landau"]["log_f"]).min()) < 1.0


# -- event-chain MC ---------------------------------------------------------------

ECMC = {
    "zigzag": (lambda ns: ns.p1d.make_system(ns.p1d.harmonic),
               lambda ns: ns.p1d.init_chains(16, beta=2.0, seed=3, **ns.kw),
               lambda ns: ns.p1d.zigzag_model(), "x"),
    "hard_disks": (lambda ns: ns.hd.make_system(),
                   lambda ns: ns.hd.init_chains(3, 30, 0.5, seed=42,
                                                **ns.kw),
                   lambda ns: ns.hd.ecmc_model(1.0,
                                               max_events_per_chain=512),
                   "pos"),
    "lennard_jones": (lambda ns: ns.lj.make_system(),
                      lambda ns: ns.lj.init_chains(3, 20, 0.7, 1.0,
                                                   frac_b=0.2, seed=5,
                                                   **ns.kw),
                      lambda ns: ns.lj.ecmc_model(1.5), "pos"),
    "polydisperse": (lambda ns: ns.poly.make_system(),
                     lambda ns: ns.poly.init_chains(3, 25, 0.9, 2.0, seed=2,
                                                    **ns.kw),
                     lambda ns: ns.poly.ecmc_model(1.0), "pos"),
}


@pytest.mark.parametrize("name", sorted(ECMC))
def test_ecmc_equals_reference(name, tmp_path):
    """Five steps of two events: positions within 1e-5, the statistics
    (integer ones equal) within rtol 1e-5, the event counts equal."""
    system, init, model, field = ECMC[name]
    ref_ds, ds = _both(lambda ns: (system(ns), init(ns), [
        dict(algorithm=ns.pkg.EventChain, model=model(ns),
             events_per_step=2, seed=11)]), 5, tmp_path)
    _close(getattr(ds["sys"], field), getattr(ref_ds["sys"], field))
    stats, ref_stats = ds["ecmc"]["stats"], ref_ds["ecmc"]["stats"]
    assert sorted(stats) == sorted(ref_stats)
    for k in stats:
        if stats[k].is_floating_point():
            _close(stats[k], ref_stats[k], rtol=RTOL)
        else:
            np.testing.assert_array_equal(_np(stats[k]), _np(ref_stats[k]),
                                          err_msg=k)
    np.testing.assert_array_equal(_np(ds["ecmc"]["n_events"]),
                                  _np(ref_ds["ecmc"]["n_events"]))
    assert float(_np(stats["t"]).min()) > 0


# -- replica exchange -------------------------------------------------------------

def _tempering(ns):
    betas = [0.5, 1.0, 2.0, 4.0]
    return (ns.p1d.make_system(ns.p1d.harmonic),
            ns.p1d.init_chains(16, beta=ns.pkg.tile_ladder(betas, 4,
                                                           **ns.kw),
                               seed=3, **ns.kw),
            [dict(algorithm=ns.pkg.Metropolis,
                  pool=(ns.p1d.displacement_move(0.8),), seed=2,
                  fused="off"),
             dict(algorithm=ns.pkg.ReplicaExchange, n_temps=4, seed=5,
                  scheduler=np.arange(2, 41, 2))])


def test_replica_exchange_equals_reference(tmp_path):
    """40 generic-path steps with a swap every second one (each call keyed
    on its step): the swap counters and the chains' moves equal, the
    configurations within 1e-5."""
    ref_ds, ds = _both(_tempering, 40, tmp_path)
    np.testing.assert_array_equal(
        _np(ds["replica_exchange"]["counters"]),
        _np(ref_ds["replica_exchange"]["counters"]))
    assert int(_np(ds["replica_exchange"]["counters"])[:, 0].sum()) > 0
    _same_counters(ref_ds, ds, "metropolis")
    _same_fields(ref_ds["sys"], ds["sys"], ("beta",), ("x",), ("e",))


# -- the cell path ----------------------------------------------------------------

def _cell_lj(ns):
    pool = (ns.lj.lj_displacement_move(0.1, weight=0.8),
            ns.lj.lj_swap_move(weight=0.2))
    return (ns.lj.make_system(),
            ns.lj.init_chains(4, 256, rho=1.0, beta=1.0, frac_b=0.2, seed=6,
                              **ns.kw),
            [dict(algorithm=ns.pkg.Metropolis, pool=pool, seed=3,
                  sweepstep=64, fused="cell")])


def _cell_npt(ns):
    pool = (ns.poly.displacement_move(0.08, weight=0.75),
            ns.poly.swap_move(weight=0.2),
            ns.poly.volume_move(0.002, 4.0, weight=0.05))
    return (ns.poly.make_system(),
            ns.poly.init_chains(2, 512, rho=0.6, beta=1.0 / 0.4, seed=21,
                                **ns.kw),
            [dict(algorithm=ns.pkg.Metropolis, pool=pool, seed=4,
                  sweepstep=64, fused="cell")])


CELL = {"lj_species_swap": (_cell_lj, 6, "species"),
        "poly_npt": (_cell_npt, 4, "diam")}


@pytest.mark.parametrize("name", sorted(CELL))
def test_cell_path_equals_reference(name, tmp_path):
    """Steps of the cell path (one segment a step, each keyed on its
    micro-step): the counters of every move kind equal, positions and
    boxes within 1e-5, the attributes (species equal, diameters within
    1e-5) and the cached energies within rtol 1e-5."""
    build, steps, attr = CELL[name]
    ref_ds, ds = _both(build, steps, tmp_path)
    _same_counters(ref_ds, ds, "metropolis")
    cnt = _np(ds["metropolis"]["counters"])
    assert np.all(cnt[:, :, 1] > 0) and np.all(cnt[:, 0, 0] > 0)
    exact = ("species",) if attr == "species" else ()
    close = ("pos", "box") + (("diam",) if attr == "diam" else ())
    _same_fields(ref_ds["sys"], ds["sys"], exact, close)
    assert not bool(ds["metropolis"]["cell_overflow"])
