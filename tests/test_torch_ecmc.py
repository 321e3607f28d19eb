"""Event-chain MC in the port (``core/ecmc.py`` and the models'
``ecmc_model`` hooks) against the JAX package's.

Value for value: one ``event_step`` of each hook (hard disks in 2-D and
3-D, LJ in 2-D and 3-D, polydisperse, the zig-zag) on the same chains with
the reference's own threefry draws fed in (``tests/torch_ecmc_helpers.py``):
positions and float statistics within atol 1e-5, counts equal.  The
seeds, sizes and densities are pinned where no event picks another partner
at a float32 ulp (the LJ hook's ``y ** (-1/6)`` and the poly hook's
bisection compare energies computed in float32, whose transcendentals
differ from XLA's in ulps; a rare event can flip, as on the Gaussian
sweep).  The batched loop's result does not depend on its check interval.
A cut-and-resumed run equals the uncut one bit for bit; the ``ecmc`` slice
is carried both ways by ``interop``.

Mirrored gates of ``tests/test_ecmc.py``, each in its band, cut where
named: the 3-D hard-sphere run takes 40 + 40 steps, not 80 + 80.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlo_tpu_torch as tmc
from montecarlo_tpu.core.ecmc import EventChain as RefEventChain
from montecarlo_tpu.models import hard_disks as ref_hd
from montecarlo_tpu.models import lennard_jones as ref_lj
from montecarlo_tpu.models import particle1d as ref_p1d
from montecarlo_tpu.models import polydisperse as ref_poly
from montecarlo_tpu_torch import checkpoint, interop
from montecarlo_tpu_torch.core.ecmc import KeyEventDraws
from montecarlo_tpu_torch.models import hard_disks as hd
from montecarlo_tpu_torch.models import lennard_jones as lj
from montecarlo_tpu_torch.models import particle1d as p1d
from montecarlo_tpu_torch.models import polydisperse as poly
from montecarlo_tpu_torch.utils import prng
from torch_cell_helpers import assert_same_state
from torch_ecmc_helpers import ReferenceEventDraws, chain_keys

BETA = 2.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test runner runs several files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(state):
    return {f: np.asarray(getattr(state, f))
            for f in state.__dataclass_fields__}


def _case(name):
    """(reference chains, the port's chains, reference model, port model,
    the hook's split arity)."""
    if name.startswith("hd"):
        dim = int(name[2])
        ref = ref_hd.init_chains(12, 30 if dim == 2 else 27,
                                 0.5 if dim == 2 else 0.3, seed=3, dim=dim)
        ell = float(ref.box[0]) / 2
        return (ref, interop.chains_from_reference(_np(ref), device="cpu"),
                ref_hd.ecmc_model(ell, max_events_per_chain=512),
                hd.ecmc_model(ell, max_events_per_chain=512), 2)
    if name.startswith("lj"):
        dim = int(name[2])
        ref = ref_lj.init_chains(12, 64, rho=0.6 if dim == 2 else 0.3,
                                 beta=1.0, frac_b=0.2, seed=1, dim=dim)
        return (ref, interop.chains_from_reference(_np(ref), device="cpu"),
                ref_lj.ecmc_model(1.5), lj.ecmc_model(1.5), 3)
    ref = ref_poly.init_chains(12, 64, rho=1.0, beta=2.0, seed=1)
    return (ref, interop.chains_from_reference(_np(ref), device="cpu"),
            ref_poly.ecmc_model(1.0), poly.ecmc_model(1.0), 3)


@pytest.mark.parametrize("name", ["hd2", "hd3", "lj2", "lj3", "poly"])
def test_event_step_value_for_value(name):
    ref, st, ref_model, model, n_split = _case(name)
    keys = chain_keys(3, ref.pos.shape[0])
    want_st, _, want = jax.vmap(ref_model.event_step)(ref, {}, keys)
    got_st, lift, got = model.event_step(st, {},
                                         ReferenceEventDraws(keys, n_split))
    assert lift == {}
    np.testing.assert_allclose(got_st.pos.numpy(), np.asarray(want_st.pos),
                               rtol=0, atol=1e-5)
    assert set(got) == set(want)
    for k in ("chains", "collisions", "cap_hits"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k in ("t", "excess"):
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5)
    assert int(got["collisions"].sum()) > 0 and int(got["cap_hits"].sum()) == 0


def test_zigzag_event_step_value_for_value():
    ref = ref_p1d.init_chains(64, beta=BETA, seed=9)
    st = interop.chains_from_reference(_np(ref), device="cpu")
    ref_model, model = ref_p1d.zigzag_model(), p1d.zigzag_model()
    keys = chain_keys(4, 64)
    want_lift = jax.vmap(ref_model.init_lift)(ref, keys)
    lift = model.init_lift(st, ReferenceEventDraws(keys))
    np.testing.assert_array_equal(lift["v"].numpy(),
                                  np.asarray(want_lift["v"]))
    want_st, want_lift2, want = jax.vmap(ref_model.event_step)(
        ref, want_lift, keys)
    got_st, lift2, got = model.event_step(st, lift, ReferenceEventDraws(keys))
    np.testing.assert_array_equal(lift2["v"].numpy(),
                                  np.asarray(want_lift2["v"]))
    np.testing.assert_allclose(got_st.x.numpy(), np.asarray(want_st.x),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_st.e.numpy(), np.asarray(want_st.e),
                               rtol=0, atol=1e-5)
    for k in ("t", "sx", "sx2", "sx4"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["hd2", "lj2", "poly"])
def test_loop_result_does_not_depend_on_the_check_interval(name):
    _, st, _, _, _ = _case(name)
    models = {"hd2": lambda k: hd.ecmc_model(float(st.box[0]) / 2,
                                             max_events_per_chain=512,
                                             check_every=k),
              "lj2": lambda k: lj.ecmc_model(1.5, check_every=k),
              "poly": lambda k: poly.ecmc_model(1.0, check_every=k)}[name]
    outs = []
    for k in (1, 5, 32):
        draws = KeyEventDraws(prng.split(prng.key(77, "cpu"),
                                         st.pos.shape[0]))
        outs.append(models(k).event_step(st, {}, draws))
    for other in outs[1:]:
        assert_same_state(outs[0][0], other[0])
        assert_same_state(outs[0][2], other[2])
    # a chain capped early stays where the cap left it at every interval
    capped = []
    for k in (1, 3):
        draws = KeyEventDraws(prng.split(prng.key(77, "cpu"),
                                         st.pos.shape[0]))
        model = hd.ecmc_model(float(st.box[0]) / 2, max_events_per_chain=2,
                              check_every=k)
        capped.append(model.event_step(
            interop.chains_from_reference(
                {"pos": st.pos.numpy(), "box": st.box.numpy()},
                device="cpu"), {}, draws))
    assert_same_state(capped[0], capped[1])
    assert int(capped[0][2]["cap_hits"].sum()) > 0


# -- mirrored gates: tests/test_ecmc.py ---------------------------------------------

def _run_zigzag(path, n_chains=256, steps=40, events_per_step=64):
    chains = p1d.init_chains(n_chains, beta=BETA, seed=9, device="cpu")
    sim = tmc.Simulation(
        p1d.make_system(p1d.harmonic), chains,
        [dict(algorithm=tmc.EventChain, model=p1d.zigzag_model(),
              events_per_step=events_per_step, seed=5),
         dict(algorithm=tmc.StoreCallbacks,
              callbacks=tmc.ecmc_callbacks(),
              scheduler=np.arange(1, steps + 1))],
        steps, path=str(path))
    sim.run()
    return sim


def test_zigzag_time_averaged_moments(tmp_path):
    """E[x] = 0, E[x^2] = 1/(2 beta), E[x^4] = 3 (1/(2 beta))^2 as time
    averages along the zig-zag trajectory."""
    sim = _run_zigzag(tmp_path)
    st = sim.device_state["ecmc"]["stats"]
    tot = lambda k: float(st[k].double().sum())
    t = tot("t")
    var = 1.0 / (2.0 * BETA)
    assert abs(tot("sx") / t) < 0.01
    np.testing.assert_allclose(tot("sx2") / t, var, rtol=0.03)
    np.testing.assert_allclose(tot("sx4") / t, 3.0 * var * var, rtol=0.08)


def test_zigzag_is_rejection_free_and_counts_events(tmp_path):
    sim = _run_zigzag(tmp_path, n_chains=8, steps=5, events_per_step=16)
    slc = sim.device_state["ecmc"]
    assert (slc["n_events"] == 5 * 16).all()
    assert slc["n_events"].dtype == torch.int32
    assert (slc["stats"]["t"] > 0).all()
    xs = sim.device_state["sys"].x
    np.testing.assert_allclose(sim.device_state["sys"].e.numpy(),
                               (xs * xs).numpy(), rtol=1e-5)
    ev = np.loadtxt(tmp_path / "ecmc_events.dat")
    np.testing.assert_array_equal(ev[:, 1], 16 * np.arange(6))
    summary = (tmp_path / "summary.log").read_text()
    assert "EventChain" in summary and "ZigZagHarmonic1D" in summary


def _run_hard_disks(path, n_chains, n_disks, eta, steps, events_per_step,
                    chain_length, seed=11, start=None, dim=2,
                    max_events=256):
    chains = start if start is not None else hd.init_chains(
        n_chains, n_disks, eta, seed=3, device="cpu", dim=dim)
    sim = tmc.Simulation(
        hd.make_system(), chains,
        [dict(algorithm=tmc.EventChain,
              model=hd.ecmc_model(chain_length,
                                  max_events_per_chain=max_events),
              events_per_step=events_per_step, seed=seed)],
        steps, path=str(path))
    sim.run()
    return sim


def test_hard_disks_ecmc_invariant_and_lifting(tmp_path):
    sim = _run_hard_disks(tmp_path, 32, 12, 0.25, steps=30,
                          events_per_step=8, chain_length=2.0)
    sys = sim.device_state["sys"]
    assert bool(hd.overlap_free(sys).all()), "ECMC produced overlapping disks"
    st = sim.device_state["ecmc"]["stats"]
    n_chains_run = int(st["chains"].sum())
    assert n_chains_run == 32 * 30 * 8
    assert int(st["cap_hits"].sum()) == 0
    np.testing.assert_allclose(st["t"].numpy(), 2.0 * 30 * 8, rtol=1e-5)
    assert int(st["collisions"].sum()) > n_chains_run * 0.3
    chains0 = hd.init_chains(32, 12, 0.25, seed=3, device="cpu")
    assert not np.allclose(sys.pos.numpy(), chains0.pos.numpy())


def test_hard_disks_ecmc_matches_metropolis(tmp_path):
    n_chains, n_disks, eta = 96, 12, 0.25
    sim_e = _run_hard_disks(tmp_path / "e", n_chains, n_disks, eta, steps=40,
                            events_per_step=8, chain_length=2.0)
    d_ecmc = float(hd.min_pair_distance(sim_e.device_state["sys"]).mean())
    chains = hd.init_chains(n_chains, n_disks, eta, seed=3, device="cpu")
    sim_m = tmc.Simulation(
        hd.make_system(), chains,
        [dict(algorithm=tmc.Metropolis,
              pool=(hd.displacement_move(0.35),), sweepstep=n_disks,
              seed=21)],
        600, path=str(tmp_path / "m"))
    sim_m.run()
    sys_m = sim_m.device_state["sys"]
    assert bool(hd.overlap_free(sys_m).all())
    d_mh = float(hd.min_pair_distance(sys_m).mean())
    cnt = sim_m.device_state["metropolis"]["counters"].numpy()
    acc = cnt[..., 0].sum() / cnt[..., 1].sum()
    assert 0.05 < acc < 0.95
    np.testing.assert_allclose(d_ecmc, d_mh, rtol=0.03)


def test_hard_disks_ecmc_pressure_matches_virial(tmp_path):
    """beta P / rho = 1 + <excess>/l against the virial expansion (B2..B5)
    at eta 0.15."""
    eta, n_disks, n_chains = 0.15, 32, 64
    rho = 4.0 * eta / np.pi
    sim = _run_hard_disks(tmp_path, n_chains, n_disks, eta, steps=120,
                          events_per_step=8, chain_length=3.0)
    st = sim.device_state["ecmc"]["stats"]
    assert int(st["cap_hits"].sum()) == 0
    p = hd.ecmc_pressure(st, 3.0)
    assert p == ref_hd.ecmc_pressure(
        {k: v.numpy() for k, v in st.items()}, 3.0)
    b2 = np.pi / 2
    virial = (1.0 + b2 * rho + 0.78202 * b2 ** 2 * rho ** 2
              + 0.53223 * b2 ** 3 * rho ** 3
              + 0.33356 * b2 ** 4 * rho ** 4)
    np.testing.assert_allclose(p, virial, rtol=0.03)


def test_hard_sphere_ecmc_3d(tmp_path):
    """3-D straight event chains: overlap-free, events fire, and the MKK
    pressure after an equilibration run in Carnahan-Starling's band
    (4.97 at eta 0.35; the reference's gate 4-6)."""
    n, m, steps = 216, 16, 40
    chains = hd.init_chains(m, n, eta=0.35, seed=60, dim=3, device="cpu")
    ell = float(chains.box[0]) / 2.0
    kw = dict(n_chains=m, n_disks=n, eta=0.35, steps=steps,
              events_per_step=4, chain_length=ell, seed=9, max_events=512)
    sim = _run_hard_disks(tmp_path / "a", start=chains, **kw)
    sim = _run_hard_disks(tmp_path / "b", start=sim.device_state["sys"], **kw)
    stats = sim.device_state["ecmc"]["stats"]
    assert int(stats["cap_hits"].sum()) == 0
    assert bool((stats["collisions"] > 0).all())
    assert bool(hd.overlap_free(sim.device_state["sys"]).all())
    p_red = hd.ecmc_pressure(stats, ell)
    assert 4.0 < p_red < 6.0, p_red


# -- resume and interop --------------------------------------------------------------

def _lj_sim(path, steps, backups=()):
    chains = lj.init_chains(4, 32, rho=0.6, beta=1.0, frac_b=0.2, seed=2,
                            device="cpu")
    algos = [dict(algorithm=tmc.EventChain, model=lj.ecmc_model(1.0),
                  events_per_step=2, seed=4),
             dict(algorithm=tmc.StoreCallbacks,
                  callbacks=(lj.callback_energy_per_particle,),
                  scheduler=np.arange(2, steps + 1, 2))]
    if backups:
        algos.append(dict(algorithm=tmc.StoreBackups,
                          scheduler=np.asarray(backups)))
    return tmc.Simulation(lj.make_system(), chains, algos, steps,
                          path=str(path))


def test_cut_and_resumed_run_equals_the_uncut_run(tmp_path):
    whole = _lj_sim(tmp_path / "whole", 8, backups=[4])
    whole.run()
    resumed = _lj_sim(tmp_path / "resumed", 8)
    checkpoint.resume_state(
        resumed, str(tmp_path / "whole" / "checkpoints" / "ckpt_t4.npz"))
    assert resumed.t == 4
    resumed.run()
    assert_same_state(whole.device_state, resumed.device_state)


def test_ecmc_slice_carried_both_ways():
    """The reference's ``ecmc`` slice (zig-zag: lift ``v``, four float
    statistics) into the port's and back; the port keeps its keys."""
    ref_chains = ref_p1d.init_chains(6, beta=BETA, seed=1)

    class _Sim:
        n_chains = 6
        chains0 = ref_chains

    ref_slc = RefEventChain(_Sim(), ref_p1d.zigzag_model()).init_state(
        _Sim())
    ref_slc = {**ref_slc, "n_events": jnp.arange(6, dtype=jnp.int32),
               "stats": {k: v + 0.5 for k, v in ref_slc["stats"].items()}}
    chains = interop.chains_from_reference(_np(ref_chains), device="cpu")

    class _PortSim:
        n_chains, device, chains0 = 6, torch.device("cpu"), chains

    like = tmc.EventChain(_PortSim(), p1d.zigzag_model()).init_state(
        _PortSim())
    ref_np = jax.tree_util.tree_map(
        np.asarray, {k: v for k, v in ref_slc.items() if k != "keys"})
    slc = interop.slice_from_reference("ecmc", ref_np, like)
    assert slc["keys"] is like["keys"]
    assert slc["n_events"].dtype == torch.int32
    np.testing.assert_array_equal(slc["lift"]["v"].numpy(),
                                  np.asarray(ref_slc["lift"]["v"]))
    back = interop.slice_to_reference("ecmc", slc)
    assert set(back) == {"lift", "stats", "n_events"}
    for k, v in ref_slc["stats"].items():
        np.testing.assert_array_equal(back["stats"][k], np.asarray(v))
    np.testing.assert_array_equal(back["n_events"], np.arange(6))
