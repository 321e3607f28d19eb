"""The port's default device is the card.

An entry point that creates tensors from nothing puts them on ``cuda``
unless the caller names a device; the package never looks for a card and
never falls back to the CPU, so on a machine without one the call raises
torch's own error.  The tests of the port therefore ask for the CPU by name.
"""

import glob
import os

import numpy as np
import pytest
import torch

import montecarlo_tpu_torch as tmc
from montecarlo_tpu_torch import interop
from montecarlo_tpu_torch import policy_guided as pg
from montecarlo_tpu_torch.models import hard_disks as hd
from montecarlo_tpu_torch.models import heisenberg, tfim, xy
from montecarlo_tpu_torch.models import ising, ising2d, potts
from montecarlo_tpu_torch.models import lennard_jones as lj
from montecarlo_tpu_torch.models import particle1d as p1d
from montecarlo_tpu_torch.models import polydisperse as poly
from montecarlo_tpu_torch.ops import fused_sweep
from montecarlo_tpu_torch.utils.device import resolve_device

_NP_P1D = {k: np.zeros(3, np.float32) for k in ("x", "beta", "e")}

ENTRY_POINTS = {
    "particle1d.init_chains":
        lambda **kw: p1d.init_chains(4, beta=2.0, seed=1, **kw).x,
    "lennard_jones.init_chains":
        lambda **kw: lj.init_chains(2, 9, 0.7, 1.0, frac_b=0.2, seed=1,
                                    **kw).pos,
    "polydisperse.init_chains":
        lambda **kw: poly.init_chains(2, 9, rho=0.9, beta=2.0, seed=1,
                                      **kw).pos,
    "hard_disks.init_chains":
        lambda **kw: hd.init_chains(2, 9, eta=0.5, seed=1, **kw).pos,
    "interop.chains_from_reference":
        lambda **kw: interop.chains_from_reference(_NP_P1D, **kw).x,
    "init_gradient_data":
        lambda **kw: pg.init_gradient_data(2, **kw).g,
    "software_bits":
        lambda **kw: fused_sweep.software_bits(7, 0, (8, 128), **kw),
    "ising.init_chains":
        lambda **kw: ising.init_chains(2, 8, beta=0.5, **kw).spins,
    "ising2d.init_chains":
        lambda **kw: ising2d.init_chains(2, 4, beta=0.5, **kw).spins,
    "potts.init_chains":
        lambda **kw: potts.init_chains(2, 4, q=3, beta=0.5, **kw).spins,
    "tile_ladder":
        lambda **kw: tmc.tile_ladder([1.0, 2.0], 3, **kw),
    "xy.init_chains":
        lambda **kw: xy.init_chains(2, 4, beta=0.5, **kw).theta,
    "heisenberg.init_chains":
        lambda **kw: heisenberg.init_chains(2, 4, beta=0.5, **kw).spins,
    "tfim.init_chains":
        lambda **kw: tfim.init_chains(2, 4, 8, 1.0, **kw).spins,
}


def test_resolve_device():
    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device() == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
    assert resolve_device("cuda:1") == torch.device("cuda", 1)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name):
    """Without ``device=`` the tensors are on ``cuda``; where there is no
    card the call raises, and never hands back a CPU tensor."""
    make = ENTRY_POINTS[name]
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            make()
    assert make(device="cpu").device.type == "cpu"


def test_simulation_follows_its_chains(tmp_path):
    chains = p1d.init_chains(4, beta=2.0, seed=1, device="cpu")
    sim = tmc.Simulation(p1d.make_system(), chains, [
        dict(algorithm=tmc.Metropolis, pool=(p1d.displacement_move(0.5),),
             seed=1)], 4, path=str(tmp_path))
    assert sim.device == torch.device("cpu")


def test_package_never_looks_for_a_card():
    """No ``is_available`` in the package's sources: the default is
    unconditional."""
    root = os.path.dirname(tmc.__file__)
    sources = glob.glob(os.path.join(root, "**", "*.py"), recursive=True)
    assert len(sources) > 20
    hits = [p for p in sources if "is_available" in open(p).read()]
    assert hits == []
