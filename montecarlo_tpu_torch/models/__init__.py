"""The model families of the port: every one of the reference's
``montecarlo_tpu.models``."""

from . import (hard_disks, heisenberg, ising, ising2d, lennard_jones,
               particle1d, polydisperse, potts, tfim, xy)

__all__ = ["hard_disks", "heisenberg", "ising", "ising2d", "lennard_jones",
           "particle1d", "polydisperse", "potts", "tfim", "xy"]
