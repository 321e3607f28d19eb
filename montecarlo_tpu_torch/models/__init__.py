"""The ported model families (the reference's ``montecarlo_tpu.models``
subset)."""

from . import (hard_disks, ising, ising2d, lennard_jones, particle1d,
               polydisperse, potts)

__all__ = ["hard_disks", "ising", "ising2d", "lennard_jones", "particle1d",
           "polydisperse", "potts"]
