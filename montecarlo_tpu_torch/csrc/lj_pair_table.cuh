// The 2-D Lennard-Jones species-pair constants that lj_energy.cu and
// cell_substep.cu take by value (ops/lj_energy.py: _PairTable, filled by
// _pair_table).

#pragma once

// Each indexed AA, AB, BB: 4 eps, sig^2, (rcut sig)^2 and the shift 4 eps
// ((1 / rcut)^12 - (1 / rcut)^6), rounded to float32 as the plain twins
// round them.
struct PairTable {
  float e4[3];
  float s2[3];
  float rc2[3];
  float sh[3];
};
