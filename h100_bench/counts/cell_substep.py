"""Operations and bytes that the cell path's displacement and swap
substeps need, counted from the algorithm (never from the kernels that
run it): per attempted displacement the pair terms of the moved
particle's old and new positions against the expected occupants of its
3 x 3 cells, ``9 N / nc^2``; per attempted swap the two swappers'
geometry against them and four rows of energies; the draws of the
threefry stream (a Gumbel-max pick takes one uniform an occupant of the
cell); the state read once a substep and the active cells' particles
written.  Integer operations count as float32 operations, a fused
multiply-add as two; a special function (log, log1p, sqrt, round)
counts as one.  A later kernel that runs the substeps is read against
the same count.
"""

#: a threefry2x32 block: the key's parity word (two xors), the counts'
#: two key adds, 20 rounds of add, rotate and xor, 5 injections of three
#: adds
BLOCK = 2 + 2 + 20 * 3 + 5 * 3
#: a float32 uniform: a block, the words' xor, shift, or, subtract, and
#: the scale's fused multiply-add and max
UNIFORM = BLOCK + 1 + 3 + 2 + 1
#: a normal: a uniform, then erf_inv: x * -x, log1p, the negation, the
#: branch's compare, w - 2.5 or sqrt(w) - 3, eight fused multiply-adds,
#: p * x, and the product with sqrt(2)
NORMAL = UNIFORM + 1 + 1 + 1 + 1 + 2 + 8 * 2 + 1 + 1
#: a pair's geometry: per axis the fractional difference, its round and
#: subtraction, the square; the two squares' add and the product by L^2
GEOMETRY = 2 * 4 + 1 + 1
#: a pair's energy: the pair type (an add), the cut-off compare,
#: max(r^2, eps), sigma^2 / r^2, i6 (two multiplies), i6^2 - i6 (two),
#: 4 eps times it, less the shift, the select, the sum's add
ENERGY = 1 + 1 + 1 + 1 + 2 + 2 + 1 + 1 + 1 + 1
PAIR = GEOMETRY + ENERGY
#: a pick's work an occupant: its uniform, the mask's select, the max's
#: compare
PICK = UNIFORM + 2
#: a displacement's own work: two normals, the accept uniform and its
#: log, the step (two multiplies, two adds), the halo (four adds, four
#: compares), dE, -beta dE, the test, the select of each coordinate, the
#: chain sum's add and the two counts
DISP_SCALAR = 2 * NORMAL + UNIFORM + 1 + 4 + 8 + 1 + 1 + 1 + 2 + 1 + 2
#: a swap's own work: the accept uniform and its log, the two energies'
#: adds, dE, -beta dE, the test, the two labels' selects, the chain sum's
#: add and the two counts
SWAP_SCALAR = UNIFORM + 1 + 2 + 1 + 1 + 1 + 2 + 1 + 2
#: a substep's keys per chain (fold_in and the split into three) and, once
#: for every chain, its kind and colour (fold_in, randint's split and two
#: words, the kind's fold_in and uniform)
CHAIN_KEYS = 4 * BLOCK
VARIANT = 5 * BLOCK + 4
#: a particle's state: x, y and the label (float32)
PARTICLE_BYTES = 12


def grid(n: int, rho: float, rcut_max: float, d_cap: float = 0.45,
         dim: int = 2) -> int:
    """The cells a side, ``nc``: the largest even number with ``L / nc >=
    rcut_max + 2 d_cap``, ``L = (N / rho)^(1/dim)``."""
    nc = int((n / rho) ** (1.0 / dim) / (rcut_max + 2.0 * d_cap))
    return nc - nc % 2


def disp_ops(occupants: float) -> float:
    return occupants / 9 * PICK + DISP_SCALAR + 2 * occupants * PAIR


def swap_ops(occupants: float) -> float:
    return (2 * occupants / 9 * PICK + SWAP_SCALAR
            + occupants * (2 * GEOMETRY + 4 * ENERGY))


def count(chains: int, n: int, nc: int, disp: int, swap: int,
          substeps: int, dim: int = 2):
    """(operations, bytes) of ``substeps`` substeps over ``chains`` chains
    of ``n`` particles in an ``nc^dim`` grid that attempted ``disp``
    displacements and ``swap`` swaps, summed over the chains.  A substep
    reads every particle's state once and writes the particles of its
    active cells."""
    occupants = 3 ** dim * n / nc ** dim
    ops = (disp * disp_ops(occupants) + swap * swap_ops(occupants)
           + substeps * (chains * CHAIN_KEYS + VARIANT))
    active = nc ** dim / 2 ** dim
    nbytes = substeps * chains * PARTICLE_BYTES * (n + active)
    return ops, nbytes

