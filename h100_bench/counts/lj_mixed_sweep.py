"""Operations and bytes that one call of the LJ displacement + species
swap sweep needs, counted from the algorithm and the call's shapes (never
from what a compiled kernel executes): per displacement the pair terms of
the moved particle's old and new positions against the N - 1 others, per
swap the four rows of the two swapped particles against the N - 2 others
(their geometry twice, their energies four times) and the two Gumbel-max
picks over N uniforms each; the draws of the counter-hash stream; the
state read once and written once.  Integer operations count as float32
operations; a special function (log, sqrt, cos, sin, floor, round)
counts as one.
"""

#: a finalizer of the stream: two multiplies, two shifts, two xors
HASH = 6
#: one uniform from a hash base: the base's add, the draw tag's xor, a
#: finalizer, the draw index's add, a finalizer, shift, or, subtract
WORD = 1 + 1 + HASH + 1 + HASH + 3
#: a pair's geometry: two differences, the minimum image of each (multiply,
#: round, multiply, subtract), the squared distance (two multiplies, an add)
GEOMETRY = 2 + 2 * 4 + 3
#: a pair's energy: the pair type (an add), max(r2, eps), the reciprocal,
#: * sigma^2, i6 (two multiplies), 4 eps (i6^2 - i6) - shift (five), the
#: cut-off test and select, the row sum's add
ENERGY = 1 + 3 + 2 + 5 + 2 + 1
PAIR = GEOMETRY + ENERGY
#: a displacement's scalar work: four uniforms, the pick (multiply,
#: convert, min), Box-Muller (log, *-2, sqrt, * sigma, 2 pi *, cos, sin,
#: two multiplies), log u, the two adds of the move, dE, -beta dE, the
#: test, the wrap of x and y (multiply, floor, multiply, subtract each),
#: three selects, the energy's add, the count
DISP_SCALAR = 4 * WORD + 3 + 9 + 1 + 2 + 1 + 1 + 1 + 8 + 3 + 1 + 1
#: a swap's work per slot: two uniforms (the seed's xor counted once), the
#: species test, and per pick a select, the max, the tie test and the
#: index min
SWAP_SLOT = 2 * WORD + 1 + 2 * 4
#: a swap's scalar work: the seed's xor, the accept uniform (its xor
#: beside) and its log, dE from four rows (three adds), -beta dE, the
#: validity and the test, two species selects, the energy's add and
#: select, the count
SWAP_SCALAR = 1 + (WORD + 1) + 1 + 3 + 1 + 2 + 2 + 2 + 1
#: a step, per block of chains: the step's seed (an add and a finalizer)
#: and the kind draw (xor, finalizer, mask, convert, multiply, test)
STEP_SHARED = (1 + HASH) + (1 + HASH + 4)
#: per chain and step: the block's seed mixed into the chain's
STEP_CHAIN = 1


def disp_ops(n: int) -> int:
    return DISP_SCALAR + 2 * (n - 1) * PAIR


def swap_ops(n: int) -> int:
    return (n * SWAP_SLOT + SWAP_SCALAR
            + (n - 2) * (2 * GEOMETRY + 4 * ENERGY))


def count(chains: int, n: int, disp: int, swap: int, calls: int,
          steps: int, blocks: int):
    """(operations, bytes) of ``calls`` calls of ``steps`` steps on
    ``chains`` chains of ``n`` particles in ``blocks`` blocks of the
    stream's grid, ``disp`` displacement and ``swap`` swap attempts summed
    over the chains.  Each call reads x, y, the labels, beta and the
    energy once and writes x, y, the labels, the energy and two pairs of
    counts once (float32, int32), and reads the 16-float table."""
    ops = (disp * disp_ops(n) + swap * swap_ops(n)
           + (disp + swap) * STEP_CHAIN + calls * steps * blocks * STEP_SHARED)
    chain_bytes = 4 * (3 * n + 2) + 4 * (3 * n + 1 + 4)
    return ops, calls * (chains * chain_bytes + 16 * 4)
