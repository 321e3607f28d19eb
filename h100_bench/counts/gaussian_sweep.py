"""Operations and bytes that one call of the Gaussian sweep needs: the
Metropolis steps of a symmetric Gaussian displacement of a 1-D particle
in U(x) = x^2, drawn from the counter-hash stream, counted from the
algorithm and the call's shapes (never from what a compiled kernel
executes).  Integer operations count as float32 operations; a special
function (log, sqrt, cos, sin) counts as one.
"""

#: a finalizer of the stream: two multiplies, two shifts, two xors
HASH = 6
#: one uniform: the draw tag's xor, a finalizer, the draw index's add, a
#: finalizer, then shift, or and subtract to a float in (0, 1]
WORD = 1 + HASH + 1 + HASH + 3
#: a pair of steps per chain: the lane's add to the pair's seed hash, four
#: uniforms, Box-Muller (log, *-2, sqrt, 2 pi *, cos, sin, r * cos,
#: r * sin)
PAIR = 1 + 4 * WORD + 8
#: a step per chain: sigma * z, x + d, U(x') = x'^2, U(x) - U(x'),
#: beta * dU, log u, the test, two selects, the count
STEP = 10
#: per pair, shared by the chains: the pair's seed add and finalizer
PAIR_SHARED = 1 + HASH
#: per chain and call: its lane (multiply, multiply, add)
LANE = 3
#: bytes per chain and call: x and beta read, x', U(x') and the accept
#: count written (float32, int32); sigma read once
CHAIN_BYTES = 4 * 2 + 4 * 3


def count(chains: int, steps: int):
    """(operations, bytes) of one call running ``steps`` steps on every
    one of ``chains`` chains."""
    pairs = steps / 2
    ops = chains * (pairs * PAIR + steps * STEP + LANE) + pairs * PAIR_SHARED
    return ops, chains * CHAIN_BYTES + 4
