"""The operation and byte counts behind each roofline, by hand at small
shapes."""

from bench_helpers import spec

G = spec.module("counts", "gaussian_sweep")
L = spec.module("counts", "lj_mixed_sweep")


def test_gaussian_word_and_pair():
    # xor, finalizer (6), add, finalizer (6), shift/or/subtract
    assert G.WORD == 17
    # lane add, four words, Box-Muller's eight
    assert G.PAIR == 1 + 68 + 8


def test_gaussian_call():
    # 3 chains x 4 steps: 2 pairs a chain of 77, 4 steps of 10, a lane of
    # 3; 2 shared pair seeds of 7
    ops, nbytes = G.count(3, 4)
    assert ops == 3 * (2 * 77 + 4 * 10 + 3) + 2 * 7 == 605
    # x, beta read; x', e', accepted written; sigma
    assert nbytes == 3 * 20 + 4 == 64


def test_lj_pair_terms():
    assert L.GEOMETRY == 13 and L.ENERGY == 14 and L.PAIR == 27
    assert L.WORD == 18


def test_lj_displacement_and_swap_by_hand():
    n = 4
    # a displacement: 4 words (72), pick 3, Box-Muller 9, log u 1, the move
    # 2, dE 1, -beta dE 1, test 1, wraps 8, selects 3, energy add 1, count
    # 1, and two rows of 3 pair terms
    assert L.disp_ops(n) == 72 + 3 + 9 + 1 + 2 + 1 + 1 + 1 + 8 + 3 + 1 + 1 \
        + 2 * 3 * 27
    # a swap: per slot two words, the species test, two picks of four; the
    # scalar work; two rows of geometry and four of energy over N - 2
    assert L.swap_ops(n) == n * (36 + 1 + 8) + (1 + 19 + 1 + 3 + 1 + 2 + 2
                                                  + 2 + 1) + 2 * (26 + 56)


def test_lj_call():
    ops, nbytes = L.count(chains=2, n=4, disp=5, swap=3, calls=1, steps=4,
                          blocks=1)
    assert ops == 5 * L.disp_ops(4) + 3 * L.swap_ops(4) + 8 * 1 + 4 * 18
    # per chain: x, y, label read and written (12 bytes a particle each
    # way), beta and energy read, energy and four counts written; the table
    assert nbytes == 2 * (4 * (3 * 4 + 2) + 4 * (3 * 4 + 5)) + 64
