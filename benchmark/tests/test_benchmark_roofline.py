"""The roofline count reads the work the inputs need: the same for a step
whichever group size (nb) runs it, and no kernel time, even at the best
bound any grouping could reach, reads over 100%."""

import pytest

from hbench import sht_counts

NSIDE, LMAX = 4096, 3000


def test_triples_of_the_north_star():
    assert sht_counts.triples(NSIDE, LMAX, LMAX, 0) == 8192 * 4_504_501


def grouped_bound(maps, spin, nb):
    """The least time of ``maps`` maps run in groups of ``nb`` sharing one
    recurrence, with the products on the tensor cores as three TF32
    passes (the grouped kernels' own bound), and the bytes."""
    t = sht_counts.triples(NSIDE, LMAX, LMAX, spin)
    shared = sht_counts.FLOP_SHARED[spin]
    prod = sht_counts.FLOP_PER_TRIPLE[spin] - shared
    groups = -(-maps // nb)
    ops = (groups * shared * t / sht_counts.FP32_FLOP_PER_S
           + 3 * maps * prod * t / sht_counts.TF32_FLOP_PER_S)
    return ops


@pytest.mark.parametrize("spin", [0, 2])
@pytest.mark.parametrize("nb", [1, 2, 4, 8])
def test_least_time_is_below_every_grouping(spin, nb):
    maps = 8
    least, _ = sht_counts.least_seconds(NSIDE, LMAX, LMAX, {spin: maps})
    # the count does not depend on nb; every grouping's own bound is at
    # least the count, so a measured time of any grouping reads <= 100%
    assert least <= grouped_bound(maps, spin, nb) * (1 + 1e-12)


def test_spin0_step_of_six_maps():
    least, bound = sht_counts.least_seconds(NSIDE, LMAX, LMAX, {0: 6})
    assert bound == "recurrence"
    assert least == pytest.approx(5 * 8192 * 4_504_501 / 67e12)
    # B1 at nb 1 on six maps (PERF.md: 14.9 ms a launch) reads ~3%
    assert 100.0 * least / (6 * 14.9e-3) == pytest.approx(3.08, abs=0.01)
