"""Tests for the spiral visit-order rank table."""

import numpy as np
import pytest

from blockbasedmotionestimation.ops import spiral


@pytest.mark.parametrize("shift", [0, 1, 2, 3, 4, 8, 16, 32, 10, 31])
def test_spiral_covers_square(shift):
    """The walk tiles exactly the square [-S, S]^2 it claims to cover."""
    visits = spiral.spiral_visits(shift)
    ext = spiral.spiral_extent(shift)
    covered = {(y, x) for y, x in visits}
    expected = {(y, x) for y in range(-ext, ext + 1) for x in range(-ext, ext + 1)}
    assert covered == expected


@pytest.mark.parametrize("shift", [2, 4, 8, 32])
def test_even_shift_extent_matches_exhaustive_window(shift):
    """For even shift, extent = shift/2, the dead exhaustive path's start_pos
    (motion_framework.cpp:249)."""
    assert spiral.spiral_extent(shift) == shift // 2


def test_shift32_window_is_33x33():
    assert spiral.spiral_rank(32).shape == (33, 33)


@pytest.mark.parametrize("shift", [1, 3, 31])
def test_odd_shift_extent(shift):
    assert spiral.spiral_extent(shift) == (shift - 1) // 2


@pytest.mark.parametrize("shift", [0, 1, 2, 3, 8, 32])
def test_rank_is_first_visit_order(shift):
    visits = spiral.spiral_visits(shift)
    ext = spiral.spiral_extent(shift)
    rank = spiral.spiral_rank(shift)
    first = {}
    for idx, (y, x) in enumerate(visits):
        first.setdefault((y, x), idx)
    for (y, x), idx in first.items():
        assert rank[y + ext, x + ext] == idx
    # center is rank 0
    assert rank[ext, ext] == 0
    # all ranks distinct
    assert len(np.unique(rank)) == rank.size


def test_zero_shift_single_cell():
    rank = spiral.spiral_rank(0)
    assert rank.shape == (1, 1)
    assert rank[0, 0] == 0


def test_rank_tiebreak_prefers_spiral_proximity():
    """First ring (distance-1 neighbors visited before distance-2)."""
    rank = spiral.spiral_rank(4)
    ext = spiral.spiral_extent(4)
    ring1 = [rank[ext + dy, ext + dx] for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy, dx) != (0, 0)]
    ring2_sample = rank[ext - 2, ext - 2]
    assert max(ring1) < ring2_sample or ring2_sample > min(ring1)  # ring1 visited early
    # right neighbor is the very first step of the walk
    assert rank[ext, ext + 1] == 1
