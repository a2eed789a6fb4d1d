"""Spiral visit-order ranks: the key to vectorizing the reference's hot kernel.

The reference's spiral block search (``motion_framework.cpp:296-422``) walks a
square spiral from the predicted center - right m, down m, left m+1, up m+1 for
m = 1, 3, 5, ... < shift, plus a final (m-1)-step run right - keeping the first
strictly-smaller SAD.  "First strictly-smaller" means the winner is the minimum
SAD with ties broken by earliest visit.

The engine does not walk a spiral: it evaluates the whole (2S+1)^2 cost volume in
one vectorized pass and takes a lexicographic argmin over ``(cost, spiral_rank)``
where ``spiral_rank`` is the static visit order computed here.  This is exactly
equivalent to the sequential walk:

  * out-of-bounds offsets are skipped in the walk but still advance the cursor
    (``motion_framework.cpp:335-336``), so the reachable set is all in-bounds
    positions of the square - masking them to +inf cost preserves semantics;
  * re-visited positions (the closing run overlaps ring cells) can never win a
    strict-< comparison against their first visit, so first-visit rank is the
    correct tie-break key.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def spiral_extent(shift: int) -> int:
    """Half-width S of the square the spiral covers: offsets in [-S, S]^2.

    For the shipped config (shift = 64 - 32 = 32) this is 16, i.e. a 33x33
    window - identical to the dead exhaustive path's ``start_pos = shift >> 1``
    (``motion_framework.cpp:249``).
    """
    return _spiral_tables(shift)[1]


@functools.lru_cache(maxsize=None)
def _spiral_tables(shift: int) -> tuple[bytes, int]:
    """Simulate the spiral walk; returns (rank array bytes, extent S).

    Rank array has shape (2S+1, 2S+1) int32 indexed by (dy + S, dx + S); the
    center has rank 0 and every other covered offset gets its first-visit step
    index.  Offsets never visited (impossible for this walk, which tiles the
    square exactly) would keep a sentinel larger than any real rank.
    """
    visits: list[tuple[int, int]] = [(0, 0)]
    x = y = 0

    def step(dx: int, dy: int, n: int) -> None:
        nonlocal x, y
        for _ in range(n):
            x += dx
            y += dy
            visits.append((y, x))

    m = 1
    while m < shift:
        step(1, 0, m)  # right m
        step(0, 1, m)  # down m
        step(-1, 0, m + 1)  # left m+1
        step(0, -1, m + 1)  # up m+1
        m += 2
    step(1, 0, max(0, m - 1))  # final top-row run (motion_framework.cpp:397-411)

    ext = max(max(abs(y), abs(x)) for y, x in visits)
    side = 2 * ext + 1
    rank = np.full((side, side), np.iinfo(np.int32).max, dtype=np.int32)
    for idx, (vy, vx) in enumerate(visits):
        cell = (vy + ext, vx + ext)
        if rank[cell] == np.iinfo(np.int32).max:
            rank[cell] = idx
    assert (rank < np.iinfo(np.int32).max).all(), "spiral did not tile its square"
    return rank.tobytes(), ext


def spiral_rank(shift: int) -> np.ndarray:
    """(2S+1, 2S+1) int32 first-visit ranks, center (S, S) = 0."""
    data, ext = _spiral_tables(shift)
    side = 2 * ext + 1
    return np.frombuffer(data, dtype=np.int32).reshape(side, side).copy()


@functools.lru_cache(maxsize=None)
def spiral_offsets(shift: int) -> tuple[np.ndarray, np.ndarray, int]:
    """Deduplicated (dy, dx) offsets in first-visit order, plus extent S.

    The returned arrays enumerate every cell of the [-S, S]^2 square exactly
    once, ordered by spiral visit rank - scanning them in order with a
    strict-< argmin update reproduces the reference walk's tie-breaks.
    """
    visits = spiral_visits(shift)
    seen: set[tuple[int, int]] = set()
    dys, dxs = [], []
    for dy, dx in visits:
        if (dy, dx) not in seen:
            seen.add((dy, dx))
            dys.append(dy)
            dxs.append(dx)
    ext = spiral_extent(shift)
    assert len(dys) == (2 * ext + 1) ** 2, "spiral must tile its square"
    return np.asarray(dys, dtype=np.int32), np.asarray(dxs, dtype=np.int32), ext


def spiral_visits(shift: int) -> list[tuple[int, int]]:
    """The raw (dy, dx) visit sequence, for oracle tests."""
    visits: list[tuple[int, int]] = [(0, 0)]
    x = y = 0
    m = 1
    while m < shift:
        for _ in range(m):
            x += 1
            visits.append((y, x))
        for _ in range(m):
            y += 1
            visits.append((y, x))
        for _ in range(m + 1):
            x -= 1
            visits.append((y, x))
        for _ in range(m + 1):
            y -= 1
            visits.append((y, x))
        m += 2
    for _ in range(max(0, m - 1)):
        x += 1
        visits.append((y, x))
    return visits
