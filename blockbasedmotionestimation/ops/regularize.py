"""8-connected MV regularization sweeps (reference ``motion_framework.cpp:424-662``).

Per block, the reference gathers a candidate list (own MV first, then up to 8
neighbors' MVs, with 9 border cases each having its own candidate ordering),
scores Energy(c) = SAD(block at p, block at p+c) + lambda*mult*Smoothness(c)
with Smoothness(c) = sum_j |c - c_j|_1 over the candidate list, and adopts the
first strict minimum - updating the flow field IN PLACE so later raster
positions see earlier updates (Gauss-Seidel, ``:616``).

Three scheduling modes re-express this for a data-parallel device:

  * ``jacobi``    - every block updates from the previous iterate in one
                    batched pass.  Fully parallel, not bit-exact.
  * ``fourcolor`` - blocks are colored by (block_row % 2, block_col % 2); the
                    4 colors update sequentially, each color in parallel.  An
                    8-connected Gauss-Seidel with the same per-sweep work as
                    one Jacobi pass; converges like the reference but visits
                    in a different order, so not bit-exact.
  * ``exact``     - a sequential raster scan (lax.scan over blocks) matching
                    the reference's in-place sweep bit for bit.  For oracle
                    parity tests and small frames.

Tie-breaks are reproduced exactly in all modes: each border case's candidate
ordering becomes a static rank table and the winner is the lexicographic
(energy, rank) minimum - identical to "first strict min" over the ordered list
(``min_energy_candidate``, ``:646-662``).

Tiling: like ``ops.search``, the row-sharded path passes global frame dims
plus traced row offsets, a neighbor-halo'd grid (``gp``), and an im2 buffer
with halo rows; all border cases and bounds checks use global coordinates, so
a tiled fourcolor/jacobi sweep equals its untiled counterpart bit-for-bit.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from blockbasedmotionestimation.ops.search import block_cost, extract_blocks

_F32_MAX = np.float32(np.finfo(np.float32).max)
_BIG_RANK = np.int32(127)

# Canonical candidate slots, in the INTERIOR ordering (motion_framework.cpp:439-450):
# own MV first, then the 8 neighbors in the reference's gather order.
SLOTS: tuple[tuple[int, int], ...] = (
    (0, 0), (0, -1), (0, 1), (1, 1), (-1, -1), (-1, 1), (-1, 0), (1, 0), (1, -1),
)
_SLOT_INDEX = {s: k for k, s in enumerate(SLOTS)}

# Border-case candidate orderings (:439-522), each a distinct tie-break order.
_CASE_ORDERINGS: tuple[tuple[tuple[int, int], ...], ...] = (
    SLOTS,  # 0 interior
    ((0, 0), (0, -1), (0, 1), (1, 1), (1, 0), (1, -1)),     # 1 top row
    ((0, 0), (0, -1), (0, 1), (-1, -1), (-1, 1), (-1, 0)),  # 2 bottom row
    ((0, 0), (0, 1), (1, 1), (-1, 1), (-1, 0), (1, 0)),     # 3 left col
    ((0, 0), (0, -1), (-1, -1), (-1, 0), (1, 0), (1, -1)),  # 4 right col
    ((0, 0), (0, 1), (1, 1), (1, 0)),                        # 5 top-left
    ((0, 0), (0, -1), (1, 0), (1, -1)),                      # 6 top-right
    ((0, 0), (0, 1), (-1, 1), (-1, 0)),                      # 7 bottom-left
    ((0, 0), (0, -1), (-1, -1), (-1, 0)),                    # 8 bottom-right
)


def _rank_table() -> np.ndarray:
    """(9 cases, 9 slots) int32: visit rank of each slot per border case,
    _BIG_RANK when the slot is not in that case's candidate list."""
    table = np.full((9, 9), _BIG_RANK, dtype=np.int32)
    for case, ordering in enumerate(_CASE_ORDERINGS):
        for rank, slot in enumerate(ordering):
            table[case, _SLOT_INDEX[slot]] = rank
    return table


_RANK_TABLE = _rank_table()


def _border_case(i: jnp.ndarray, j: jnp.ndarray, nby: int, nbx: int) -> jnp.ndarray:
    """Reference if-chain (:439-522) in block units; i, j broadcastable int32."""
    interior = (i > 0) & (i < nby - 1) & (j > 0) & (j < nbx - 1)
    top = (i == 0) & (j > 0) & (j < nbx - 1)
    bottom = (i == nby - 1) & (j > 0) & (j < nbx - 1)
    left = (j == 0) & (i > 0) & (i < nby - 1)
    right = (j == nbx - 1) & (i > 0) & (i < nby - 1)
    tl = (i == 0) & (j == 0)
    tr = i == 0
    bl = j == 0
    case = jnp.full(jnp.broadcast_shapes(i.shape, j.shape), 8, dtype=jnp.int32)
    case = jnp.where(bl, 7, case)
    case = jnp.where(tr, 6, case)
    case = jnp.where(tl, 5, case)
    case = jnp.where(right, 4, case)
    case = jnp.where(left, 3, case)
    case = jnp.where(bottom, 2, case)
    case = jnp.where(top, 1, case)
    case = jnp.where(interior, 0, case)
    return case


def _select_lexicographic(energy: jnp.ndarray, rank: jnp.ndarray) -> jnp.ndarray:
    """First-strict-min over the case ordering == argmin of (energy, rank).

    energy, rank: (..., 9).  Returns (...,) winning slot indices.
    """
    e_min = jnp.min(energy, axis=-1, keepdims=True)
    rank_sel = jnp.where(energy == e_min, rank, _BIG_RANK)
    return jnp.argmin(rank_sel, axis=-1)


def _energies(
    im1_blocks: jnp.ndarray,  # (m, n, bs, bs) int16 source blocks
    im2: jnp.ndarray,         # (Hb, W) uint8 frame-2 buffer (tile + halo)
    cands: jnp.ndarray,       # (m, n, 9, 2) float32 candidate MVs
    present: jnp.ndarray,     # (m, n, 9) bool
    oy: jnp.ndarray,          # (m, n) int32 GLOBAL block origin rows
    ox: jnp.ndarray,          # (m, n) int32 block origin cols
    bs: int,
    lam_mult: jnp.ndarray,    # f32 scalar: lambda * lambda_multiplier
    full_h: int,
    im2_row0: jnp.ndarray,
    cost: str = "sad",
    full_w: int | None = None,
    im2_col0: jnp.ndarray | int = 0,
) -> jnp.ndarray:
    """(m, n, 9) float32 candidate energies (find_min_candidate, :532-621)."""
    h = full_h
    w = im2.shape[1] if full_w is None else full_w
    im2_col0 = jnp.asarray(im2_col0, dtype=jnp.int32)
    m, n = oy.shape
    # target block positions: origin + (int)-truncated candidate (:560-575)
    tx = ox[..., None] + cands[..., 0].astype(jnp.int32)  # (m, n, 9)
    ty = oy[..., None] + cands[..., 1].astype(jnp.int32)
    in_img = (tx >= 0) & (tx <= w - bs) & (ty >= 0) & (ty <= h - bs)  # (:578-582)

    im2_i16 = im2.astype(jnp.int16)
    hb, wb = im2.shape

    def slice_one(y, x):
        return jax.lax.dynamic_slice(im2_i16, (y, x), (bs, bs))

    by = jnp.clip(ty - im2_row0, 0, hb - bs)
    bx = jnp.clip(jnp.clip(tx, 0, w - bs) - im2_col0, 0, wb - bs)
    tgt = jax.vmap(slice_one)(
        by.reshape(-1), bx.reshape(-1)
    ).reshape(m, n, 9, bs, bs)
    sad = block_cost(im1_blocks[:, :, None], tgt, (-1, -2), cost)

    # smoothness: sum over PRESENT candidates of |c_i - c_j|_1 (:623-644)
    du = jnp.abs(cands[..., None, 0] - cands[..., None, :, 0])  # (m, n, 9, 9)
    dv = jnp.abs(cands[..., None, 1] - cands[..., None, :, 1])
    smooth = jnp.sum((du + dv) * present[..., None, :].astype(jnp.float32), axis=-1)

    energy = sad.astype(jnp.float32) + lam_mult * smooth  # (:607)
    return jnp.where(present & in_img, energy, _F32_MAX)


def _update_subset(
    im1: jnp.ndarray,
    im2: jnp.ndarray,
    grid: jnp.ndarray,
    bs: int,
    lam_mult: jnp.ndarray,
    iy: np.ndarray,  # static (m,) LOCAL block-row indices to update
    jx: np.ndarray,  # static (n,) block-col indices to update
    full_h: int,
    row0: jnp.ndarray,
    im2_row0: jnp.ndarray,
    gp: jnp.ndarray | None = None,  # optional 1-padded grid (halo'd when tiled)
    cost: str = "sad",
) -> jnp.ndarray:
    """Evaluate and apply the candidate update for the (iy x jx) block subset."""
    nby, nbx = grid.shape[:2]
    nby_total = full_h // bs
    row0_b = row0 // bs  # global block row of local row 0
    m, n = len(iy), len(jx)
    ii = jnp.asarray(iy, dtype=jnp.int32)[:, None]  # (m, 1) local
    jj = jnp.asarray(jx, dtype=jnp.int32)[None, :]  # (1, n)
    gi = ii + row0_b  # global block rows

    # candidate MVs: padded-grid gather per slot (pad value is masked out)
    if gp is None:
        gp = jnp.pad(grid, ((1, 1), (1, 1), (0, 0)), mode="edge")
    cands = jnp.stack(
        [gp[ii + 1 + dy, jj + 1 + dx] for dy, dx in SLOTS], axis=2
    )  # (m, n, 9, 2)

    case = _border_case(gi, jj, nby_total, nbx)  # (m, n)
    rank = jnp.asarray(_RANK_TABLE)[case]  # (m, n, 9)
    present = rank < _BIG_RANK
    # guard degenerate grids (single block row/col) the reference never hits
    for k, (dy, dx) in enumerate(SLOTS):
        ok = (
            (gi + dy >= 0) & (gi + dy < nby_total) & (jj + dx >= 0) & (jj + dx < nbx)
        )
        present = present.at[..., k].set(present[..., k] & ok)

    blocks = extract_blocks(im1, bs).astype(jnp.int16).reshape(nby, nbx, bs, bs)
    im1_blocks = blocks[ii, jj]  # (m, n, bs, bs)
    oy = (gi * bs).astype(jnp.int32) + jnp.zeros((m, n), jnp.int32)
    ox = (jj * bs).astype(jnp.int32) + jnp.zeros((m, n), jnp.int32)

    energy = _energies(
        im1_blocks, im2, cands, present, oy, ox, bs, lam_mult, full_h, im2_row0,
        cost,
    )
    winner = _select_lexicographic(energy, rank)  # (m, n)
    new_mv = jnp.take_along_axis(cands, winner[..., None, None], axis=2)[:, :, 0]
    return grid.at[ii, jj].set(new_mv)


def _update_color_dynamic(
    im1_blocks: jnp.ndarray,  # (nby, nbx, bs, bs) i16 source blocks
    im2: jnp.ndarray,
    grid: jnp.ndarray,        # (nby, nbx, 2), nby/nbx EVEN
    gp: jnp.ndarray,          # (nby+3, nbx+3, 2) 1-top/2-bottom padded grid
    bs: int,
    lam_mult: jnp.ndarray,
    ci: jnp.ndarray,          # traced GLOBAL color row offset in {0, 1}
    cj: jnp.ndarray,          # traced GLOBAL color col offset in {0, 1}
    full_h: int,
    row0: jnp.ndarray,
    im2_row0: jnp.ndarray,
    cost: str = "sad",
    full_w: int | None = None,
    col0: jnp.ndarray | int = 0,
    im2_col0: jnp.ndarray | int = 0,
) -> jnp.ndarray:
    """One color step with TRACED color offsets, for lax.scan over the sweep
    x color schedule (compile-time: one HLO instance per subdivision round
    instead of one per color step).

    The color slab (rows ci::2, cols cj::2) and each slot's candidates are
    materialized with a dynamic_slice + stride-2 reshape trick, numerically
    identical to the static-index path.

    ci/cj are GLOBAL color offsets; on a row tile whose first block row is
    odd (row0_b odd), the LOCAL rows of that color sit at the opposite local
    parity, so all local indexing uses ``lci = (ci + row0_b) % 2`` - this is
    what lets strips with an odd number of block rows shard (r2 instead
    padded frames until every strip was even, a +20% tax at 1080p/8-way).
    """
    nby, nbx = grid.shape[:2]
    m, n = nby // 2, nbx // 2
    nby_total = full_h // bs
    nbx_total = full_w // bs
    row0_b = row0 // bs
    col0_b = col0 // bs
    lci = (ci + row0_b) % 2  # local row offset of global color row ci
    lcj = (cj + col0_b) % 2  # local col offset of global color col cj

    def slab4(x, ci_, cj_):
        # x: (nby, nbx, ...) -> (m, n, ...) rows ci_::2, cols cj_::2
        r = x.reshape((m, 2, n, 2) + x.shape[2:])
        r = jax.lax.dynamic_index_in_dim(r, ci_, axis=1, keepdims=False)
        return jax.lax.dynamic_index_in_dim(r, cj_, axis=2, keepdims=False)

    cands = []
    for dy, dx in SLOTS:
        sub = jax.lax.dynamic_slice(
            gp, (lci + dy + 1, lcj + dx + 1, 0), (nby, nbx, 2)
        )
        cands.append(sub.reshape(nby // 2, 2, nbx // 2, 2, 2)[:, 0, :, 0])
    cands = jnp.stack(cands, axis=2)  # (m, n, 9, 2)

    kk = jnp.arange(m, dtype=jnp.int32)[:, None]
    mm = jnp.arange(n, dtype=jnp.int32)[None, :]
    gi = row0_b + lci + 2 * kk  # (m, 1) global block rows (parity == ci)
    jj = col0_b + lcj + 2 * mm  # (1, n) global block cols (parity == cj)

    # border cases/bounds use the TRUE global grid extents (a padded local
    # nbx would misclassify the frame's last real column as interior)
    case = _border_case(gi, jj, nby_total, nbx_total)
    rank = jnp.asarray(_RANK_TABLE)[case]
    present = rank < _BIG_RANK
    for k, (dy, dx) in enumerate(SLOTS):
        ok = (
            (gi + dy >= 0) & (gi + dy < nby_total)
            & (jj + dx >= 0) & (jj + dx < nbx_total)
        )
        present = present.at[..., k].set(present[..., k] & ok)

    blocks = slab4(im1_blocks, lci, lcj)  # (m, n, bs, bs)
    oy = (gi * bs) + jnp.zeros((m, n), jnp.int32)
    ox = (jj * bs) + jnp.zeros((m, n), jnp.int32)
    energy = _energies(
        blocks, im2, cands, present, oy, ox, bs, lam_mult, full_h, im2_row0,
        cost, full_w=full_w, im2_col0=im2_col0,
    )
    winner = _select_lexicographic(energy, rank)
    new_mv = jnp.take_along_axis(cands, winner[..., None, None], axis=2)[:, :, 0]

    gr = grid.reshape(m, 2, n, 2, 2)
    gr = jax.lax.dynamic_update_slice(
        gr, new_mv[:, None, :, None, :], (0, lci, 0, lcj, 0)
    )
    return gr.reshape(nby, nbx, 2)


def run_schedule(
    im1: jnp.ndarray,
    im2: jnp.ndarray,
    grid: jnp.ndarray,
    bs: int,
    lam0: float,
    sweeps_per_round: int,
    mode: str,
    *,
    full_h: int | None = None,
    row0: jnp.ndarray | int = 0,
    im2_row0: jnp.ndarray | int = 0,
    full_w: int | None = None,
    col0: jnp.ndarray | int = 0,
    im2_col0: jnp.ndarray | int = 0,
    make_gp=None,
    cost: str = "sad",
) -> jnp.ndarray:
    """The per-level regularization schedule (``motion_framework.cpp:141-152``):
    while bs > 1: { sweeps with lambda_multiplier = sweep+1; subdivide;
    lambda *= 2 } - with each round's sweep x color steps fused into ONE
    lax.scan body to keep compile time flat.

    make_gp(grid) -> (nby+3, nbx+3, 2) candidate-padded grid; None pads with
    zeros (correct untiled: out-of-grid slots are masked by global bounds).
    In tiled mode the caller supplies neighbor-halo rows instead.
    """
    from blockbasedmotionestimation.models.engine import subdivide  # cycle-free

    if full_h is None:
        full_h = im1.shape[0]
    if full_w is None:
        full_w = im1.shape[1]
    row0 = jnp.asarray(row0, dtype=jnp.int32)
    im2_row0 = jnp.asarray(im2_row0, dtype=jnp.int32)
    col0 = jnp.asarray(col0, dtype=jnp.int32)
    im2_col0 = jnp.asarray(im2_col0, dtype=jnp.int32)
    if make_gp is None:
        def make_gp(g):
            return jnp.pad(g, ((1, 2), (1, 2), (0, 0)))

    if mode == "exact":
        # sequential reference path: per-sweep function, no scan fusion
        cur, lam = bs, lam0
        while cur > 1:
            for sweep in range(sweeps_per_round):
                grid = regularize_sweep(
                    im1, im2, grid, cur, jnp.float32(lam),
                    jnp.float32(sweep + 1), "exact",
                )
            grid = subdivide(grid)
            cur >>= 1
            lam *= 2.0
        return grid

    if mode == "jacobi":
        colors = [(0, 0)]  # ci/cj unused marker; jacobi updates all blocks
    elif mode == "fourcolor":
        colors = [(0, 0), (0, 1), (1, 0), (1, 1)]
    else:
        raise ValueError(f"unknown regularizer mode: {mode}")

    cur, lam = bs, lam0
    while cur > 1:
        nby, nbx = grid.shape[:2]
        pad_r, pad_c = nby % 2, nbx % 2
        step_gp = make_gp
        if pad_r or pad_c:
            # odd grids (first round on an odd block-row tile or frame):
            # phantom rows are masked by global bounds and sliced off after
            # the scan.  The halo exchange inside make_gp must see only REAL
            # rows (a phantom last row would be sent to the south neighbor),
            # so the pad is stripped before and re-applied after it.
            grid = jnp.pad(grid, ((0, pad_r), (0, pad_c), (0, 0)))

            def step_gp(g):
                gp0 = make_gp(g[:nby, :nbx])
                return jnp.pad(gp0, ((0, pad_r), (0, pad_c), (0, 0)))

        blocks = (
            extract_blocks(im1, cur)
            .astype(jnp.int16)
            .reshape(im1.shape[0] // cur, im1.shape[1] // cur, cur, cur)
        )
        if pad_r or pad_c:
            blocks = jnp.pad(blocks, ((0, pad_r), (0, pad_c), (0, 0), (0, 0)))

        lam_steps, ci_steps, cj_steps = [], [], []
        for sweep in range(sweeps_per_round):
            for ci, cj in colors:
                lam_steps.append(lam * (sweep + 1))
                ci_steps.append(ci)
                cj_steps.append(cj)
        xs = (
            jnp.asarray(lam_steps, dtype=jnp.float32),
            jnp.asarray(ci_steps, dtype=jnp.int32),
            jnp.asarray(cj_steps, dtype=jnp.int32),
        )

        if mode == "jacobi":

            def body(g, x):
                lam_mult, _, _ = x
                gp3 = step_gp(g)
                g = _update_color_jacobi(
                    blocks, im2, g, gp3, cur, lam_mult, full_h, row0, im2_row0,
                    cost, full_w=full_w, col0=col0, im2_col0=im2_col0,
                )
                return g, None

        else:

            def body(g, x):
                lam_mult, ci, cj = x
                gp3 = step_gp(g)
                g = _update_color_dynamic(
                    blocks, im2, g, gp3, cur, lam_mult, ci, cj,
                    full_h, row0, im2_row0, cost,
                    full_w=full_w, col0=col0, im2_col0=im2_col0,
                )
                return g, None

        grid, _ = jax.lax.scan(body, grid, xs)
        if pad_r or pad_c:
            grid = grid[: nby, : nbx]
        grid = subdivide(grid)
        cur >>= 1
        lam *= 2.0
    return grid


def _update_color_jacobi(
    im1_blocks: jnp.ndarray,  # (nby, nbx, bs, bs) i16
    im2: jnp.ndarray,
    grid: jnp.ndarray,
    gp: jnp.ndarray,          # (nby+3, nbx+3, 2)
    bs: int,
    lam_mult: jnp.ndarray,
    full_h: int,
    row0: jnp.ndarray,
    im2_row0: jnp.ndarray,
    cost: str = "sad",
    full_w: int | None = None,
    col0: jnp.ndarray | int = 0,
    im2_col0: jnp.ndarray | int = 0,
) -> jnp.ndarray:
    """Full-grid Jacobi update used inside the scheduled scan."""
    nby, nbx = grid.shape[:2]
    nby_total = full_h // bs
    full_w = nbx * bs if full_w is None else full_w
    nbx_total = full_w // bs
    row0_b = row0 // bs
    col0_b = jnp.asarray(col0, dtype=jnp.int32) // bs
    cands = jnp.stack(
        [gp[1 + dy : 1 + dy + nby, 1 + dx : 1 + dx + nbx] for dy, dx in SLOTS],
        axis=2,
    )
    kk = jnp.arange(nby, dtype=jnp.int32)[:, None]
    mm = jnp.arange(nbx, dtype=jnp.int32)[None, :]
    gi = row0_b + kk
    jj = col0_b + mm
    case = _border_case(gi, jj, nby_total, nbx_total)
    rank = jnp.asarray(_RANK_TABLE)[case]
    present = rank < _BIG_RANK
    for k, (dy, dx) in enumerate(SLOTS):
        ok = (
            (gi + dy >= 0) & (gi + dy < nby_total)
            & (jj + dx >= 0) & (jj + dx < nbx_total)
        )
        present = present.at[..., k].set(present[..., k] & ok)
    oy = (gi * bs) + jnp.zeros((nby, nbx), jnp.int32)
    ox = (jj * bs) + jnp.zeros((nby, nbx), jnp.int32)
    energy = _energies(
        im1_blocks, im2, cands, present, oy, ox, bs, lam_mult, full_h,
        im2_row0, cost, full_w=full_w, im2_col0=im2_col0,
    )
    winner = _select_lexicographic(energy, rank)
    return jnp.take_along_axis(cands, winner[..., None, None], axis=2)[:, :, 0]


@partial(jax.jit, static_argnames=("bs", "mode"))
def regularize_sweep(
    im1: jnp.ndarray,
    im2: jnp.ndarray,
    grid: jnp.ndarray,
    bs: int,
    lam: jnp.ndarray,
    mult: jnp.ndarray,
    mode: str = "fourcolor",
) -> jnp.ndarray:
    """One regularization sweep over the (nby, nbx, 2) MV grid (untiled)."""
    lam_mult = jnp.float32(lam) * jnp.float32(mult)
    nby, nbx = grid.shape[:2]
    full_h = im1.shape[0]
    zero = jnp.int32(0)
    if mode == "jacobi":
        return _update_subset(
            im1, im2, grid, bs, lam_mult, np.arange(nby), np.arange(nbx),
            full_h, zero, zero,
        )
    if mode == "fourcolor":
        for ci in (0, 1):
            for cj in (0, 1):
                iy = np.arange(ci, nby, 2)
                jx = np.arange(cj, nbx, 2)
                if len(iy) and len(jx):
                    grid = _update_subset(
                        im1, im2, grid, bs, lam_mult, iy, jx, full_h, zero, zero
                    )
        return grid
    if mode == "exact":
        return _regularize_exact(im1, im2, grid, bs, lam_mult)
    raise ValueError(f"unknown regularizer mode: {mode}")


def _regularize_exact(
    im1: jnp.ndarray,
    im2: jnp.ndarray,
    grid: jnp.ndarray,
    bs: int,
    lam_mult: jnp.ndarray,
) -> jnp.ndarray:
    """Sequential raster Gauss-Seidel, bit-exact with the in-place sweep (:616).

    lax.scan over blocks in raster order; the carry is the 1-padded grid so
    each step reads its already-updated west/north neighbors.  Whole-frame
    only (the raster order does not decompose across tiles).
    """
    nby, nbx = grid.shape[:2]
    h, w = im1.shape
    blocks = extract_blocks(im1, bs).astype(jnp.int16)  # (nblk, bs, bs)
    im2_i16 = im2.astype(jnp.int16)
    rank_table = jnp.asarray(_RANK_TABLE)
    slots = jnp.asarray(SLOTS, dtype=jnp.int32)  # (9, 2) as (dy, dx)

    def step(gp, k):
        i = k // nbx
        j = k % nbx
        # 3x3 candidate window around (i, j) in padded coords
        win = jax.lax.dynamic_slice(gp, (i, j, 0), (3, 3, 2))  # (3, 3, 2)
        cands = win[slots[:, 0] + 1, slots[:, 1] + 1]  # (9, 2) in slot order
        case = _border_case(i[None], j[None], nby, nbx)[0]
        rank = rank_table[case]  # (9,)
        present = rank < _BIG_RANK

        tx = j * bs + cands[:, 0].astype(jnp.int32)
        ty = i * bs + cands[:, 1].astype(jnp.int32)
        in_img = (tx >= 0) & (tx <= w - bs) & (ty >= 0) & (ty <= h - bs)
        src = blocks[k]

        def sad_one(y, x):
            tgt = jax.lax.dynamic_slice(im2_i16, (y, x), (bs, bs))
            return jnp.sum(jnp.abs(src - tgt), dtype=jnp.int32)

        sad = jax.vmap(sad_one)(jnp.clip(ty, 0, h - bs), jnp.clip(tx, 0, w - bs))

        pm = present.astype(jnp.float32)
        du = jnp.abs(cands[:, None, 0] - cands[None, :, 0])
        dv = jnp.abs(cands[:, None, 1] - cands[None, :, 1])
        smooth = jnp.sum((du + dv) * pm[None, :], axis=-1)
        energy = jnp.where(
            present & in_img, sad.astype(jnp.float32) + lam_mult * smooth, _F32_MAX
        )
        winner = _select_lexicographic(energy, rank)
        new_mv = cands[winner]
        gp = jax.lax.dynamic_update_slice(gp, new_mv[None, None], (i + 1, j + 1, 0))
        return gp, None

    gp0 = jnp.pad(grid, ((1, 1), (1, 1), (0, 0)), mode="edge")
    gp, _ = jax.lax.scan(step, gp0, jnp.arange(nby * nbx, dtype=jnp.int32))
    return gp[1:-1, 1:-1]
