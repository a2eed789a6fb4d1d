"""Window-reuse regularization schedule: the production path.

The reference's regularizer fetches an arbitrary (bs, bs) block of frame 2
per candidate (``motion_framework.cpp:594-602``) - a fine-grained block
gather in every color step of every round.  This module restructures the
whole per-level schedule around data the search already touches:

  * after the level's block search, ONE (ss, ss) frame-2 window per ORIGINAL
    block is gathered, centered on the block's search MV (the same shape the
    search itself used);
  * every candidate displacement is expressed as a DELTA from the parent
    block's search MV; candidates with |delta| <= R (default: the spiral
    extent S) read their cost from a per-round cost volume
    ``CV[delta, block]`` computed with UNIFORM window slices (one pooled
    volume per sub-block size, see ``_cost_volumes``);
  * per color step, each block's 9 candidate costs are read from CV at
    their delta indices, and the winner is the same lexicographic
    (energy, rank) minimum as the exact path.

Deviation from the reference (documented, EPE-validated in tests): a
candidate whose delta exceeds R is excluded (energy FLT_MAX) instead of
evaluated.  Since every update adopts an evaluated candidate, all MVs stay
within parent-MV +- R, so the window always covers every evaluated target.
When no candidate exceeds R the result is bit-identical to ``fourcolor``.

Rival windows (``rival_window=True``): the exclusion bites at motion
discontinuities, where a neighbor's (correct) MV differs from the parent's
window center by more than R and can never be adopted (measured as the
windowed-vs-fourcolor EPE gap on Urban2/Urban3).  Each parent then gathers a
SECOND window centered on its most-different 8-neighbor search MV (the local
"rival" motion mode), and a candidate is evaluable if it lands in either
window; costs agree wherever the windows overlap because both read the same
absolute frame-2 pixels.  At a two-motion discontinuity both modes are
addressable on every parent along it, so adoption waves propagate exactly as
in ``fourcolor``; junctions of 3+ motions degrade to the single-window
behavior.  The adopted-MV invariant becomes: MV in (base +- R) U (rival +- R).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from blockbasedmotionestimation.kernels.cost_volume import (
    cv_dtype,
    pooled_cost_volumes,
)
from blockbasedmotionestimation.ops import regularize as reg
from blockbasedmotionestimation.ops.search import _gather_windows
from blockbasedmotionestimation.ops.search import resolve_impl as _resolve_impl
from blockbasedmotionestimation.ops.spiral import spiral_extent, spiral_offsets

_F32_MAX = np.float32(np.finfo(np.float32).max)
_I32_MAX = np.int32(np.iinfo(np.int32).max)


def _pick_rival(
    vals: jnp.ndarray,
    base: jnp.ndarray,
    r: int,
    radius: int = 1,
    row_extend=None,
) -> jnp.ndarray:
    """Each parent's rival window center: the local foreign motion mode.

    vals: (npy, npx, 2) i32 integer search-winner MVs (the values neighbors
    will offer as candidates); base: (npy, npx, 2) i32 window-center MVs the
    primary in-window test rebases against.  Picks, per parent, the neighbor
    winner that COVERS the most neighbors excluded by the primary window
    (excluded: Linf(val_k - base) > r; covered: Linf(val_k - val_j) <= r) -
    i.e. the alternative center rescuing the most otherwise-unevaluable
    candidates.  A plain most-different pick fails when two wrong values
    straddle the base: it picks the wronger one and the true mode stays
    excluded.  Parents with no excluded neighbors keep base (a no-op rival).
    Ties resolve to the first neighbor in raster order.

    row_extend: optional hook adding ``radius`` parent rows of winners above
    and below (the tiled engine's cross-tile exchange, edge-replicated at
    global frame boundaries); default is plain edge replication.
    """
    npy, npx = vals.shape[:2]
    offs = [
        (dy, dx)
        for dy in range(-radius, radius + 1)
        for dx in range(-radius, radius + 1)
        if (dy, dx) != (0, 0)
    ]
    if row_extend is None:
        vp = jnp.pad(
            vals, ((radius, radius), (radius, radius), (0, 0)), mode="edge"
        )
    else:
        # tiled hook: must return vals extended by `radius` on BOTH axes
        # (neighbor-tile winners on tiled axes, edge replication at frame
        # boundaries and untiled axes)
        vp = row_extend(vals)
    neigh = jnp.stack(
        [
            vp[radius + dy : radius + dy + npy, radius + dx : radius + dx + npx]
            for dy, dx in offs
        ]
    )  # (K, npy, npx, 2)
    excl = jnp.abs(neigh - base[None]).max(axis=-1) > r  # (K, npy, npx)
    d = jnp.abs(neigh[:, None] - neigh[None, :]).max(axis=-1)  # (k, j, npy, npx)
    score = ((d <= r) & excl[:, None]).sum(axis=0)  # (j, npy, npx)
    j = jnp.argmax(score, axis=0)
    rival = jnp.take_along_axis(neigh, j[None, ..., None], axis=0)[0]
    return jnp.where((jnp.max(score, axis=0) > 0)[..., None], rival, base)


def _compute_cv(
    patches1: jnp.ndarray,  # (nPy, nPx, bs, bs) i16 frame-1 parent blocks
    windows: jnp.ndarray,   # (nPy, nPx, ss, ss) i16 frame-2 windows
    bs: int,
    cur: int,
    ext: int,
    r: int,
    cost: str,
) -> jnp.ndarray:
    """(side^2, nby, nbx) cost volume over deltas in [-R, R]^2 at size cur.

    The plain XLA form: one difference pass per size, a scan over deltas.
    """
    npy, npx = patches1.shape[:2]
    np_tot = npy * npx
    f = bs // cur
    side = 2 * r + 1
    dt = cv_dtype(cur, cost)

    # parent blocks on the minor dim, one scan step per delta with the
    # (bs, bs) window slice taken at a dynamic offset
    wside = windows.shape[3]
    patches_t = patches1.reshape(np_tot, bs, bs).transpose(1, 2, 0)  # (bs, bs, nP)
    windows_t = windows.reshape(np_tot, wside, wside).transpose(1, 2, 0)

    def step(_, off):
        dy, dx = off
        w = jax.lax.dynamic_slice(
            windows_t, (ext + dy - r, ext + dx - r, 0), (bs, bs, np_tot)
        )
        d = patches_t - w
        if cost == "zsad":
            # zero-mean SAD per (cur, cur) sub-block: subtract the block-mean
            # difference before the L1 sum (robust to gain/offset nuisance;
            # see ops.search.block_cost)
            dr = d.astype(jnp.float32).reshape(f, cur, f, cur, np_tot)
            m = jnp.mean(dr, axis=(1, 3), keepdims=True)
            return None, jnp.abs(dr - m).sum(axis=(1, 3)).astype(dt)
        if cost == "sad":
            dmap = jnp.abs(d).astype(jnp.int32)
        else:
            d32 = d.astype(jnp.int32)
            dmap = d32 * d32
        cvr = dmap.reshape(f, cur, f, cur, np_tot).sum(axis=(1, 3))
        return None, cvr.astype(dt)  # (f, f, nP)

    dys = jnp.repeat(jnp.arange(side, dtype=jnp.int32), side)
    dxs = jnp.tile(jnp.arange(side, dtype=jnp.int32), side)
    _, cv = jax.lax.scan(step, None, (dys, dxs))
    # (side^2, f(sub-row), f(sub-col), nP) -> (side^2, nby, nbx)
    cv = cv.reshape(side * side, f, f, npy, npx)
    cv = cv.transpose(0, 3, 1, 4, 2).reshape(side * side, npy * f, npx * f)
    return cv


def _cost_volumes(patches1, windows, bs, ext, r, cost, impl):
    """cur -> (side^2, nby, nbx) cost volume, for the sizes the rounds use.

    ``xla`` builds each size lazily with ``_compute_cv``; ``triton`` builds
    every size from one difference pass (``kernels.cost_volume``); ``auto``
    stages both and keeps the kernel where the program is compiled for a
    GPU and the XLA build elsewhere (``lax.platform_dependent``).
    """
    if impl == "xla":
        return lambda cur: _compute_cv(patches1, windows, bs, cur, ext, r, cost)

    def kernel(p, w):
        return pooled_cost_volumes(
            p, w, bs=bs, ext=ext, r=r, cost=cost,
            interpret=(impl == "triton_interpret"),
        )

    if impl == "auto":
        def plain(p, w):
            curs = [bs >> k for k in range(bs.bit_length() - 1)]
            return {c: _compute_cv(p, w, bs, c, ext, r, cost) for c in curs}

        vols = jax.lax.platform_dependent(
            patches1, windows, cuda=kernel, default=plain
        )
    else:
        vols = kernel(patches1, windows)
    return vols.__getitem__


def _select_costs(cv, ddy, ddx, r, m2, n2, lci, lcj):
    """(m, n, 9) f32 costs: one gather of the 9 candidate deltas per cell.

    cv: (side^2, 2*m2, 2*n2) volume of the whole round; the cells of color
    (lci, lcj) sit at rows lci::2 and columns lcj::2.  Keys outside [-R, R]
    are clipped (those candidates are masked as out-of-window downstream).
    """
    side = 2 * r + 1
    dkey = (
        jnp.clip(ddy + r, 0, side - 1) * side + jnp.clip(ddx + r, 0, side - 1)
    )  # (m, n, 9)
    rows = 2 * jnp.arange(m2, dtype=jnp.int32)[:, None, None] + lci
    cols = 2 * jnp.arange(n2, dtype=jnp.int32)[None, :, None] + lcj
    return cv[dkey, rows, cols].astype(jnp.float32)


def windowed_schedule(
    im1: jnp.ndarray,
    im2: jnp.ndarray,
    grid0: jnp.ndarray,  # (nPy, nPx, 2) the level's search output (integer MVs)
    bs: int,
    ss: int,
    lam0: float,
    sweeps_per_round: int,
    *,
    cost: str = "sad",
    reg_radius: int | None = None,
    full_h: int | None = None,
    row0: jnp.ndarray | int = 0,
    im2_row0: jnp.ndarray | int = 0,
    full_w: int | None = None,
    col0: jnp.ndarray | int = 0,
    im2_col0: jnp.ndarray | int = 0,
    make_gp=None,
    impl: str = "xla",
    rival: bool = False,
    rival_extend=None,
    rival_radius: int | None = None,
) -> jnp.ndarray:
    """The per-level regularization schedule on window-resident data.

    Same round structure as ``reg.run_schedule`` (sweeps with
    lambda_multiplier = sweep+1, subdivision, lambda doubling) with fourcolor
    ordering, evaluated against per-parent windows.  Returns the stride-1 MV
    grid.
    """
    ht, wt = im1.shape
    h = ht if full_h is None else full_h
    w = wt if full_w is None else full_w
    ext = spiral_extent(ss - bs)
    r = ext if reg_radius is None else min(reg_radius, ext)
    npy, npx = grid0.shape[:2]
    row0 = jnp.asarray(row0, dtype=jnp.int32)
    im2_row0 = jnp.asarray(im2_row0, dtype=jnp.int32)
    col0 = jnp.asarray(col0, dtype=jnp.int32)
    im2_col0 = jnp.asarray(im2_col0, dtype=jnp.int32)
    if make_gp is None:
        def make_gp(g):
            return jnp.pad(g, ((1, 2), (1, 2), (0, 0)))

    # one (ss, ss) window per parent, centered on origin + search MV
    parent_mv = grid0.astype(jnp.int32)  # integer-valued by construction
    oy = row0 + jnp.arange(npy, dtype=jnp.int32)[:, None] * bs
    ox = col0 + jnp.arange(npx, dtype=jnp.int32)[None, :] * bs
    wy = jnp.clip((oy + parent_mv[..., 1]) - im2_row0, 0, im2.shape[0] - bs)
    wx = jnp.clip(
        jnp.clip(ox + parent_mv[..., 0], 0, w - bs) - im2_col0,
        0, im2.shape[1] - bs,
    )
    windows = (
        _gather_windows(im2, wy.reshape(-1), wx.reshape(-1), bs, ext)
        .astype(jnp.int16)
        .reshape(npy, npx, bs + 2 * ext, bs + 2 * ext)
    )
    patches1 = (
        im1.reshape(npy, bs, npx, bs).transpose(0, 2, 1, 3).astype(jnp.int16)
    )
    impl = _resolve_impl(impl, cost)
    main_cv = _cost_volumes(patches1, windows, bs, ext, r, cost, impl)

    rival_cv = rbase = None
    r2 = r if rival_radius is None else min(rival_radius, r)
    if rival:
        rmv = _pick_rival(parent_mv, parent_mv, r, row_extend=rival_extend)
        rvy = jnp.clip((oy + rmv[..., 1]) - im2_row0, 0, im2.shape[0] - bs)
        rvx = jnp.clip(
            jnp.clip(ox + rmv[..., 0], 0, w - bs) - im2_col0,
            0, im2.shape[1] - bs,
        )
        rwindows = (
            _gather_windows(im2, rvy.reshape(-1), rvx.reshape(-1), bs, r2)
            .astype(jnp.int16)
            .reshape(npy, npx, bs + 2 * r2, bs + 2 * r2)
        )
        rbase = jnp.stack(
            [(rvx + im2_col0) - ox, (rvy + im2_row0) - oy], axis=-1
        )
        rival_cv = _cost_volumes(patches1, rwindows, bs, r2, r2, cost, impl)

    return _rounds_loop(
        grid0, parent_mv, bs, r, h, w, row0, col0, make_gp, lam0,
        sweeps_per_round, main_cv, rival_cv=rival_cv, rbase=rbase, r2=r2,
    )


def _rounds_loop(
    grid0: jnp.ndarray,
    parent_mv: jnp.ndarray,  # (npy, npx, 2) i32: the windows' center MVs
    bs: int,
    r: int,
    h: int,
    w: int,
    row0: jnp.ndarray,
    col0: jnp.ndarray,
    make_gp,
    lam0: float,
    sweeps_per_round: int,
    main_cv,
    rival_cv=None,
    rbase: jnp.ndarray | None = None,
    r2: int = 0,
) -> jnp.ndarray:
    """The subdivision rounds of the windowed schedule (see module docstring).

    Candidate deltas are rebased against ``parent_mv`` - whatever MV the
    windows were centered on (the search winner in ``windowed_schedule``, the
    truncated prediction in ``windowed_level``).  ``main_cv(cur)`` returns a
    round's (side^2, nby, nbx) volume.  With ``rival_cv``/``rbase`` (rival
    windows, see module docstring) a candidate outside the primary window is
    evaluated against the rival window when it lands there.
    """
    from blockbasedmotionestimation.models.engine import subdivide

    grid = grid0
    cur, lam = bs, lam0
    rank_table = jnp.asarray(reg._RANK_TABLE)
    while cur > 1:
        f = bs // cur
        nby, nbx = grid.shape[:2]
        cv = main_cv(cur)  # (side^2, nby, nbx)
        pm = jnp.repeat(jnp.repeat(parent_mv, f, axis=0), f, axis=1)  # (nby, nbx, 2)
        rcv = rpm = None
        if rival_cv is not None:
            rcv = rival_cv(cur)
            rpm = jnp.repeat(jnp.repeat(rbase, f, axis=0), f, axis=1)

        pad_r, pad_c = nby % 2, nbx % 2
        step_gp = make_gp
        if pad_r or pad_c:
            grid = jnp.pad(grid, ((0, pad_r), (0, pad_c), (0, 0)))
            cv = jnp.pad(cv, ((0, 0), (0, pad_r), (0, pad_c)))
            pm = jnp.pad(pm, ((0, pad_r), (0, pad_c), (0, 0)))
            if rcv is not None:
                rcv = jnp.pad(rcv, ((0, 0), (0, pad_r), (0, pad_c)))
                rpm = jnp.pad(rpm, ((0, pad_r), (0, pad_c), (0, 0)))

            def step_gp(g, _nby=nby, _nbx=nbx, _pr=pad_r, _pc=pad_c):
                # halo exchange must see only REAL rows (tiled mode)
                gp0 = make_gp(g[:_nby, :_nbx])
                return jnp.pad(gp0, ((0, _pr), (0, _pc), (0, 0)))

        nby2, nbx2 = grid.shape[:2]
        m2, n2 = nby2 // 2, nbx2 // 2
        nby_total = h // cur
        nbx_total = w // cur
        row0_b = row0 // cur
        col0_b = col0 // cur

        lam_steps, ci_steps, cj_steps = [], [], []
        for sweep in range(sweeps_per_round):
            for ci, cj in ((0, 0), (0, 1), (1, 0), (1, 1)):
                lam_steps.append(lam * (sweep + 1))
                ci_steps.append(ci)
                cj_steps.append(cj)
        xs = (
            jnp.asarray(lam_steps, dtype=jnp.float32),
            jnp.asarray(ci_steps, dtype=jnp.int32),
            jnp.asarray(cj_steps, dtype=jnp.int32),
        )

        def body(g, x, cur=cur, nby2=nby2, nbx2=nbx2, m2=m2, n2=n2,
                 nby_total=nby_total, nbx_total=nbx_total, row0_b=row0_b,
                 col0_b=col0_b, cv=cv, pm=pm, rcv=rcv, rpm=rpm):
            lam_mult, ci, cj = x
            # local offsets of GLOBAL color (ci, cj) (odd-first-row/col tiles)
            lci = (ci + row0_b) % 2
            lcj = (cj + col0_b) % 2
            gp = step_gp(g)

            def slab2(arr):
                # stride-2 view rows lci::2, cols lcj::2 of an (nby2, nbx2, 2)
                rsh = arr.reshape(m2, 2, n2, 2, 2)
                rsh = jax.lax.dynamic_index_in_dim(rsh, lci, axis=1, keepdims=False)
                return jax.lax.dynamic_index_in_dim(rsh, lcj, axis=2, keepdims=False)

            cands = []
            for dy, dx in reg.SLOTS:
                sub = jax.lax.dynamic_slice(
                    gp, (lci + dy + 1, lcj + dx + 1, 0), (nby2, nbx2, 2)
                )
                cands.append(
                    sub.reshape(nby2 // 2, 2, nbx2 // 2, 2, 2)[:, 0, :, 0]
                )
            cands = jnp.stack(cands, axis=2)  # (m2, n2, 9, 2)

            kk = jnp.arange(m2, dtype=jnp.int32)[:, None]
            mm = jnp.arange(n2, dtype=jnp.int32)[None, :]
            gi = row0_b + lci + 2 * kk  # global rows of parity ci
            jj = col0_b + lcj + 2 * mm  # global cols of parity cj
            # TRUE global grid extents (padded local nbx2 would misclassify
            # the frame's last real column as interior)
            case = reg._border_case(gi, jj, nby_total, nbx_total)
            rank = rank_table[case]
            present = rank < reg._BIG_RANK
            for k, (dy, dx) in enumerate(reg.SLOTS):
                okk = (
                    (gi + dy >= 0) & (gi + dy < nby_total)
                    & (jj + dx >= 0) & (jj + dx < nbx_total)
                )
                present = present.at[..., k].set(present[..., k] & okk)

            # candidate deltas from the parent search MV
            ci_int = cands.astype(jnp.int32)  # trunc toward zero
            pm_slab = slab2(pm)  # (m2, n2, 2)
            ddx = ci_int[..., 0] - pm_slab[..., None, 0]  # (m2, n2, 9)
            ddy = ci_int[..., 1] - pm_slab[..., None, 1]
            in_window = (jnp.abs(ddx) <= r) & (jnp.abs(ddy) <= r)
            # global image bounds for the target block (:578-582)
            t_x = (jj * cur)[..., None] + ci_int[..., 0]
            t_y = (gi * cur)[..., None] + ci_int[..., 1]
            in_img = (t_x >= 0) & (t_x <= w - cur) & (t_y >= 0) & (t_y <= h - cur)

            costs = _select_costs(cv, ddy, ddx, r, m2, n2, lci, lcj)
            if rcv is not None:
                # rival-window fallback: same absolute frame-2 pixels, so the
                # cost agrees with the primary window wherever both cover
                rpm_slab = slab2(rpm)
                rddx = ci_int[..., 0] - rpm_slab[..., None, 0]
                rddy = ci_int[..., 1] - rpm_slab[..., None, 1]
                in_rival = (jnp.abs(rddx) <= r2) & (jnp.abs(rddy) <= r2)
                rcosts = _select_costs(rcv, rddy, rddx, r2, m2, n2, lci, lcj)
                costs = jnp.where(in_window, costs, rcosts)
                in_window = in_window | in_rival

            pmask = present.astype(jnp.float32)
            du = jnp.abs(cands[..., None, 0] - cands[..., None, :, 0])
            dv = jnp.abs(cands[..., None, 1] - cands[..., None, :, 1])
            smooth = jnp.sum((du + dv) * pmask[..., None, :], axis=-1)

            energy = jnp.where(
                present & in_img & in_window, costs + lam_mult * smooth, _F32_MAX
            )
            winner = reg._select_lexicographic(energy, rank)
            new_mv = jnp.take_along_axis(cands, winner[..., None, None], axis=2)[:, :, 0]

            gr = g.reshape(m2, 2, n2, 2, 2)
            gr = jax.lax.dynamic_update_slice(
                gr, new_mv[:, None, :, None, :], (0, lci, 0, lcj, 0)
            )
            return gr.reshape(nby2, nbx2, 2), None

        grid, _ = jax.lax.scan(body, grid, xs)
        if pad_r or pad_c:
            grid = grid[:nby, :nbx]
        grid = subdivide(grid)
        cur >>= 1
        lam *= 2.0
    return grid


def windowed_level(
    im1: jnp.ndarray,
    im2: jnp.ndarray,
    pred: jnp.ndarray,  # (nPy, nPx, 2) f32 predicted MVs at block origins
    bs: int,
    ss: int,
    lam0: float,
    sweeps_per_round: int,
    *,
    cost: str = "sad",
    full_h: int | None = None,
    row0: jnp.ndarray | int = 0,
    im2_row0: jnp.ndarray | int = 0,
    full_w: int | None = None,
    col0: jnp.ndarray | int = 0,
    im2_col0: jnp.ndarray | int = 0,
    make_gp=None,
    impl: str = "xla",
    rival: bool = False,
    rival_extend=None,
    rival_radius: int | None = None,
) -> jnp.ndarray:
    """Fused block search + windowed regularization from ONE cost volume.

    ``windowed_schedule`` centers its windows on the search winner, so each
    level pays for two full (2S+1)^2 SAD volumes over near-identical windows:
    one inside the spiral search (``motion_framework.cpp:296-422``), one for
    the regularizer's cost volume.  Centering the windows on the TRUNCATED
    PREDICTION instead - the exact center the spiral search walks around
    (``:233-234``) - lets a single pooled cost-volume pass serve both:

      * the search winner is the lexicographic (cost, spiral-visit-rank)
        minimum of the full-block (cur == bs) volume, masked by the global
        in-image bounds - BIT-IDENTICAL to ``ops.search.block_search_level``
        (same windows, same costs, same tie-break);
      * the regularization rounds read the same pooled volumes with candidate
        deltas rebased against the prediction.

    Deviation from ``windowed_schedule`` (measured, see DESIGN.md): a
    candidate is evaluable iff it lands within the PREDICTION-centered window
    (|cand - trunc(pred)| <= S) rather than within reg_radius of the search
    winner.  Both windows have half-width S and the search winner always lies
    inside the prediction window, so the two sets overlap heavily; updates
    still only ever adopt evaluated candidates.  ``reg_radius`` is not
    supported here (the single shared window fixes the radius at S) - the
    engine falls back to the two-pass path when it is set.

    Returns the stride-1 MV grid, like ``windowed_schedule``.
    """
    ht, wt = im1.shape
    h = ht if full_h is None else full_h
    w = wt if full_w is None else full_w
    shift = ss - bs
    dys_np, dxs_np, ext = spiral_offsets(shift)
    side = 2 * ext + 1
    npy, npx = pred.shape[:2]
    nblk = npy * npx
    row0 = jnp.asarray(row0, dtype=jnp.int32)
    im2_row0 = jnp.asarray(im2_row0, dtype=jnp.int32)
    col0 = jnp.asarray(col0, dtype=jnp.int32)
    im2_col0 = jnp.asarray(im2_col0, dtype=jnp.int32)
    if make_gp is None:
        def make_gp(g):
            return jnp.pad(g, ((1, 2), (1, 2), (0, 0)))

    # the spiral search's center: origin + (int)-truncated prediction, with
    # the zero-MV early-out for centers outside the image (:304-310)
    oy = row0 + jnp.arange(npy, dtype=jnp.int32)[:, None] * bs
    ox = col0 + jnp.arange(npx, dtype=jnp.int32)[None, :] * bs
    cu = pred[..., 0].astype(jnp.int32)
    cv_ = pred[..., 1].astype(jnp.int32)
    cy = oy + cv_
    cx = ox + cu
    center_ok = (cy >= 0) & (cy <= h - bs) & (cx >= 0) & (cx <= w - bs)
    cy_safe = jnp.where(center_ok, cy, jnp.broadcast_to(oy, (npy, npx)))
    cx_safe = jnp.where(center_ok, cx, jnp.broadcast_to(ox, (npy, npx)))

    by = jnp.clip(cy_safe - im2_row0, 0, im2.shape[0] - bs)
    bx = jnp.clip(cx_safe - im2_col0, 0, im2.shape[1] - bs)
    windows = (
        _gather_windows(im2, by.reshape(-1), bx.reshape(-1), bs, ext)
        .astype(jnp.int16)
        .reshape(npy, npx, bs + 2 * ext, bs + 2 * ext)
    )
    patches1 = (
        im1.reshape(npy, bs, npx, bs).transpose(0, 2, 1, 3).astype(jnp.int16)
    )
    # the windows' actual global center MV: deltas downstream rebase on this
    base_mv = jnp.stack(
        [(bx + im2_col0) - ox, (by + im2_row0) - oy], axis=-1
    )

    impl = _resolve_impl(impl, cost)
    main_cv = _cost_volumes(patches1, windows, bs, ext, ext, cost, impl)
    sad_flat = main_cv(bs).reshape(side * side, nblk).astype(
        jnp.float32 if cost == "zsad" else jnp.int32
    )

    # spiral argmin over the volume: strict-< first-visit-wins == two-stage
    # (min cost, then min spiral-visit order among cost ties)
    didx = jnp.arange(side * side, dtype=jnp.int32)
    dy_of = didx // side - ext
    dx_of = didx % side - ext
    ty = cy_safe.reshape(nblk)[None, :] + dy_of[:, None]
    tx = cx_safe.reshape(nblk)[None, :] + dx_of[:, None]
    ok = (ty >= 0) & (ty <= h - bs) & (tx >= 0) & (tx <= w - bs)
    sad_m = jnp.where(ok, sad_flat, _I32_MAX)
    order = np.full((side, side), np.iinfo(np.int32).max, dtype=np.int32)
    order[dys_np + ext, dxs_np + ext] = np.arange(side * side, dtype=np.int32)
    best_sad = jnp.min(sad_m, axis=0)
    rank_m = jnp.where(
        sad_m == best_sad[None, :],
        jnp.asarray(order.reshape(-1))[:, None],
        np.iinfo(np.int32).max,
    )
    oi = jnp.min(rank_m, axis=0)  # winning spiral-visit index (center valid)
    best_dy = jnp.asarray(dys_np)[oi].reshape(npy, npx)
    best_dx = jnp.asarray(dxs_np)[oi].reshape(npy, npx)
    u = jnp.where(center_ok, (cx_safe + best_dx - ox).astype(jnp.float32), 0.0)
    v = jnp.where(center_ok, (cy_safe + best_dy - oy).astype(jnp.float32), 0.0)
    grid0 = jnp.stack([u, v], axis=-1)

    rival_cv = rbase = None
    r2 = ext if rival_radius is None else min(rival_radius, ext)
    if rival:
        # rival centers from the SEARCH WINNERS (not the smooth prediction):
        # at a discontinuity the winner snaps to the true local motion, so
        # the most-different neighbor winner is the foreign motion mode
        rmv = _pick_rival(
            grid0.astype(jnp.int32), base_mv, ext, row_extend=rival_extend
        )
        rvy = jnp.clip((oy + rmv[..., 1]) - im2_row0, 0, im2.shape[0] - bs)
        rvx = jnp.clip(
            jnp.clip(ox + rmv[..., 0], 0, w - bs) - im2_col0,
            0, im2.shape[1] - bs,
        )
        rwindows = (
            _gather_windows(im2, rvy.reshape(-1), rvx.reshape(-1), bs, r2)
            .astype(jnp.int16)
            .reshape(npy, npx, bs + 2 * r2, bs + 2 * r2)
        )
        rbase = jnp.stack(
            [(rvx + im2_col0) - ox, (rvy + im2_row0) - oy], axis=-1
        )
        rival_cv = _cost_volumes(patches1, rwindows, bs, r2, r2, cost, impl)

    return _rounds_loop(
        grid0, base_mv, bs, ext, h, w, row0, col0, make_gp, lam0,
        sweeps_per_round, main_cv, rival_cv=rival_cv, rbase=rbase, r2=r2,
    )
