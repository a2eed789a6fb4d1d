"""Multi-device execution: frame tiling with halo exchange + frame-pair batching.

The reference's only intra-frame parallelism is a disabled 2-thread
left/right column split sharing one address space (``parallel.h:20-58``).
Here the frame's ROWS shard across a mesh axis of devices (GPUs joined all
to all by NVLink), which exchange exactly the data the algorithm needs
across tile boundaries:

  * frame-2 pixel halos for the block search: a tile's predicted centers can
    sit at most ``M_(l+1)*2`` rows outside the tile and the spiral reaches
    ``S_l`` further, so the halo per level is the worst-case MV bound
    ``M_l = 2*M_(l+1) + S_l`` (``M`` at the coarsest level = its search
    shift).  Exchanged ONCE per level via ``jax.lax.ppermute``.
  * a 1-block-row MV halo for the 8-connected regularizer, refreshed before
    every color step (``jax.lax.ppermute`` again) - the ring-exchange
    analogue of sequence-parallel boundary passing.

Because every bounds check in ops.search / ops.regularize uses GLOBAL
coordinates, the tiled fourcolor/jacobi pipeline is bit-identical to its
untiled counterpart - asserted by tests on a forced-8-device CPU mesh.

Levels whose rows don't split into block-aligned strips, or whose halo
exceeds the strip, run replicated on every device - coarse pyramid levels
are tiny, so this costs nothing.  (Odd local block-row counts shard fine:
color steps use per-tile parity offsets.)

Batching: ``estimate_flow_batch`` vmaps the engine over a leading batch axis
and shards it over the mesh's data axis; combined with row tiling this gives
the (batch x tile) layout for multi-host runs (batch across hosts, halos
over NVLink within a host).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from blockbasedmotionestimation.config import MotionConfig
from blockbasedmotionestimation.models import engine
from blockbasedmotionestimation.ops import pad as pad_ops
from blockbasedmotionestimation.ops import resample
from blockbasedmotionestimation.ops import regularize as reg
from blockbasedmotionestimation.ops.search import block_search_level


def mv_bound(cfg: MotionConfig, level: int) -> int:
    """Worst-case |MV| component at `level` after its search: the propagated
    coarse MV doubles per level and each search adds its spiral extent.
    Gather-mode regularization only adopts existing candidates (no growth);
    windowed mode can push an MV up to reg_radius past its parent search MV
    per level, so the bound grows by R_l there.  With ``cfg.mv_cap`` the
    transferred prediction is clamped, so the compounding stops at the cap
    (making the halo small enough to shard 1080p rows 8 ways at the shipped
    config instead of falling back to replicated execution)."""
    from blockbasedmotionestimation.ops.spiral import spiral_extent

    m = 0  # max |MV| after the coarser level completes
    for l in range(cfg.num_levels - 1, level - 1, -1):
        s = spiral_extent(cfg.shift(l))
        pred = 2 * m  # the transferred prediction at level l
        if cfg.mv_cap is not None:
            pred = min(pred, cfg.mv_cap)
        m = pred + s  # search reach at level l
        if cfg.regularizer == "windowed" and l > level:
            r = s if cfg.reg_radius is None else min(cfg.reg_radius, s)
            m += r
    return m


def im2_halo(cfg: MotionConfig, level: int) -> int:
    """Frame-2 halo rows needed at `level`: the search-window reach, plus the
    regularizer windows' extra spiral-extent reach in windowed mode."""
    from blockbasedmotionestimation.ops.spiral import spiral_extent

    s = spiral_extent(cfg.shift(level))
    halo = mv_bound(cfg, level)
    if cfg.regularizer == "windowed":
        halo += s
    return halo


def _exchange_rows(x: jnp.ndarray, halo: int, axis: str) -> jnp.ndarray:
    """Concatenate `halo` rows from the north and south neighbors onto x.

    Boundary devices receive zero rows; every position that could read them is
    masked out by the global bounds checks downstream.
    """
    if halo == 0:
        return x
    t = jax.lax.axis_size(axis)
    south_edge = x[-halo:]
    north_edge = x[:halo]
    from_north = jax.lax.ppermute(
        south_edge, axis, [(i, i + 1) for i in range(t - 1)]
    )
    from_south = jax.lax.ppermute(
        north_edge, axis, [(i, i - 1) for i in range(1, t)]
    )
    return jnp.concatenate([from_north, x, from_south], axis=0)


def _exchange_rows_edge(x: jnp.ndarray, axis: str) -> jnp.ndarray:
    """1-row neighbor exchange, edge-REPLICATED at mesh boundaries.

    Matches the untiled engine's ``jnp.pad(..., mode='edge')`` semantics for
    the rival-window pick: interior tile edges come from the neighbor tile,
    the global frame's first/last rows replicate themselves.
    """
    t = jax.lax.axis_size(axis)
    idx = jax.lax.axis_index(axis)
    from_north = jax.lax.ppermute(x[-1:], axis, [(i, i + 1) for i in range(t - 1)])
    from_south = jax.lax.ppermute(x[:1], axis, [(i, i - 1) for i in range(1, t)])
    north = jnp.where(idx == 0, x[:1], from_north)
    south = jnp.where(idx == t - 1, x[-1:], from_south)
    return jnp.concatenate([north, x, south], axis=0)


def _exchange_cols(x: jnp.ndarray, halo: int, axis: str) -> jnp.ndarray:
    """Column analogue of ``_exchange_rows`` (west/east neighbor halos)."""
    if halo == 0:
        return x
    t = jax.lax.axis_size(axis)
    east_edge = x[:, -halo:]
    west_edge = x[:, :halo]
    from_west = jax.lax.ppermute(
        east_edge, axis, [(i, i + 1) for i in range(t - 1)]
    )
    from_east = jax.lax.ppermute(
        west_edge, axis, [(i, i - 1) for i in range(1, t)]
    )
    return jnp.concatenate([from_west, x, from_east], axis=1)


def _exchange_cols_edge(x: jnp.ndarray, axis: str) -> jnp.ndarray:
    """1-column neighbor exchange, edge-replicated at mesh boundaries."""
    t = jax.lax.axis_size(axis)
    idx = jax.lax.axis_index(axis)
    from_west = jax.lax.ppermute(
        x[:, -1:], axis, [(i, i + 1) for i in range(t - 1)]
    )
    from_east = jax.lax.ppermute(
        x[:, :1], axis, [(i, i - 1) for i in range(1, t)]
    )
    west = jnp.where(idx == 0, x[:, :1], from_west)
    east = jnp.where(idx == t - 1, x[:, -1:], from_east)
    return jnp.concatenate([west, x, east], axis=1)


def _tiled_level_fn_2d(
    bs: int, ss: int, cfg: MotionConfig, full_h: int, full_w: int,
    halo: int, axis: str, axis_x: str, level: int = 0,
):
    """Per-device level body for 2-D (ty x tx) spatial tiling.

    The reference's own split is by COLUMNS (``parallel.h:20-58``); this
    composes both axes: frame-2 pixel halos and the 1-block MV ring are
    exchanged row-wise then column-wise (the column pass of the row-extended
    buffer carries the corner data from diagonal neighbors).
    """

    def body(im1_t: jnp.ndarray, im2_t: jnp.ndarray, pred_t: jnp.ndarray) -> jnp.ndarray:
        ht, wt = im1_t.shape
        row0 = jax.lax.axis_index(axis).astype(jnp.int32) * ht
        col0 = jax.lax.axis_index(axis_x).astype(jnp.int32) * wt
        im2_buf = _exchange_cols(_exchange_rows(im2_t, halo, axis), halo, axis_x)
        im2_row0 = row0 - halo
        im2_col0 = col0 - halo

        def make_gp(g):
            # 1-block MV ring: rows then columns (corners via composition)
            gh = _exchange_cols(_exchange_rows(g, 1, axis), 1, axis_x)
            return jnp.pad(gh, ((0, 1), (0, 1), (0, 0)))

        def rival_extend(g):
            return _exchange_cols_edge(_exchange_rows_edge(g, axis), axis_x)

        if cfg.uses_fused_windowed:
            from blockbasedmotionestimation.ops.windowed import windowed_level

            return windowed_level(
                im1_t, im2_buf, pred_t, bs, ss,
                float(bs) * cfg.lambda_scale, cfg.sweeps_per_round,
                cost=cfg.cost, full_h=full_h, row0=row0, im2_row0=im2_row0,
                full_w=full_w, col0=col0, im2_col0=im2_col0,
                make_gp=make_gp, impl=cfg.search_impl,
                rival=cfg.rival_window, rival_extend=rival_extend,
                rival_radius=cfg.rival_radius_at(level),
            )

        grid = block_search_level(
            im1_t, im2_buf, pred_t, bs, ss,
            full_h=full_h, row0=row0, im2_row0=im2_row0,
            full_w=full_w, col0=col0, im2_col0=im2_col0,
            order=cfg.search_order, cost=cfg.cost,
        )

        lam0 = float(bs) * cfg.lambda_scale
        if cfg.regularizer == "windowed":
            from blockbasedmotionestimation.ops.windowed import windowed_schedule

            return windowed_schedule(
                im1_t, im2_buf, grid, bs, ss, lam0, cfg.sweeps_per_round,
                cost=cfg.cost, reg_radius=cfg.reg_radius,
                full_h=full_h, row0=row0, im2_row0=im2_row0,
                full_w=full_w, col0=col0, im2_col0=im2_col0,
                make_gp=make_gp, impl=cfg.search_impl,
                rival=cfg.rival_window, rival_extend=rival_extend,
                rival_radius=cfg.rival_radius_at(level),
            )
        return reg.run_schedule(
            im1_t, im2_buf, grid, bs, lam0, cfg.sweeps_per_round, cfg.regularizer,
            full_h=full_h, row0=row0, im2_row0=im2_row0,
            full_w=full_w, col0=col0, im2_col0=im2_col0,
            make_gp=make_gp, cost=cfg.cost,
        )

    return body


def _tiled_level_fn(
    bs: int, ss: int, cfg: MotionConfig, full_h: int, halo: int, axis: str,
    level: int = 0,
):
    """Builds the per-device level body (search + regularization schedule)."""

    def body(im1_t: jnp.ndarray, im2_t: jnp.ndarray, pred_t: jnp.ndarray) -> jnp.ndarray:
        ht = im1_t.shape[0]
        row0 = jax.lax.axis_index(axis).astype(jnp.int32) * ht
        im2_buf = _exchange_rows(im2_t, halo, axis)
        im2_row0 = row0 - halo

        def make_gp(g):
            # refresh the 1-block-row MV halo before each color step
            gh = _exchange_rows(g, 1, axis)  # (north, local, south) rows
            return jnp.pad(gh, ((0, 1), (1, 2), (0, 0)))

        def rival_extend(g):
            # rows from neighbor tiles; columns are untiled here -> edge pad
            gr = _exchange_rows_edge(g, axis)
            return jnp.pad(gr, ((0, 0), (1, 1), (0, 0)), mode="edge")

        if cfg.uses_fused_windowed:
            from blockbasedmotionestimation.ops.windowed import windowed_level

            return windowed_level(
                im1_t, im2_buf, pred_t, bs, ss,
                float(bs) * cfg.lambda_scale, cfg.sweeps_per_round,
                cost=cfg.cost, full_h=full_h, row0=row0, im2_row0=im2_row0,
                make_gp=make_gp, impl=cfg.search_impl,
                rival=cfg.rival_window, rival_extend=rival_extend,
                rival_radius=cfg.rival_radius_at(level),
            )

        grid = block_search_level(
            im1_t, im2_buf, pred_t, bs, ss,
            full_h=full_h, row0=row0, im2_row0=im2_row0,
            order=cfg.search_order, cost=cfg.cost,
        )

        lam0 = float(bs) * cfg.lambda_scale
        if cfg.regularizer == "windowed":
            from blockbasedmotionestimation.ops.windowed import windowed_schedule

            return windowed_schedule(
                im1_t, im2_buf, grid, bs, ss, lam0, cfg.sweeps_per_round,
                cost=cfg.cost, reg_radius=cfg.reg_radius,
                full_h=full_h, row0=row0, im2_row0=im2_row0, make_gp=make_gp,
                impl=cfg.search_impl,
                rival=cfg.rival_window, rival_extend=rival_extend,
                rival_radius=cfg.rival_radius_at(level),
            )
        return reg.run_schedule(
            im1_t, im2_buf, grid, bs, lam0, cfg.sweeps_per_round, cfg.regularizer,
            full_h=full_h, row0=row0, im2_row0=im2_row0, make_gp=make_gp,
            cost=cfg.cost,
        )

    return body


def _level_shardable(h: int, w: int, bs: int, t: int) -> bool:
    """Rows must tile evenly into block-aligned strips.

    Odd local block-row counts are fine: the color steps index each tile's
    local rows with a per-tile parity offset ``(ci + row0_b) % 2``, so
    global == local color alignment no longer constrains the strip height
    (r2 required an even count, which padded 1080p/8-way from 1280 to 1536
    rows - a +20% level-0 tax)."""
    return h % (t * bs) == 0


def plan_tiling(
    cfg: MotionConfig,
    padded_h: int,
    padded_w: int,
    t: int,
    tx: int = 1,
) -> list[dict]:
    """Per-level shardability report for pre-padded (padded_h, padded_w)
    frames on a (t row-tiles x tx col-tiles) spatial mesh.

    Each entry: {level, h, w, bs, halo, strip_h, strip_w, rows_ok, cols_ok} -
    exactly the predicate ``estimate_flow_padded_tiled`` evaluates, exposed
    so callers (and ``derive_mv_cap``) can see WHY a level replicates."""
    out = []
    h, w = padded_h, padded_w
    dims = []
    for level in range(cfg.num_levels):
        dims.append((h, w))
        h, w = h // 2, w // 2  # pyrdown_u8 halves (dims stay even by padding)
    for level, (h, w) in enumerate(dims):
        bs = cfg.block_sizes[level]
        halo = im2_halo(cfg, level)
        rows_ok = _level_shardable(h, w, bs, t) and halo < h // t
        cols_ok = tx > 1 and _level_shardable(w, h, bs, tx) and halo < w // tx
        out.append(
            dict(
                level=level, h=h, w=w, bs=bs, halo=halo,
                strip_h=h // t, strip_w=(w // tx if tx > 1 else w),
                rows_ok=rows_ok, cols_ok=cols_ok,
            )
        )
    return out


def derive_mv_cap(
    cfg: MotionConfig, orig_h: int, orig_w: int, t: int, tx: int = 1
) -> int | None:
    """Largest ``mv_cap`` that lets the FINEST level shard into ``t`` row
    strips (and ``tx`` column strips when > 1) at the tile-aware padding.

    The uncapped worst-case MV bound compounds per level
    (``mv_bound``: 464 rows at the shipped config) and exceeds any
    1080p/8-way strip, so out-of-box row tiling silently replicates every
    level; a cap bounds the halo at ~cap + 2*S.  The cap is a MODELING
    choice (like a codec's search range): MVs larger than it are clamped at
    cross-level transfer, identically in the tiled and untiled engines.
    Returns None when the uncapped halo already fits (no cap needed);
    raises ValueError when even the smallest legal cap cannot fit (fewer
    tiles, or bigger frames, are required).
    """
    p = pad_ops.compute_padding(orig_h, orig_w, cfg, row_tiles=t)
    strip = p.padded_h // t
    if tx > 1:
        strip = min(strip, p.padded_w // tx)

    def fits(cap: int | None) -> bool:
        return im2_halo(cfg.replace(mv_cap=cap), 0) < strip

    if fits(None):
        return None
    cap_min = max(
        ss - bs for bs, ss in zip(cfg.block_sizes, cfg.search_sizes)
    )  # the config floor: the coarsest search itself produces such MVs
    if not fits(cap_min):
        raise ValueError(
            f"even mv_cap={cap_min} needs a {im2_halo(cfg.replace(mv_cap=cap_min), 0)}-row "
            f"halo but strips are only {strip} rows: {t}x{tx} tiles cannot "
            f"shard a {orig_h}x{orig_w} frame under this config; use fewer "
            "tiles or rely on batch parallelism"
        )
    lo, hi = cap_min, max(cap_min + 1, im2_halo(cfg.replace(mv_cap=None), 0))
    while lo + 1 < hi:  # fits(lo), not fits(hi)
        mid = (lo + hi) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid
    return lo


def _warn_if_fully_replicated(
    cfg: MotionConfig, h: int, w: int, t: int, tx: int
) -> None:
    """Loudly flag the silent t-times-redundant case (every level falls back
    to replicated execution, so 'tiling' computes the whole frame on every
    device).  Emitted at trace time, once per compiled (shape, config)."""
    plan = plan_tiling(cfg, h, w, t, tx)
    if any(e["rows_ok"] or e["cols_ok"] for e in plan):
        return
    import warnings

    e0 = plan[0]
    if e0["halo"] >= e0["strip_h"]:
        try:
            cap = derive_mv_cap(cfg, h, w, t, tx)
            hint = (
                f"set mv_cap (derive_mv_cap suggests {cap}) and pad with "
                "compute_padding(..., row_tiles=t), or use "
                "estimate_flow_tiled_auto"
            )
        except ValueError as err:
            hint = str(err)
    else:
        hint = (
            "pad with compute_padding(..., row_tiles=t) so strips are "
            "block-aligned, or use estimate_flow_tiled_auto"
        )
    warnings.warn(
        f"estimate_flow_padded_tiled: NO pyramid level shards on the "
        f"{t}x{tx} spatial mesh ({h}x{w} frame, level-0 halo {e0['halo']} "
        f"rows vs {e0['strip_h']}-row strips) - every level will run "
        f"REPLICATED on all devices ({t * tx}x redundant work); {hint}",
        stacklevel=3,
    )


def estimate_flow_tiled_auto(
    im1: jnp.ndarray,
    im2: jnp.ndarray,
    cfg: MotionConfig,
    mesh: Mesh,
    axis: str = "ty",
    axis_x: str | None = None,
) -> jnp.ndarray:
    """Out-of-box spatial tiling on UNPADDED frames: derives everything
    ``estimate_flow_padded_tiled`` needs from the mesh and frame size.

    * pads with ``row_tiles = mesh.shape[axis]`` so strips are block-aligned;
    * if ``cfg.mv_cap`` is unset and the uncapped halo cannot fit a strip,
      applies ``derive_mv_cap`` (the largest cap that lets level 0 shard) -
      an explicit user-set cap is always respected;
    * raises (rather than silently replicating) when no cap can make the
      finest level shard.

    The reference's own column split needs no user tuning
    (``parallel.h:20-58``); this is the multi-device equivalent.  Returns (H, W, 2)
    flow cropped to the original frame (MVs in PROCESSED pixel units, as
    with ``estimate_flow_padded``).
    """
    h, w = im1.shape
    t = mesh.shape[axis]
    tx = mesh.shape[axis_x] if axis_x is not None else 1
    run_cfg = cfg
    if cfg.mv_cap is None:
        cap = derive_mv_cap(cfg, h, w, t, tx)  # None = no cap needed
        if cap is not None:
            run_cfg = cfg.replace(mv_cap=cap)
    p = pad_ops.compute_padding(h, w, run_cfg, row_tiles=t)
    im1p = pad_ops.pad_frame(im1, p)
    im2p = pad_ops.pad_frame(im2, p)
    flow = estimate_flow_padded_tiled(im1p, im2p, run_cfg, mesh, axis, axis_x)
    return flow[p.pad_y : p.pad_y + h, p.pad_x : p.pad_x + w]


@functools.partial(jax.jit, static_argnames=("cfg", "mesh", "axis", "axis_x"))
def estimate_flow_padded_tiled(
    im1p: jnp.ndarray,
    im2p: jnp.ndarray,
    cfg: MotionConfig,
    mesh: Mesh,
    axis: str = "ty",
    axis_x: str | None = None,
) -> jnp.ndarray:
    """Spatially tiled, halo-exchanged engine on pre-padded frames.

    Rows shard over ``axis``; with ``axis_x`` set, columns also shard over
    that mesh axis (2-D ty x tx tiling - the reference's own parallel split
    is by columns, ``parallel.h:20-58``).  Bit-identical to
    ``engine.estimate_flow_padded`` in fourcolor/jacobi/windowed modes.
    "exact" (whole-frame raster Gauss-Seidel) does not decompose across
    tiles and is rejected explicitly rather than silently degraded.
    Returns the dense (H', W', 2) flow, sharded over the spatial axes.
    """
    if cfg.regularizer == "exact":
        raise ValueError(
            "regularizer='exact' is a whole-frame raster sweep and cannot be "
            "row-tiled; use estimate_flow_padded, or fourcolor/windowed here"
        )
    t = mesh.shape[axis]
    tx = mesh.shape[axis_x] if axis_x is not None else 1
    _warn_if_fully_replicated(cfg, im1p.shape[0], im1p.shape[1], t, tx)
    levels = cfg.num_levels
    pyr1 = resample.build_pyramid(im1p, levels)
    pyr2 = resample.build_pyramid(im2p, levels)

    dense = None
    for level in range(levels - 1, -1, -1):
        im1, im2 = pyr1[level], pyr2[level]
        h, w = im1.shape
        bs, ss = cfg.block_sizes[level], cfg.search_sizes[level]
        if dense is None:
            pred = jnp.zeros((h // bs, w // bs, 2), dtype=jnp.float32)
        else:
            pred = engine.transfer_mvs(dense, cfg.block_sizes[level + 1], bs)
            if cfg.mv_cap is not None:  # identical clamp to the untiled engine
                pred = jnp.clip(pred, -float(cfg.mv_cap), float(cfg.mv_cap))

        halo = im2_halo(cfg, level)
        rows_ok = _level_shardable(h, w, bs, t) and halo < h // t
        cols_ok = (
            axis_x is not None
            and _level_shardable(w, h, bs, tx)
            and halo < w // tx
        )
        if rows_ok and cols_ok:
            sharding = NamedSharding(mesh, P(axis, axis_x))
            im1 = jax.lax.with_sharding_constraint(im1, sharding)
            im2 = jax.lax.with_sharding_constraint(im2, sharding)
            body = _tiled_level_fn_2d(bs, ss, cfg, h, w, halo, axis, axis_x, level)
            dense = shard_map(
                body,
                mesh=mesh,
                in_specs=(
                    P(axis, axis_x), P(axis, axis_x), P(axis, axis_x, None),
                ),
                out_specs=P(axis, axis_x, None),
                check_vma=False,
            )(im1, im2, pred)
        elif rows_ok:
            row_sharding = NamedSharding(mesh, P(axis, None))
            im1 = jax.lax.with_sharding_constraint(im1, row_sharding)
            im2 = jax.lax.with_sharding_constraint(im2, row_sharding)
            body = _tiled_level_fn(bs, ss, cfg, h, halo, axis, level)
            dense = shard_map(
                body,
                mesh=mesh,
                in_specs=(P(axis, None), P(axis, None), P(axis, None, None)),
                out_specs=P(axis, None, None),
                check_vma=False,
            )(im1, im2, pred)
        else:
            # level too small to tile: run it replicated (coarse levels are tiny)
            dense = engine._run_level(im1, im2, pred, bs, ss, cfg, level)
    return dense


@functools.partial(
    jax.jit, static_argnames=("cfg", "mesh", "batch_axis", "axis", "axis_x")
)
def estimate_flow_padded_batch_tiled(
    im1s: jnp.ndarray,
    im2s: jnp.ndarray,
    cfg: MotionConfig,
    mesh: Mesh,
    batch_axis: str = "batch",
    axis: str = "ty",
    axis_x: str | None = None,
) -> jnp.ndarray:
    """ONE jitted program sharding ALL parallel dimensions: frame pairs over
    ``batch_axis`` (across hosts) and rows over ``axis`` (halo exchange
    over NVLink) - the layout ``multihost.make_mesh`` builds; with ``axis_x``
    set, columns shard over a third mesh axis too (batch x ty x tx - the
    full composition of data parallelism with the reference's own column
    split, ``parallel.h:20-58``).  Per device: a local batch chunk of local
    strips; the per-frame tiled level body is vmapped over the chunk, so
    the ppermute halo exchanges batch together.

    im1s/im2s: (B, H', W') pre-padded uint8, B divisible by the batch axis.
    Returns (B, H', W', 2) flow sharded (batch, rows[, cols]).
    """
    if cfg.regularizer == "exact":
        raise ValueError(
            "regularizer='exact' is a whole-frame raster sweep and cannot be "
            "row-tiled; use engine.estimate_flow_batched, or fourcolor/"
            "windowed here"
        )
    t = mesh.shape[axis]
    tx = mesh.shape[axis_x] if axis_x is not None else 1
    levels = cfg.num_levels
    pyr1 = [im1s]
    pyr2 = [im2s]
    for _ in range(1, levels):
        pyr1.append(jax.vmap(resample.pyrdown_u8)(pyr1[-1]))
        pyr2.append(jax.vmap(resample.pyrdown_u8)(pyr2[-1]))

    bt_sharding = NamedSharding(mesh, P(batch_axis, axis, None))
    btx_sharding = NamedSharding(mesh, P(batch_axis, axis, axis_x))

    dense = None
    for level in range(levels - 1, -1, -1):
        im1, im2 = pyr1[level], pyr2[level]
        h, w = im1.shape[1:]
        bs, ss = cfg.block_sizes[level], cfg.search_sizes[level]
        if dense is None:
            b = im1.shape[0]
            pred = jnp.zeros((b, h // bs, w // bs, 2), dtype=jnp.float32)
        else:
            pred = jax.vmap(
                lambda d: engine.transfer_mvs(d, cfg.block_sizes[level + 1], bs)
            )(dense)
            if cfg.mv_cap is not None:
                pred = jnp.clip(pred, -float(cfg.mv_cap), float(cfg.mv_cap))

        halo = im2_halo(cfg, level)
        rows_ok = _level_shardable(h, w, bs, t) and halo < h // t
        cols_ok = (
            axis_x is not None
            and _level_shardable(w, h, bs, tx)
            and halo < w // tx
        )
        if rows_ok and cols_ok:
            im1 = jax.lax.with_sharding_constraint(im1, btx_sharding)
            im2 = jax.lax.with_sharding_constraint(im2, btx_sharding)
            body = _tiled_level_fn_2d(bs, ss, cfg, h, w, halo, axis, axis_x, level)
            dense = shard_map(
                jax.vmap(body),
                mesh=mesh,
                in_specs=(
                    P(batch_axis, axis, axis_x),
                    P(batch_axis, axis, axis_x),
                    P(batch_axis, axis, axis_x, None),
                ),
                out_specs=P(batch_axis, axis, axis_x, None),
                check_vma=False,
            )(im1, im2, pred)
        elif rows_ok:
            im1 = jax.lax.with_sharding_constraint(im1, bt_sharding)
            im2 = jax.lax.with_sharding_constraint(im2, bt_sharding)
            body = _tiled_level_fn(bs, ss, cfg, h, halo, axis, level)
            dense = shard_map(
                jax.vmap(body),
                mesh=mesh,
                in_specs=(
                    P(batch_axis, axis, None),
                    P(batch_axis, axis, None),
                    P(batch_axis, axis, None, None),
                ),
                out_specs=P(batch_axis, axis, None, None),
                check_vma=False,
            )(im1, im2, pred)
        else:
            # level too small to row-tile: batch-parallel only
            im1 = jax.lax.with_sharding_constraint(
                im1, NamedSharding(mesh, P(batch_axis, None, None))
            )
            dense = jax.vmap(
                lambda a, b, p: engine._run_level(a, b, p, bs, ss, cfg, level)
            )(im1, im2, pred)
    return dense


def estimate_flow_batch(
    im1s: jnp.ndarray,
    im2s: jnp.ndarray,
    cfg: MotionConfig,
    mesh: Mesh,
    batch_axis: str = "batch",
) -> jnp.ndarray:
    """Data-parallel driver over a batch of frame pairs (B, H, W) uint8.

    Returns (B, H, W, 2) float32 original-resolution flow, batch-sharded.
    """
    sharding = NamedSharding(mesh, P(batch_axis, None, None))
    im1s = jax.device_put(im1s, sharding)
    im2s = jax.device_put(im2s, sharding)

    @functools.partial(jax.jit, static_argnames=("cfg",))
    def run(a, b, cfg):
        return jax.vmap(lambda x, y: engine._driver_jit(x, y, cfg))(a, b)

    return run(im1s, im2s, cfg)
