"""The coarse-to-fine block-matching engine (reference ``motion_framework.cpp:113-219``).

Structure per pyramid level (coarsest -> finest):
  1. cross-level MV transfer: coarse MVs x2 scattered over 2*bs squares
     (``copyMVs``/``fill_block_MV``, ``:828-843``) - expressed as a static
     gather on the coarse stride-1 MV grid;
  2. spiral block search around the propagated prediction (``calcLevelBM``,
     ``:226-244``) - the vectorized cost-volume argmin in ``ops.search``;
  3. progressive regularization: while block_size > 1, run
     ``sweeps_per_round`` 8-connected sweeps with lambda_multiplier = sweep+1,
     then subdivide blocks (``divide_blocks`` -> 2x2 grid repeat) and double
     lambda (``:141-152, 845-862``).

The MV field lives on a block grid whose resolution doubles with each
subdivision, reaching per-pixel density (stride 1) at the end of each level -
at which point the reference's final ``copy_to_all_pixels`` (``:205-206``) is
the identity.  All shapes are static; the whole pipeline jits into one XLA
program per (frame shape, config).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from blockbasedmotionestimation.config import MotionConfig
from blockbasedmotionestimation.ops import pad as pad_ops
from blockbasedmotionestimation.ops import resample
from blockbasedmotionestimation.ops.regularize import run_schedule
from blockbasedmotionestimation.ops.search import block_search_level
from blockbasedmotionestimation.ops.windowed import windowed_level, windowed_schedule


def transfer_mvs(dense_coarse: jnp.ndarray, coarse_bs: int, fine_bs: int) -> jnp.ndarray:
    """Cross-level MV prediction (``copyMVs``, ``:828-843``).

    dense_coarse: (Hc, Wc, 2) stride-1 MV grid of the coarser level.
    Returns (2*Hc//fine_bs, 2*Wc//fine_bs, 2) predictions at fine block
    origins: coarse block (i,j) MV x2 fills the 2*coarse_bs square whose
    origin-grid cells the fine blocks read.
    """
    hc, wc = dense_coarse.shape[:2]
    sampled = dense_coarse[::coarse_bs, ::coarse_bs] * jnp.float32(2.0)
    nby_f = 2 * hc // fine_bs
    nbx_f = 2 * wc // fine_bs
    iy = (np.arange(nby_f) * fine_bs) // (2 * coarse_bs)
    jx = (np.arange(nbx_f) * fine_bs) // (2 * coarse_bs)
    return sampled[jnp.asarray(iy)][:, jnp.asarray(jx)]


def subdivide(grid: jnp.ndarray) -> jnp.ndarray:
    """``divide_blocks`` (``:845-862``): each block's MV to its 4 children."""
    return jnp.repeat(jnp.repeat(grid, 2, axis=0), 2, axis=1)


def _run_level(
    im1: jnp.ndarray,
    im2: jnp.ndarray,
    pred: jnp.ndarray,
    bs: int,
    ss: int,
    cfg: MotionConfig,
    level: int = 0,
) -> jnp.ndarray:
    """Search + regularization schedule for one level; returns the stride-1 grid."""
    lam0f = float(bs) * cfg.lambda_scale
    rr = cfg.rival_radius_at(level)
    if cfg.uses_fused_windowed:
        # fused path: one window gather + pooled cost volume serves the
        # spiral-search argmin AND the regularization rounds (ops.windowed)
        return windowed_level(
            im1, im2, pred, bs, ss, lam0f, cfg.sweeps_per_round,
            cost=cfg.cost, impl=cfg.search_impl, rival=cfg.rival_window,
            rival_radius=rr,
        )
    grid = block_search_level(
        im1, im2, pred, bs, ss, order=cfg.search_order, cost=cfg.cost,
    )
    lam0 = float(bs) * cfg.lambda_scale  # reference: block_size/2 (:73)
    if cfg.regularizer == "windowed":
        return windowed_schedule(
            im1, im2, grid, bs, ss, lam0, cfg.sweeps_per_round,
            cost=cfg.cost, reg_radius=cfg.reg_radius, impl=cfg.search_impl,
            rival=cfg.rival_window, rival_radius=rr,
        )
    return run_schedule(
        im1, im2, grid, bs, lam0,
        cfg.sweeps_per_round, cfg.regularizer, cost=cfg.cost,
    )


def estimate_flow_padded(
    im1p: jnp.ndarray, im2p: jnp.ndarray, cfg: MotionConfig
) -> jnp.ndarray:
    """Dense per-pixel flow of pre-padded frames (``calcMotionBlockMatching``)."""
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
            pred = transfer_mvs(dense, cfg.block_sizes[level + 1], bs)
            if cfg.mv_cap is not None:
                # capped-MV model: bounds the tiled engine's halo (see
                # config.MotionConfig.mv_cap); applied identically there
                pred = jnp.clip(pred, -float(cfg.mv_cap), float(cfg.mv_cap))
        dense = _run_level(im1, im2, pred, bs, ss, cfg, level)
    return dense  # stride-1: copy_to_all_pixels (:205-206) is the identity here


@functools.partial(jax.jit, static_argnames=("cfg",))
def _driver_jit(im1: jnp.ndarray, im2: jnp.ndarray, cfg: MotionConfig) -> jnp.ndarray:
    orig_h, orig_w = im1.shape
    f = cfg.interp_factor
    if f > 1:  # subpixel trick: cv::resize x f INTER_LINEAR (main_class.cpp:32-33)
        im1 = resample.resize_scale_u8(im1, f)
        im2 = resample.resize_scale_u8(im2, f)
    p = pad_ops.compute_padding(im1.shape[0], im1.shape[1], cfg)
    flow = estimate_flow_padded(pad_ops.pad_frame(im1, p), pad_ops.pad_frame(im2, p), cfg)
    # MV subsample/rescale back to original resolution (main_class.cpp:57-70)
    sub = flow[p.pad_y : p.padded_h - p.pad_y : f, p.pad_x : p.padded_w - p.pad_x : f]
    return sub / jnp.float32(f)


@functools.partial(jax.jit, static_argnames=("cfg", "p"))
def _pad_and_run(a, b, cfg: MotionConfig, p: pad_ops.Padding):
    return estimate_flow_padded(pad_ops.pad_frame(a, p), pad_ops.pad_frame(b, p), cfg)


def estimate_flow(
    im1: jnp.ndarray, im2: jnp.ndarray, cfg: MotionConfig
) -> tuple[jnp.ndarray, pad_ops.Padding]:
    """Pad + engine on frames as given (no interp): (padded dense flow, padding)."""
    p = pad_ops.compute_padding(im1.shape[0], im1.shape[1], cfg)
    return _pad_and_run(im1, im2, cfg, p), p


def estimate_flow_driver(
    im1: jnp.ndarray, im2: jnp.ndarray, cfg: MotionConfig
) -> jnp.ndarray:
    """The reference driver scenario end-to-end (``main_class.cpp:6-85``):
    interp-factor upsample -> pad -> engine -> stride-f subsample, MV / f.
    Returns (H, W, 2) float32 flow at the original resolution."""
    return _driver_jit(im1, im2, cfg)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _driver_batched_jit(im1s, im2s, cfg: MotionConfig):
    return jax.vmap(lambda a, b: _driver_jit(a, b, cfg))(im1s, im2s)


def estimate_flow_driver_batched(
    im1s: jnp.ndarray, im2s: jnp.ndarray, cfg: MotionConfig
) -> jnp.ndarray:
    """Batched reference-driver scenario over (B, H, W) pairs: one jitted
    program per batch shape (the sequence runner's throughput path)."""
    return _driver_batched_jit(im1s, im2s, cfg)


@functools.partial(jax.jit, static_argnames=("cfg", "p"))
def _batched_jit(im1s, im2s, cfg: MotionConfig, p: pad_ops.Padding):
    return jax.vmap(
        lambda a, b: estimate_flow_padded(
            pad_ops.pad_frame(a, p), pad_ops.pad_frame(b, p), cfg
        )
    )(im1s, im2s)


def estimate_flow_batched(
    im1s: jnp.ndarray, im2s: jnp.ndarray, cfg: MotionConfig
) -> tuple[jnp.ndarray, pad_ops.Padding]:
    """Single-device batched pipeline over (B, H, W) frame pairs.

    One jitted program runs all B fields; this amortizes the
    dispatch overhead and the small coarse-level ops across the batch
    (the production throughput path - for multi-device batch sharding see
    ``parallel.tiled.estimate_flow_batch``).  Returns (B-padded flow,
    padding).
    """
    p = pad_ops.compute_padding(im1s.shape[1], im1s.shape[2], cfg)
    return _batched_jit(im1s, im2s, cfg, p), p
