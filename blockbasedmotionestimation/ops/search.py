"""Vectorized block search: the reference's spiral walk as a cost-volume argmin.

The reference's hot kernel (``motion_framework.cpp:296-422``) walks a square
spiral around the predicted block position, keeping the first strictly-smaller
SAD.  Here the full (2S+1)^2 SAD cost volume is evaluated for every block in
one batched pass, scanning the offsets *in spiral-visit order* with a strict-<
argmin update - bit-identical to the sequential walk:

  * out-of-bounds offsets are skipped in the walk but still advance the cursor
    (``:335-336``), so masking them to +INT_MAX preserves semantics;
  * a predicted center that is itself out of bounds short-circuits to the
    source position, i.e. a zero MV (``:304-310``);
  * the strict-< update means min SAD with earliest-visit tie-break, which the
    in-order scan reproduces exactly.

Tiling support: when the frame is row-sharded across a device mesh, each
device calls this with its local im1 tile, an im2 buffer that includes halo
rows from its neighbors, and traced row offsets locating the tile in the
global frame.  All bounds checks use global coordinates, so tiled == untiled
bit-for-bit (given a sufficient halo, see ``parallel/tiled.py``).

The windowed levels (``ops.windowed``) build the same volume with either
this module's XLA form or the Triton kernel in ``kernels/cost_volume.py``
(``resolve_impl``).
"""

from __future__ import annotations

import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from blockbasedmotionestimation.ops.spiral import spiral_offsets

_I32_MAX = np.int32(np.iinfo(np.int32).max)


def resolve_impl(impl: str, cost: str) -> str:
    """The cost-volume implementation a windowed level runs.

    ``auto`` stays ``auto`` - the Triton kernel (``kernels.cost_volume``)
    where the program is compiled for a GPU, the XLA scan elsewhere - except
    for ``zsad``, which always runs on XLA (its per-block mean is
    float-valued, and the kernel implements sad/ssd).  Asking for ``triton``
    without a GPU is an error, never a silent fallback.
    """
    if impl == "auto":
        return "xla" if cost == "zsad" else "auto"
    if impl == "triton" and jax.default_backend() != "gpu":
        raise RuntimeError(
            "search_impl='triton' needs a GPU backend, found "
            f"{jax.default_backend()!r} (use 'triton_interpret' on the CPU)"
        )
    if impl not in ("xla", "triton", "triton_interpret"):
        raise ValueError(f"unknown search impl: {impl}")
    return impl


def block_cost(a: jnp.ndarray, b: jnp.ndarray, axis, cost: str) -> jnp.ndarray:
    """SAD (cv::norm NORM_L1, the reference cost), SSD, or zero-mean SAD.

    ``zsad`` subtracts the block-mean difference before the L1 sum
    (sum |d_i - mean(d)|): invariant to a uniform brightness offset and
    first-order robust to gain, the classical fix for the raw-SAD collapse
    under photometric nuisance (EVAL_robust.md; the reference's cost is raw
    SAD, ``motion_framework.cpp:315``, so ``sad`` stays the default).
    Float-valued (f32); runs on the XLA cost paths.
    """
    d = a - b
    if cost == "sad":
        return jnp.sum(jnp.abs(d), axis=axis, dtype=jnp.int32)
    if cost == "ssd":
        d32 = d.astype(jnp.int32)
        return jnp.sum(d32 * d32, axis=axis, dtype=jnp.int32)
    if cost == "zsad":
        df = d.astype(jnp.float32)
        m = jnp.mean(df, axis=axis, keepdims=True)
        return jnp.sum(jnp.abs(df - m), axis=axis)
    raise ValueError(f"unknown cost: {cost}")


def extract_blocks(image: jnp.ndarray, bs: int) -> jnp.ndarray:
    """(H, W) -> (nby*nbx, bs, bs) row-major block grid."""
    h, w = image.shape
    nby, nbx = h // bs, w // bs
    return (
        image.reshape(nby, bs, nbx, bs).transpose(0, 2, 1, 3).reshape(nby * nbx, bs, bs)
    )


def _gather_windows_impl(im2p, by, bx, win: int):
    def one(y, x):
        return jax.lax.dynamic_slice(im2p, (y, x), (win, win))

    return jax.vmap(one)(by, bx)  # (nblk, win, win) uint8


@functools.lru_cache(maxsize=None)
def _gather_windows_fn(bs: int, ext: int):
    win = bs + 2 * ext

    @jax.custom_batching.custom_vmap
    def gather(im2, by, bx):
        im2p = jnp.pad(im2, ((ext, ext), (ext, ext)), constant_values=0)
        return _gather_windows_impl(im2p, by, bx, win)

    @gather.def_vmap
    def _rule(axis_size, in_batched, im2, by, bx):
        imb, byb, bxb = in_batched
        if not imb:
            im2 = jnp.broadcast_to(im2, (axis_size,) + im2.shape)
        if not byb:
            by = jnp.broadcast_to(by, (axis_size,) + by.shape)
        if not bxb:
            bx = jnp.broadcast_to(bx, (axis_size,) + bx.shape)
        b, h, w = im2.shape
        im2p = jnp.pad(
            im2, ((0, 0), (ext, ext), (ext, ext)), constant_values=0
        )
        hp = h + 2 * ext
        flat = im2p.reshape(b * hp, w + 2 * ext)
        row_off = (jnp.arange(b, dtype=by.dtype) * hp)[:, None]
        wins = _gather_windows_impl(
            flat, (by + row_off).reshape(-1), bx.reshape(-1), win
        )
        return wins.reshape(b, by.shape[1], win, win), True

    return gather


def _gather_windows(
    im2: jnp.ndarray, by: jnp.ndarray, bx: jnp.ndarray, bs: int, ext: int
):
    """Per-block (bs+2S, bs+2S) windows whose top-left is (by, bx) in im2-buffer
    coords; im2 is padded by S so any center inside the buffer slices cleanly.

    Under vmap (the engine vmaps whole levels over frame pairs) the default
    batching rule nests the dynamic-slice gather inside a second gather, so
    the gather carries a custom_vmap rule that stacks the padded frames vertically and
    performs ONE flat gather with row offsets shifted by b * Hp - windows
    never cross frame bands because each frame keeps its own ext padding.
    """
    return _gather_windows_fn(bs, ext)(im2, by, bx)


@partial(jax.jit, static_argnames=("bs", "ss", "full_h", "full_w", "cost"))
def _raster_search_level(
    im1: jnp.ndarray,
    im2: jnp.ndarray,
    pred: jnp.ndarray,
    bs: int,
    ss: int,
    full_h: int | None = None,
    row0: jnp.ndarray | int = 0,
    im2_row0: jnp.ndarray | int = 0,
    full_w: int | None = None,
    col0: jnp.ndarray | int = 0,
    im2_col0: jnp.ndarray | int = 0,
    cost: str = "sad",
) -> jnp.ndarray:
    """The reference's exhaustive raster search (``motion_framework.cpp:246-294``).

    Full scan of the clipped half-shift window in raster order; strict-< SAD
    wins, equal SAD broken by smaller L1 distance of the position to the
    source block (``:276-281``), remaining ties keep the first raster visit.
    No zero-MV early-out: an entirely clipped-away window keeps the predicted
    position.
    """
    ht, wt = im1.shape
    h = ht if full_h is None else full_h
    w = wt if full_w is None else full_w
    nby, nbx = ht // bs, wt // bs
    nblk = nby * nbx
    sp = (ss - bs) >> 1  # start_pos (:249)

    row0 = jnp.asarray(row0, dtype=jnp.int32)
    im2_row0 = jnp.asarray(im2_row0, dtype=jnp.int32)
    col0 = jnp.asarray(col0, dtype=jnp.int32)
    im2_col0 = jnp.asarray(im2_col0, dtype=jnp.int32)
    oy = (row0 + jnp.arange(nby, dtype=jnp.int32) * bs)[:, None]
    ox = (col0 + jnp.arange(nbx, dtype=jnp.int32) * bs)[None, :]
    cu = pred[..., 0].astype(jnp.int32)
    cv = pred[..., 1].astype(jnp.int32)
    cy = (oy + cv).reshape(nblk)  # unclamped predicted centers (global)
    cx = (ox + cu).reshape(nblk)

    blocks_t = extract_blocks(im1, bs).astype(jnp.int16).transpose(1, 2, 0)
    by = jnp.clip(cy - im2_row0, 0, im2.shape[0] - bs)
    bx = jnp.clip(jnp.clip(cx, 0, w - bs) - im2_col0, 0, im2.shape[1] - bs)
    windows_t = (
        _gather_windows(im2, by, bx, bs, sp)
        .astype(jnp.int16)
        .transpose(1, 2, 0)  # (win, win, nblk): blocks on the minor dim
    )
    cyc = by + im2_row0  # global row of each window's center
    cxc = bx + im2_col0

    oy1 = jnp.broadcast_to(oy, (nby, nbx)).reshape(nblk)
    ox1 = jnp.broadcast_to(ox, (nby, nbx)).reshape(nblk)

    side = 2 * sp + 1

    def step(carry, off):
        best_sad, best_l1, best_y, best_x = carry
        dy, dx = off
        win = jax.lax.dynamic_slice(windows_t, (dy, dx, 0), (bs, bs, nblk))
        sad = block_cost(blocks_t, win, (0, 1), cost)
        py = cyc + (dy - sp)
        px = cxc + (dx - sp)
        ok = (
            (py >= jnp.maximum(0, cy - sp)) & (py <= jnp.minimum(h - bs, cy + sp))
            & (px >= jnp.maximum(0, cx - sp)) & (px <= jnp.minimum(w - bs, cx + sp))
        )
        sad = jnp.where(ok, sad, _I32_MAX)
        l1 = jnp.abs(ox1 - px) + jnp.abs(oy1 - py)  # dist to SOURCE (:276)
        l1 = jnp.where(ok, l1, _I32_MAX)
        better = (sad < best_sad) | ((sad == best_sad) & (l1 < best_l1))
        return (
            jnp.where(better, sad, best_sad),
            jnp.where(better, l1, best_l1),
            jnp.where(better, py, best_y),
            jnp.where(better, px, best_x),
        ), None

    dys2 = jnp.repeat(jnp.arange(side, dtype=jnp.int32), side)
    dxs2 = jnp.tile(jnp.arange(side, dtype=jnp.int32), side)
    cdt = jnp.float32 if cost == "zsad" else jnp.int32  # zsad is f32-valued
    init = (
        jnp.full((nblk,), _I32_MAX, dtype=cdt),
        jnp.full((nblk,), _I32_MAX, dtype=jnp.int32),
        cy,  # empty window -> predicted position (:251-252)
        cx,
    )
    (_, _, win_y, win_x), _ = jax.lax.scan(step, init, (dys2, dxs2))
    u = (win_x - ox1).astype(jnp.float32).reshape(nby, nbx)
    v = (win_y - oy1).astype(jnp.float32).reshape(nby, nbx)
    return jnp.stack([u, v], axis=-1)


@partial(jax.jit, static_argnames=("bs", "ss", "full_h", "full_w", "order", "cost"))
def block_search_level(
    im1: jnp.ndarray,
    im2: jnp.ndarray,
    pred: jnp.ndarray,
    bs: int,
    ss: int,
    full_h: int | None = None,
    row0: jnp.ndarray | int = 0,
    im2_row0: jnp.ndarray | int = 0,
    full_w: int | None = None,
    col0: jnp.ndarray | int = 0,
    im2_col0: jnp.ndarray | int = 0,
    order: str = "spiral",
    cost: str = "sad",
) -> jnp.ndarray:
    """One ``calcLevelBM`` sweep (``motion_framework.cpp:226-244``).

    Args:
      im1: (Ht, Wt) uint8 tile of frame 1 (whole frame in the untiled case).
      im2: (Hb, Wb) uint8 frame-2 buffer covering the tile plus search halo
        rows/columns.
      pred: (nby, nbx, 2) float32 predicted MVs (u, v) at block origins.
      bs, ss: block and search sizes; shift = ss - bs.
      full_h: global frame height for bounds checks (None -> im1 is whole).
      row0: global pixel row of im1's first row (traced; device-dependent
        under shard_map).
      im2_row0: global pixel row of the im2 buffer's first row (<= row0 when
        the buffer carries a north halo).
      full_w / col0 / im2_col0: the column-axis analogues (2-D tiling).

    Returns:
      (nby, nbx, 2) float32 winning MVs (integer-valued).
    """
    if order == "raster":
        return _raster_search_level(
            im1, im2, pred, bs, ss, full_h=full_h, row0=row0, im2_row0=im2_row0,
            full_w=full_w, col0=col0, im2_col0=im2_col0,
            cost=cost,
        )
    ht, wt = im1.shape
    h = ht if full_h is None else full_h
    w = wt if full_w is None else full_w
    nby, nbx = ht // bs, wt // bs
    nblk = nby * nbx
    shift = ss - bs
    dys, dxs, ext = spiral_offsets(shift)

    row0 = jnp.asarray(row0, dtype=jnp.int32)
    im2_row0 = jnp.asarray(im2_row0, dtype=jnp.int32)
    col0 = jnp.asarray(col0, dtype=jnp.int32)
    im2_col0 = jnp.asarray(im2_col0, dtype=jnp.int32)
    # global block origins
    oy = (row0 + jnp.arange(nby, dtype=jnp.int32) * bs)[:, None]  # (nby, 1)
    ox = (col0 + jnp.arange(nbx, dtype=jnp.int32) * bs)[None, :]  # (1, nbx)
    # (int) truncation toward zero of the propagated MV (:233-234)
    cu = pred[..., 0].astype(jnp.int32)
    cv = pred[..., 1].astype(jnp.int32)
    cy = oy + cv  # predicted center rows (global), (nby, nbx)
    cx = ox + cu
    # zero-MV early-out: center block not fully inside the image (:304-310)
    center_ok = (cy >= 0) & (cy <= h - bs) & (cx >= 0) & (cx <= w - bs)
    cy_safe = jnp.where(center_ok, cy, jnp.broadcast_to(oy, (nby, nbx))).reshape(nblk)
    cx_safe = jnp.where(center_ok, cx, jnp.broadcast_to(ox, (nby, nbx))).reshape(nblk)

    blocks = extract_blocks(im1, bs).astype(jnp.int16)  # (nblk, bs, bs)
    # window top-left in im2-buffer coords; clamp so an undersized halo cannot
    # slip out of the buffer (correctness then relies on the halo bound)
    by = jnp.clip(cy_safe - im2_row0, 0, im2.shape[0] - bs)
    bx = jnp.clip(cx_safe - im2_col0, 0, im2.shape[1] - bs)
    windows = _gather_windows(im2, by, bx, bs, ext).astype(jnp.int16)

    # blocks on the minor dim, one scan step per spiral offset with the
    # (bs, bs) window slice taken at a dynamic offset; the in-order scan
    # with a strict-< update is the walk's first-visit-wins rule.
    blocks_t = blocks.transpose(1, 2, 0)    # (bs, bs, nblk)
    windows_t = windows.transpose(1, 2, 0)  # (win, win, nblk)

    def step(carry, off):
        best_sad, best_dy, best_dx = carry
        dy, dx = off
        win = jax.lax.dynamic_slice(windows_t, (dy, dx, 0), (bs, bs, nblk))
        sad = block_cost(blocks_t, win, (0, 1), cost)  # cv::norm (:315)
        ty = cy_safe + (dy - ext)
        tx = cx_safe + (dx - ext)
        ok = (ty >= 0) & (ty <= h - bs) & (tx >= 0) & (tx <= w - bs)
        sad = jnp.where(ok, sad, _I32_MAX)
        better = sad < best_sad  # strict <: first spiral visit wins ties
        return (
            jnp.where(better, sad, best_sad),
            jnp.where(better, dy, best_dy),
            jnp.where(better, dx, best_dx),
        ), None

    cdt = jnp.float32 if cost == "zsad" else jnp.int32
    init = (
        jnp.full((nblk,), _I32_MAX, dtype=cdt),
        jnp.full((nblk,), ext, dtype=jnp.int32),  # center offset (rank 0)
        jnp.full((nblk,), ext, dtype=jnp.int32),
    )
    offs = (jnp.asarray(dys + ext), jnp.asarray(dxs + ext))
    (_, best_dy, best_dx), _ = jax.lax.scan(step, init, offs)

    win_y = (cy_safe + best_dy - ext).reshape(nby, nbx)
    win_x = (cx_safe + best_dx - ext).reshape(nby, nbx)
    u = (win_x - ox).astype(jnp.float32)
    v = (win_y - oy).astype(jnp.float32)
    u = jnp.where(center_ok, u, 0.0)
    v = jnp.where(center_ok, v, 0.0)
    return jnp.stack([u, v], axis=-1)
