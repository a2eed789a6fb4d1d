"""Block-divisibility padding (reference ``motion_framework.cpp:14-61``).

The reference searches for the smallest padded (H', W') such that
``H' % (2^i * block_size[i]) == 0`` for every pyramid level i, then zero-pads
both frames symmetrically.  Shapes are static under jit, so the search runs in
plain Python at trace time; only the pad itself is a device op.
"""

from __future__ import annotations

import dataclasses
import functools

import jax.numpy as jnp

from blockbasedmotionestimation.config import MotionConfig


@dataclasses.dataclass(frozen=True)
class Padding:
    orig_h: int
    orig_w: int
    padded_h: int
    padded_w: int
    pad_y: int
    pad_x: int


@functools.lru_cache(maxsize=None)
def _find_padded_dims(
    orig_h: int, orig_w: int, block_sizes: tuple[int, ...], row_tiles: int = 1
) -> tuple[int, int]:
    # row_tiles > 1 additionally requires the finest level's rows to split
    # into `row_tiles` block-aligned strips.  (r2 also forced an EVEN number
    # of block rows per strip - a +20% padding tax at 1080p/8-way; the color
    # steps are now per-tile parity-aware, so block alignment suffices.)
    row_mult = row_tiles * block_sizes[0] if row_tiles > 1 else 1
    temp_h, temp_w = orig_h, orig_w
    while True:
        if temp_h >= 2 * orig_h + row_mult or temp_w == 2 * orig_w:
            raise ValueError(
                "Could not find any multiples of the block size that match "
                "padded image dimensions (motion_framework.cpp:21-26)"
            )
        rem_h = sum(temp_h % ((1 << i) * bs) for i, bs in enumerate(block_sizes))
        rem_h += temp_h % row_mult
        rem_w = sum(temp_w % ((1 << i) * bs) for i, bs in enumerate(block_sizes))
        if rem_h == 0 and rem_w == 0:
            return temp_h, temp_w
        if rem_h:
            temp_h += 1
        if rem_w:
            temp_w += 1


def compute_padding(
    orig_h: int, orig_w: int, cfg: MotionConfig, row_tiles: int = 1
) -> Padding:
    """Static padding metadata for a frame of (orig_h, orig_w).

    row_tiles: pass the row-tiling mesh axis size to ALSO make the padded
    height split into that many even-block-row strips (see
    ``parallel.tiled``); the reference's own divisibility rule is unchanged.
    """
    padded_h, padded_w = _find_padded_dims(
        orig_h, orig_w, cfg.block_sizes, row_tiles
    )
    if (padded_h - orig_h) % 2 or (padded_w - orig_w) % 2:
        # The reference computes pad = (padded - orig) / 2 with integer division
        # and would silently lose a pixel on an odd difference; we define the
        # quirk away (SURVEY.md section 3.2).
        raise ValueError(
            f"padding difference must be even, got {padded_h - orig_h}x"
            f"{padded_w - orig_w} for {orig_h}x{orig_w} under {cfg.block_sizes}"
        )
    return Padding(
        orig_h=orig_h,
        orig_w=orig_w,
        padded_h=padded_h,
        padded_w=padded_w,
        pad_y=(padded_h - orig_h) // 2,
        pad_x=(padded_w - orig_w) // 2,
    )


def pad_frame(image: jnp.ndarray, p: Padding) -> jnp.ndarray:
    """Zero-pad (BORDER_CONSTANT 0, ``motion_framework.cpp:60-61``)."""
    return jnp.pad(image, ((p.pad_y, p.pad_y), (p.pad_x, p.pad_x)), constant_values=0)
