"""OpenCV-parity resampling in pure JAX integer arithmetic.

The reference leans on two OpenCV calls whose exact pixel values shape the
whole pipeline: ``cv::pyrDown`` for the Gaussian pyramid
(``motion_framework.cpp:86-106``) and ``cv::resize(..., INTER_LINEAR)`` for the
driver's 4x sub-pixel upsampling trick (``main_class.cpp:32-33``).  Both are
re-derived here from OpenCV's fixed-point uint8 algorithms so the JAX engine is
bit-exact against the oracle without depending on OpenCV at runtime:

  * pyrDown: separable (1,4,6,4,1) kernel, BORDER_REFLECT_101, even-index
    decimation, a single final rounding ``(acc + 128) >> 8`` (the 8u path
    accumulates in int and casts once).
  * resize INTER_LINEAR 8u: half-pixel-center source mapping computed in
    float32, coefficients quantized to ``round(f * 2048)`` (INTER_RESIZE_COEF
    fixed point), horizontal pass to int32 rows, and OpenCV's dedicated 8u
    vertical cast ``((b0*(S0>>4))>>16 + (b1*(S1>>4))>>16 + 2) >> 2``.

Everything is expressed as gathers with trace-time-constant index/coefficient
tables plus integer elementwise math - XLA fuses it into a handful of VPU ops;
no data-dependent control flow.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_PYR_KERNEL = np.array([1, 4, 6, 4, 1], dtype=np.int32)


def _reflect101_indices(n: int, lo: int = 2, hi: int = 2) -> np.ndarray:
    """Indices implementing BORDER_REFLECT_101 (``gfedcb|abcdefgh|gfedcba``)."""
    idx = np.arange(-lo, n + hi)
    # reflect without repeating the edge pixel; valid while pad < n
    idx = np.abs(idx)
    idx = np.where(idx >= n, 2 * (n - 1) - idx, idx)
    return idx.astype(np.int32)


def pyrdown_u8(image: jnp.ndarray) -> jnp.ndarray:
    """``cv::pyrDown`` on a (H, W) uint8 image with even H, W.

    Returns the (H//2, W//2) uint8 half-resolution image, bit-exact with
    OpenCV's 8u path (separable 1-4-6-4-1, reflect-101 borders, single
    ``(acc + 128) >> 8`` rounding).
    """
    h, w = image.shape
    if h % 2 or w % 2:
        raise ValueError(f"pyrdown_u8 requires even dims, got {h}x{w}")
    ridx = _reflect101_indices(h)
    cidx = _reflect101_indices(w)
    x = image[ridx][:, cidx].astype(jnp.int32)  # (h+4, w+4)
    k = jnp.asarray(_PYR_KERNEL)
    # vertical conv sampled at even output rows: rows 2y .. 2y+4 of the padded
    rows = 2 * jnp.arange(h // 2)
    acc_v = sum(k[t] * x[rows + t] for t in range(5))  # (h//2, w+4)
    cols = 2 * jnp.arange(w // 2)
    acc = sum(k[t] * acc_v[:, cols + t] for t in range(5))  # (h//2, w//2)
    return ((acc + 128) >> 8).astype(jnp.uint8)


def _coords(src_n: int, dst_n: int) -> tuple[np.ndarray, np.ndarray]:
    """OpenCV half-pixel-center source mapping: float32 ``(d+0.5)*scale-0.5``."""
    scale = src_n / dst_n
    d = np.arange(dst_n, dtype=np.float64)
    f = ((d + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    return s, f - s


def _fixed_coefs(frac: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``saturate_cast<short>(f * INTER_RESIZE_COEF_SCALE)``, scale 2048,
    round-half-to-even (cvRound)."""
    a1 = np.rint(frac * 2048.0).astype(np.int32)
    a0 = np.rint((1.0 - frac) * 2048.0).astype(np.int32)
    return a0, a1


@functools.lru_cache(maxsize=None)
def _resize_tables_x(src_n: int, dst_n: int):
    """Horizontal indices/coefs. OpenCV's X loop zeroes the fraction at the
    edges (``fxx = 0, sx = 0`` / ``sx = w-1``) so edge columns become a single
    full-weight tap (``resize.cpp`` xmin/xmax handling)."""
    s0, fx = _coords(src_n, dst_n)
    fx = np.where(s0 < 0, np.float32(0.0), fx)
    s0 = np.maximum(s0, 0)
    fx = np.where(s0 >= src_n - 1, np.float32(0.0), fx)
    s0 = np.minimum(s0, src_n - 1)
    s1 = np.minimum(s0 + 1, src_n - 1)
    a0, a1 = _fixed_coefs(fx)
    return s0.astype(np.int32), s1.astype(np.int32), a0, a1


@functools.lru_cache(maxsize=None)
def _resize_tables_y(src_n: int, dst_n: int):
    """Vertical indices/coefs. Unlike X, the Y loop keeps the UNCLAMPED
    fraction and only replicate-clamps the two row indices, so an edge row
    blends row 0 (or n-1) with itself through two separate ``>>16``
    truncations - numerically different from a single full-weight tap."""
    s, fy = _coords(src_n, dst_n)
    s0 = np.clip(s, 0, src_n - 1)
    s1 = np.clip(s + 1, 0, src_n - 1)
    b0, b1 = _fixed_coefs(fy)
    return s0.astype(np.int32), s1.astype(np.int32), b0, b1


def resize_linear_u8(image: jnp.ndarray, dst_h: int, dst_w: int) -> jnp.ndarray:
    """``cv::resize(..., INTER_LINEAR)`` on a (H, W) uint8 image.

    Bit-exact with OpenCV's fixed-point 8u bilinear path (the driver's 4x
    upsample, ``main_class.cpp:32-33``): int32 horizontal pass with x2048
    coefficients, then the specialized 8u vertical cast.
    """
    src_h, src_w = image.shape
    ys0, ys1, yb0, yb1 = _resize_tables_y(src_h, dst_h)
    xs0, xs1, xa0, xa1 = _resize_tables_x(src_w, dst_w)
    x = image.astype(jnp.int32)
    # horizontal pass on the source rows we will need (all of them; XLA fuses)
    row = x[:, xs0] * jnp.asarray(xa0) + x[:, xs1] * jnp.asarray(xa1)  # (src_h, dst_w)
    s0 = row[ys0]  # (dst_h, dst_w)
    s1 = row[ys1]
    b0 = jnp.asarray(yb0)[:, None]
    b1 = jnp.asarray(yb1)[:, None]
    # OpenCV VResizeLinear<uchar> specialization:
    #   uchar((((b0*(S0>>4))>>16) + ((b1*(S1>>4))>>16) + 2) >> 2)
    out = (((b0 * (s0 >> 4)) >> 16) + ((b1 * (s1 >> 4)) >> 16) + 2) >> 2
    return jnp.clip(out, 0, 255).astype(jnp.uint8)


def resize_scale_u8(image: jnp.ndarray, factor: int) -> jnp.ndarray:
    """Integer-factor upscale, the driver's ``cv::resize(src, dst, Size(), f, f)``."""
    h, w = image.shape
    return resize_linear_u8(image, h * factor, w * factor)


def build_pyramid(image: jnp.ndarray, num_levels: int) -> list[jnp.ndarray]:
    """Gaussian half-resolution pyramid, level 0 = full res (``motion_framework.cpp:86-106``)."""
    levels = [image]
    for _ in range(1, num_levels):
        levels.append(pyrdown_u8(levels[-1]))
    return levels
