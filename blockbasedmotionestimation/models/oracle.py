"""Sequential NumPy/OpenCV oracle of the reference pipeline.

The reference binary is Windows/MSVC and cannot run here, so this module is the
bit-exactness anchor for the JAX engine: a slow, faithful re-derivation of every
semantic quirk of ``motion_framework.cpp`` / ``main_class.cpp``, using the same
OpenCV library calls (``cv2.pyrDown``, ``cv2.resize``, ``cv2.norm(NORM_L1)``)
the C++ links against.  The JAX engine is tested for exact MV-field equality
against this oracle on small inputs, and the oracle's own subroutines are
tested against OpenCV ground truth.

Faithfully reproduced behaviors (with reference citations):
  * padding search: smallest H',W' with H' % (2^i * bs[i]) == 0 for all levels,
    incrementing by 1 (``motion_framework.cpp:14-54``); zero border padding.
  * Gaussian pyramid via cv::pyrDown half-resolution (``:86-106``).
  * per-level lambda = block_size / 2, doubled per subdivision (``:73,151``).
  * spiral block search with strict-< updates, out-of-bounds skip that still
    advances the cursor, and the zero-MV early-out for out-of-window predicted
    centers (``:296-422``).
  * int-truncated (toward zero) search centers (``:233-234``).
  * 8-connected regularization with the 9 border-case candidate orderings
    (``:439-522``), energy = SAD + lambda*mult*L1-smoothness (``:607``),
    first-strict-min tie-break (``:646-662``), and in-place Gauss-Seidel
    updates (``:616``).
  * progressive block subdivision to 1px with 2 sweeps per round and
    lambda_multiplier = sweep + 1 (``:141-152``).
  * final 2x2 densification (``:205-206, 815-826``).
  * driver scenario: 4x INTER_LINEAR upsample, stride-4 subsample from the
    padding offset, MV /4 (``main_class.cpp:32-70``).

The SAD cache ("fast_array", ``motion_framework.cpp:77-78,594-602``) is
numerically transparent - a cache hit returns exactly the value a recompute
would - so the oracle recomputes SADs directly.
"""

from __future__ import annotations

import numpy as np

from blockbasedmotionestimation.config import MotionConfig


def find_padding(orig_h: int, orig_w: int, cfg: MotionConfig) -> tuple[int, int]:
    """Padded (H', W') per ``motion_framework.cpp:14-46``."""
    temp_h, temp_w = orig_h, orig_w
    while True:
        if temp_h == 2 * orig_h or temp_w == 2 * orig_w:
            raise ValueError(
                "Could not find any multiples of the block size that match "
                "padded image dimensions"
            )
        rem_h = sum(temp_h % ((1 << i) * bs) for i, bs in enumerate(cfg.block_sizes))
        rem_w = sum(temp_w % ((1 << i) * bs) for i, bs in enumerate(cfg.block_sizes))
        if rem_h == 0 and rem_w == 0:
            return temp_h, temp_w
        if rem_h:
            temp_h += 1
        if rem_w:
            temp_w += 1


def pad_images(
    image1: np.ndarray, image2: np.ndarray, cfg: MotionConfig
) -> tuple[np.ndarray, np.ndarray, int, int, int, int]:
    """Zero-pad both frames to the block-divisible size (``:50-61``).

    Returns (im1, im2, pad_y, pad_x, padded_h, padded_w).  The reference
    computes pad = (padded - orig) / 2 with integer division and pads both
    sides, which silently loses a pixel when the difference is odd; that latent
    bug is defined away here by requiring an even difference.
    """
    orig_h, orig_w = image1.shape
    padded_h, padded_w = find_padding(orig_h, orig_w, cfg)
    if (padded_h - orig_h) % 2 or (padded_w - orig_w) % 2:
        raise ValueError(
            "padding difference must be even (reference assumes this; odd "
            f"difference {padded_h - orig_h}x{padded_w - orig_w} would "
            "mis-size the padded image)"
        )
    pad_y = (padded_h - orig_h) // 2
    pad_x = (padded_w - orig_w) // 2
    pad = lambda im: np.pad(im, ((pad_y, pad_y), (pad_x, pad_x)), constant_values=0)
    return pad(image1), pad(image2), pad_y, pad_x, padded_h, padded_w


def build_pyramid(image: np.ndarray, num_levels: int) -> list[np.ndarray]:
    """Gaussian half-resolution pyramid via cv::pyrDown (``:86-106``).

    Level 0 is the padded full-resolution image, matching the reference's
    ``level_data`` ordering.
    """
    import cv2

    levels = [image]
    for _ in range(1, num_levels):
        prev = levels[-1]
        levels.append(cv2.pyrDown(prev, dstsize=(prev.shape[1] // 2, prev.shape[0] // 2)))
    return levels


def _sad(im1: np.ndarray, im2: np.ndarray, y1: int, x1: int, y2: int, x2: int, bs: int) -> int:
    """cv::norm(block1, block2, NORM_L1) on uint8 blocks (``:315`` et al.)."""
    a = im1[y1 : y1 + bs, x1 : x1 + bs].astype(np.int64)
    b = im2[y2 : y2 + bs, x2 : x2 + bs].astype(np.int64)
    return int(np.abs(a - b).sum())


def find_min_block_spiral(
    im1: np.ndarray,
    im2: np.ndarray,
    y1: int,
    x1: int,
    y2: int,
    x2: int,
    block_size: int,
    search_size: int,
) -> tuple[int, int]:
    """The spiral search (``motion_framework.cpp:296-422``); returns (min_y, min_x)."""
    shift = search_size - block_size
    height, width = im1.shape

    if x2 < 0 or y2 < 0 or x2 + block_size > width or y2 + block_size > height:
        return y1, x1  # zero-MV early-out (:304-310)

    min_x, min_y = x2, y2
    sad_min = _sad(im1, im2, y1, x1, y2, x2, block_size)
    l, k = x2, y2

    def probe(l: int, k: int) -> None:
        nonlocal sad_min, min_x, min_y
        if l < 0 or k < 0 or l + block_size > width or k + block_size > height:
            return  # skipped, but cursor already advanced (:335-336)
        sad = _sad(im1, im2, y1, x1, k, l, block_size)
        if sad < sad_min:
            sad_min, min_x, min_y = sad, l, k

    m = 1
    while m < shift:
        for _ in range(m):
            l += 1
            probe(l, k)
        for _ in range(m):
            k += 1
            probe(l, k)
        for _ in range(m + 1):
            l -= 1
            probe(l, k)
        for _ in range(m + 1):
            k -= 1
            probe(l, k)
        m += 2
    for _ in range(max(0, m - 1)):
        l += 1
        probe(l, k)
    return min_y, min_x


def find_min_block_raster(
    im1: np.ndarray,
    im2: np.ndarray,
    y1: int,
    x1: int,
    y2: int,
    x2: int,
    block_size: int,
    search_size: int,
) -> tuple[int, int]:
    """The exhaustive raster search (``motion_framework.cpp:246-294``).

    The reference's dead code path: full scan of the clipped half-shift
    window; strict-< SAD wins, equal SAD broken by smaller L1 distance of the
    position to the SOURCE block (``:276-281``), further ties keep the first
    raster visit.  An empty clipped window returns the (unclamped) predicted
    position with no search - there is no zero-MV early-out here.
    """
    start_pos = (search_size - block_size) >> 1
    height, width = im1.shape
    sad_min = np.iinfo(np.int64).max
    min_x, min_y = x2, y2
    l1_dist = np.iinfo(np.int64).max
    for k in range(max(0, y2 - start_pos), min(height - block_size + 1, y2 + start_pos + 1)):
        for l in range(max(0, x2 - start_pos), min(width - block_size + 1, x2 + start_pos + 1)):
            sad = _sad(im1, im2, y1, x1, k, l, block_size)
            d = abs(x1 - l) + abs(y1 - k)
            if sad < sad_min or (sad == sad_min and d < l1_dist):
                sad_min, min_x, min_y, l1_dist = sad, l, k, d
    return min_y, min_x


def calc_level_bm(
    im1: np.ndarray,
    im2: np.ndarray,
    flow: np.ndarray,
    block_size: int,
    search_size: int,
    order: str = "spiral",
) -> None:
    """Per-level block-matching sweep, in place (``:226-244``)."""
    height, width = im1.shape
    finder = find_min_block_spiral if order == "spiral" else find_min_block_raster
    for i in range(0, height, block_size):
        for j in range(0, width, block_size):
            x2 = j + int(flow[i, j, 0])  # (int) truncation toward zero (:233-234)
            y2 = i + int(flow[i, j, 1])
            min_y, min_x = finder(
                im1, im2, i, j, y2, x2, block_size, search_size
            )
            flow[i, j, 0] = np.float32(min_x - j)
            flow[i, j, 1] = np.float32(min_y - i)


# Candidate orderings per border case (``motion_framework.cpp:439-522``), as
# (dy, dx) offsets in block units.  Own MV is always first.
_INTERIOR = [(0, 0), (0, -1), (0, 1), (1, 1), (-1, -1), (-1, 1), (-1, 0), (1, 0), (1, -1)]
_TOP = [(0, 0), (0, -1), (0, 1), (1, 1), (1, 0), (1, -1)]
_BOTTOM = [(0, 0), (0, -1), (0, 1), (-1, -1), (-1, 1), (-1, 0)]
_LEFT = [(0, 0), (0, 1), (1, 1), (-1, 1), (-1, 0), (1, 0)]
_RIGHT = [(0, 0), (0, -1), (-1, -1), (-1, 0), (1, 0), (1, -1)]
_TOPLEFT = [(0, 0), (0, 1), (1, 1), (1, 0)]
_TOPRIGHT = [(0, 0), (0, -1), (1, 0), (1, -1)]
_BOTTOMLEFT = [(0, 0), (0, 1), (-1, 1), (-1, 0)]
_BOTTOMRIGHT = [(0, 0), (0, -1), (-1, -1), (-1, 0)]


def candidate_offsets(i: int, j: int, bs: int, height: int, width: int):
    """Select the border case, preserving the reference's if-chain order."""
    if i - bs >= 0 and j - bs >= 0 and j + bs < width and i + bs < height:
        return _INTERIOR
    if j - bs >= 0 and j + bs < width and i == 0:
        return _TOP
    if j - bs >= 0 and j + bs < width and i == height - bs:
        return _BOTTOM
    if j == 0 and i - bs >= 0 and i + bs < height:
        return _LEFT
    if j == width - bs and i - bs >= 0 and i + bs < height:
        return _RIGHT
    if i == 0 and j == 0:
        return _TOPLEFT
    if i == 0:
        return _TOPRIGHT
    if j == 0:
        return _BOTTOMLEFT
    return _BOTTOMRIGHT


def regularize_mvs(
    im1: np.ndarray,
    im2: np.ndarray,
    flow: np.ndarray,
    block_size: int,
    lam: float,
    lambda_multiplier: int,
) -> None:
    """One in-place Gauss-Seidel regularization sweep (``:424-530``)."""
    height, width = im1.shape
    if height < 2 * block_size or width < 2 * block_size:
        # the reference's corner candidate lists (:492-522) unconditionally
        # read the right/bottom neighbor, which on a <2x2 block grid is an
        # out-of-bounds cv::Mat::at (UB upstream - its Middlebury inputs
        # never pad below 2x2 at the coarsest level); fail loudly instead
        raise ValueError(
            f"block grid below 2x2 ({height}x{width} px at block "
            f"{block_size}) is outside the reference's defined envelope"
        )
    flt_max = np.finfo(np.float32).max
    for i in range(0, height, block_size):
        for j in range(0, width, block_size):
            offs = candidate_offsets(i, j, block_size, height, width)
            cands = [flow[i + dy * block_size, j + dx * block_size].copy() for dy, dx in offs]
            # find_min_candidate (:532-621)
            energies = []
            for c in cands:
                x2 = j + int(c[0])
                y2 = i + int(c[1])
                if x2 < 0 or x2 > width - block_size or y2 < 0 or y2 > height - block_size:
                    energies.append(flt_max)
                    continue
                sad = _sad(im1, im2, i, j, y2, x2, block_size)
                smooth = np.float32(0.0)
                for other in cands:  # calculate_smoothness (:623-644)
                    smooth += np.float32(abs(other[0] - c[0]) + abs(other[1] - c[1]))
                energies.append(
                    np.float32(sad) + np.float32(lam) * np.float32(lambda_multiplier) * smooth
                )
            # min_energy_candidate: first strict minimum (:646-662)
            min_pos = 0
            min_val = energies[0]
            for idx in range(1, len(energies)):
                if energies[idx] < min_val:
                    min_val = energies[idx]
                    min_pos = idx
            flow[i, j] = cands[min_pos]


def divide_blocks(flow: np.ndarray, block_size: int) -> None:
    """Copy each block's MV to its three half-size children (``:845-862``)."""
    half = block_size >> 1
    height, width = flow.shape[:2]
    for i in range(0, height, block_size):
        for j in range(0, width, block_size):
            mv = flow[i, j].copy()
            flow[i + half, j] = mv
            flow[i, j + half] = mv
            flow[i + half, j + half] = mv


def fill_block_mv(flow: np.ndarray, i: int, j: int, block_size: int, mv: np.ndarray) -> None:
    flow[i : i + block_size, j : j + block_size] = mv


def copy_mvs(flow_coarse: np.ndarray, flow_fine: np.ndarray, coarse_bs: int) -> None:
    """Cross-level MV transfer: x2 magnitude, fill 2bs square (``:828-843``)."""
    h, w = flow_coarse.shape[:2]
    for i in range(0, h, coarse_bs):
        for j in range(0, w, coarse_bs):
            mv = flow_coarse[i, j] * np.float32(2.0)
            fill_block_mv(flow_fine, i << 1, j << 1, coarse_bs << 1, mv)


def copy_to_all_pixels(flow: np.ndarray, block_size: int) -> None:
    """Final densification (``:815-826``)."""
    h, w = flow.shape[:2]
    for i in range(0, h, block_size):
        for j in range(0, w, block_size):
            fill_block_mv(flow, i, j, block_size, flow[i, j].copy())


def calc_motion_block_matching(
    image1_pad: np.ndarray, image2_pad: np.ndarray, cfg: MotionConfig
) -> np.ndarray:
    """The full coarse-to-fine engine on pre-padded frames (``:113-219``).

    Returns the dense per-pixel flow of the padded frame (CV_32FC2 analogue).
    """
    pyr1 = build_pyramid(image1_pad, cfg.num_levels)
    pyr2 = build_pyramid(image2_pad, cfg.num_levels)
    flows = [
        np.zeros((p.shape[0], p.shape[1], 2), dtype=np.float32) for p in pyr1
    ]

    for level in range(cfg.num_levels - 1, -1, -1):
        im1, im2, flow = pyr1[level], pyr2[level], flows[level]
        if level < cfg.num_levels - 1:
            copy_mvs(flows[level + 1], flow, cfg.block_sizes[level + 1])
        calc_level_bm(
            im1, im2, flow, cfg.block_sizes[level], cfg.search_sizes[level],
            order=cfg.search_order,
        )

        bs = cfg.block_sizes[level]
        lam = np.float32(cfg.block_sizes[level] // 2)  # (float)(bs / 2), :73
        while bs > 1:
            for sweep in range(cfg.sweeps_per_round):
                regularize_mvs(im1, im2, flow, bs, lam, sweep + 1)
            divide_blocks(flow, bs)
            bs >>= 1
            lam = lam * np.float32(2.0)

    copy_to_all_pixels(flows[0], 2)  # :205-206
    return flows[0]


def resize_x4_u8(image: np.ndarray, factor: int) -> np.ndarray:
    """cv::resize INTER_LINEAR upscale used by the driver (``main_class.cpp:32-33``)."""
    import cv2

    return cv2.resize(image, None, fx=factor, fy=factor, interpolation=cv2.INTER_LINEAR)


def estimate_flow_driver(
    image1: np.ndarray, image2: np.ndarray, cfg: MotionConfig
) -> np.ndarray:
    """Full driver scenario (``main_class.cpp:6-85``): upsample, estimate,
    subsample/rescale back to original resolution.  Returns (H, W, 2) f32."""
    orig_h, orig_w = image1.shape
    f = cfg.interp_factor
    if f > 1:
        image1 = resize_x4_u8(image1, f)
        image2 = resize_x4_u8(image2, f)
    im1p, im2p, pad_y, pad_x, ph, pw = pad_images(image1, image2, cfg)
    flow_res = calc_motion_block_matching(im1p, im2p, cfg)
    # MV subsample/rescale loop (main_class.cpp:57-70)
    out = np.empty((orig_h, orig_w, 2), dtype=np.float32)
    for i in range(pad_y, ph - pad_y, f):
        for j in range(pad_x, pw - pad_x, f):
            out[(i - pad_y) // f, (j - pad_x) // f] = flow_res[i, j] / np.float32(f)
    return out
