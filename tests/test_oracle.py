"""Tests of the sequential NumPy/OpenCV oracle itself.

The oracle is the bit-exactness anchor for the JAX engine, so its own
subroutines are validated here: padding rule, spiral search vs a brute-force
re-simulation, shift recovery on synthetic translations, and driver plumbing.
"""

import numpy as np
import pytest

from blockbasedmotionestimation.config import MotionConfig, tiny_config
from blockbasedmotionestimation.models import oracle
from blockbasedmotionestimation.ops import spiral


def make_textured(rng, h, w):
    """Smooth-ish random texture so SAD landscapes have unique minima."""
    base = rng.integers(0, 256, size=(h // 4 + 2, w // 4 + 2)).astype(np.uint8)
    import cv2

    return cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC)


class TestPadding:
    def test_already_divisible(self):
        cfg = tiny_config(block_sizes=(8, 8), search_sizes=(16, 16))
        # needs h % 8 == 0 and h % 16 == 0
        assert oracle.find_padding(64, 48, cfg) == (64, 48)

    def test_round_up(self):
        cfg = tiny_config(block_sizes=(8, 8), search_sizes=(16, 16))
        assert oracle.find_padding(60, 41, cfg) == (64, 48)

    def test_middlebury_4x_dimetrodon(self):
        # 584x388 at 4x = 2336x1552; levels need divisibility by 2^3*32 = 256
        cfg = MotionConfig()
        assert oracle.find_padding(1552, 2336, cfg) == (1792, 2560)

    def test_unfindable_raises(self):
        cfg = tiny_config(block_sizes=(64, 64), search_sizes=(64, 64))
        # need multiple of 128; h=65 -> next is 128 but 128 < 2*65=130 so ok.
        # h=63 -> next multiple of 128 is 128 > 2*63=126 -> unreachable
        with pytest.raises(ValueError, match="Could not find"):
            oracle.find_padding(63, 256, cfg)


class TestSpiralSearchOracle:
    def test_matches_rank_argmin(self, rng):
        """Sequential walk == lexicographic (SAD, rank) argmin over the window."""
        bs, ss = 4, 12
        shift = ss - bs
        ext = spiral.spiral_extent(shift)
        rank = spiral.spiral_rank(shift)
        h, w = 32, 40
        im1 = rng.integers(0, 8, size=(h, w)).astype(np.uint8)  # low entropy -> many ties
        im2 = rng.integers(0, 8, size=(h, w)).astype(np.uint8)
        for y1, x1, y2, x2 in [(8, 8, 8, 8), (0, 0, 2, 1), (8, 8, 7, 9), (28, 36, 27, 35),
                               (8, 8, 0, 0), (8, 8, h - bs, w - bs)]:
            got = oracle.find_min_block_spiral(im1, im2, y1, x1, y2, x2, bs, ss)
            # brute-force lexicographic argmin
            best = None
            for dy in range(-ext, ext + 1):
                for dx in range(-ext, ext + 1):
                    ty, tx = y2 + dy, x2 + dx
                    if ty < 0 or tx < 0 or ty + bs > h or tx + bs > w:
                        continue
                    sad = oracle._sad(im1, im2, y1, x1, ty, tx, bs)
                    key = (sad, int(rank[dy + ext, dx + ext]))
                    if best is None or key < best[0]:
                        best = (key, (ty, tx))
            assert got == best[1], (y1, x1, y2, x2)

    def test_oob_center_early_out(self, rng):
        im = rng.integers(0, 256, size=(16, 16)).astype(np.uint8)
        assert oracle.find_min_block_spiral(im, im, 4, 4, -1, 4, 4, 8) == (4, 4)
        assert oracle.find_min_block_spiral(im, im, 4, 4, 4, 13, 4, 8) == (4, 4)


class TestEndToEnd:
    def test_recovers_global_shift(self, rng):
        """frame2 = frame1 shifted by (+3, -2) -> flow should be ~(-3, +2)...

        Flow convention: flow = matched_pos_in_frame2 - pos_in_frame1, so if
        frame2 content moved right by sx, blocks match at +sx: flow u = +sx
        when frame2(x) = frame1(x - sx).
        """
        h, w = 64, 64
        sx, sy = 3, -2
        big = make_textured(rng, h + 16, w + 16)
        im1 = big[8 : 8 + h, 8 : 8 + w]
        im2 = big[8 - sy : 8 - sy + h, 8 - sx : 8 - sx + w]
        cfg = tiny_config(block_sizes=(8, 8), search_sizes=(16, 16))
        im1p, im2p, py, px, ph, pw = oracle.pad_images(im1, im2, cfg)
        flow = oracle.calc_motion_block_matching(im1p, im2p, cfg)
        # interior pixels (away from zero-padding effects) should be exact
        interior = flow[16:-16, 16:-16]
        frac_exact = np.mean(
            (interior[..., 0] == sx) & (interior[..., 1] == sy)
        )
        assert frac_exact > 0.9, frac_exact

    def test_driver_shapes_and_scale(self, rng):
        h, w = 24, 30
        im1 = make_textured(rng, h, w)
        im2 = np.roll(im1, (0, 1), axis=(0, 1))
        cfg = tiny_config(block_sizes=(8,), search_sizes=(16,), interp_factor=2)
        out = oracle.estimate_flow_driver(im1, im2, cfg)
        assert out.shape == (h, w, 2)
        # engine works at 2x, so output MVs are multiples of 0.5
        assert np.all((out * 2) == np.round(out * 2))

    def test_flow_is_integer_valued_at_unit_interp(self, rng):
        im1 = make_textured(rng, 32, 32)
        im2 = make_textured(rng, 32, 32)
        cfg = tiny_config(block_sizes=(8,), search_sizes=(16,))
        out = oracle.estimate_flow_driver(im1, im2, cfg)
        assert np.all(out == np.round(out))
