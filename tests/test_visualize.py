"""Diagnostics: MV dump, overlay, and motion compensation."""

import numpy as np

from blockbasedmotionestimation.utils import visualize


def test_dump_flow_text(tmp_path):
    flow = np.zeros((2, 3, 2), dtype=np.float32)
    flow[0, 1] = (1.5, -2.0)
    p = tmp_path / "debug.txt"
    visualize.dump_flow_text(flow, p)
    lines = p.read_text().splitlines()
    assert len(lines) == 2
    assert "(1.5, -2)" in lines[0]


def test_motion_compensation_exact_for_translation(rng):
    base = rng.integers(0, 256, size=(48, 64), dtype=np.uint8)
    im1 = base[8:40, 8:56]
    im2 = base[6:38, 11:59]  # im1 content at (y+2, x-3) in im2
    flow = np.zeros((32, 48, 2), dtype=np.float32)
    flow[..., 0] = -3.0
    flow[..., 1] = 2.0
    rec = visualize.motion_compensate(im2, flow, block_size=4)
    # interior blocks whose target stays in-bounds reconstruct im1 exactly
    np.testing.assert_array_equal(rec[4:28, 4:44], im1[4:28, 4:44])
    # the true flow compensates far better than assuming zero motion
    zero = np.zeros_like(flow)
    assert (
        visualize.compensation_error(im1, im2, flow, 4)
        < 0.5 * visualize.compensation_error(im1, im2, zero, 4)
    )


def test_mv_overlay_draws_segments(rng):
    img = np.zeros((32, 32), dtype=np.uint8)
    flow = np.zeros((32, 32, 2), dtype=np.float32)
    flow[..., 0] = 5.0  # horizontal MVs
    out = visualize.draw_mv_overlay(img, flow, block_size=8)
    assert out.shape == (32, 32, 3)
    # red segment pixels exist to the right of each origin
    assert (out[0, 1:6] == (255, 0, 0)).all()
    assert tuple(out[0, 0]) == (0, 255, 0)
