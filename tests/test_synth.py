"""Seeded multi-motion synthetic geometry (utils.synth.multi_motion_*)."""

import numpy as np

from blockbasedmotionestimation.utils import synth


def test_multi_motion_flow_is_seeded():
    a = synth.multi_motion_flow(60, 80, seed=3)
    np.testing.assert_array_equal(a, synth.multi_motion_flow(60, 80, seed=3))
    assert not np.array_equal(a, synth.multi_motion_flow(60, 80, seed=4))
    assert a.shape == (60, 80, 2) and a.dtype == np.float32


def test_multi_motion_flow_regions():
    # several rigid motions, bounded, with whole-pixel and quarter-pel ones
    for seed in range(6):
        f = synth.multi_motion_flow(120, 160, seed=seed, max_motion=8)
        motions = np.unique(f.reshape(-1, 2), axis=0)
        assert 2 <= len(motions) <= 4, motions
        assert np.abs(f).max() <= 8
        assert (f * 4 == np.round(f * 4)).all()  # quarter-pel grid
    fracs = [
        (synth.multi_motion_flow(120, 160, seed=s) % 1 != 0).any()
        for s in range(6)
    ]
    assert any(fracs)  # some seed leaves a quarter-pel region visible


def test_multi_motion_pair_integer_regions_are_copies():
    # where the motion is whole-pixel and stays inside the frame, frame 1 is
    # an exact copy of frame 2 at the displaced position
    im1, im2, gt = synth.multi_motion_pair(96, 128, seed=1)
    assert im1.shape == im2.shape == (96, 128) and im1.dtype == np.uint8
    yy, xx = np.mgrid[0:96, 0:128]
    sy, sx = yy + gt[..., 1], xx + gt[..., 0]
    ok = (
        (gt % 1 == 0).all(-1)
        & (sy >= 0) & (sy <= 95) & (sx >= 0) & (sx <= 127)
    )
    assert ok.sum() > 1000
    np.testing.assert_array_equal(
        im1[ok], im2[sy[ok].astype(int), sx[ok].astype(int)]
    )
