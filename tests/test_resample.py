"""OpenCV parity tests for the pure-JAX resampling ops."""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from blockbasedmotionestimation.ops import resample


@pytest.mark.parametrize("shape", [(8, 8), (32, 48), (64, 64), (100, 124), (388 + 0, 584 + 0)])
def test_pyrdown_matches_opencv(rng, shape):
    h, w = shape
    if h % 2 or w % 2:
        pytest.skip("even dims only")
    img = rng.integers(0, 256, size=(h, w), dtype=np.uint8)
    want = cv2.pyrDown(img, dstsize=(w // 2, h // 2))
    got = np.asarray(resample.pyrdown_u8(img))
    np.testing.assert_array_equal(got, want)


def test_pyrdown_smooth_gradient(rng):
    img = np.tile(np.arange(64, dtype=np.uint8), (64, 1))
    want = cv2.pyrDown(img)
    got = np.asarray(resample.pyrdown_u8(img))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("factor", [2, 3, 4])
@pytest.mark.parametrize("shape", [(16, 16), (37, 53), (97, 146)])
def test_resize_upscale_matches_opencv(rng, shape, factor):
    h, w = shape
    img = rng.integers(0, 256, size=(h, w), dtype=np.uint8)
    want = cv2.resize(img, None, fx=factor, fy=factor, interpolation=cv2.INTER_LINEAR)
    got = np.asarray(resample.resize_scale_u8(img, factor))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dst", [(31, 45), (64, 64), (150, 90)])
def test_resize_arbitrary_matches_opencv(rng, dst):
    img = rng.integers(0, 256, size=(48, 72), dtype=np.uint8)
    dh, dw = dst
    want = cv2.resize(img, (dw, dh), interpolation=cv2.INTER_LINEAR)
    got = np.asarray(resample.resize_linear_u8(img, dh, dw))
    np.testing.assert_array_equal(got, want)


def test_resize_driver_size(rng):
    # the reference driver path: Middlebury-sized frame x4
    img = rng.integers(0, 256, size=(97, 146), dtype=np.uint8)
    want = cv2.resize(img, None, fx=4, fy=4, interpolation=cv2.INTER_LINEAR)
    got = np.asarray(resample.resize_scale_u8(img, 4))
    np.testing.assert_array_equal(got, want)


def test_build_pyramid_levels(rng):
    img = rng.integers(0, 256, size=(64, 96), dtype=np.uint8)
    pyr = resample.build_pyramid(img, 3)
    assert [p.shape for p in pyr] == [(64, 96), (32, 48), (16, 24)]
    np.testing.assert_array_equal(np.asarray(pyr[1]), cv2.pyrDown(img))
    np.testing.assert_array_equal(np.asarray(pyr[2]), cv2.pyrDown(cv2.pyrDown(img)))
