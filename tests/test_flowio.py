"""Tests for .flo I/O, colorization, and EPE (rw_flow.cpp parity)."""

import struct

import numpy as np
import pytest

from blockbasedmotionestimation.utils import flowio, synth

# the Middlebury gt-flow sizes (height, width)
EXPECTED_DIMS = {
    "Dimetrodon": (388, 584),
    "Hydrangea": (388, 584),
    "RubberWhale": (388, 584),
    "Venus": (380, 420),
    "Grove2": (480, 640),
    "Grove3": (480, 640),
    "Urban2": (480, 640),
    "Urban3": (480, 640),
}


def test_roundtrip(tmp_path, rng):
    flow = rng.normal(size=(17, 23, 2)).astype(np.float32)
    path = str(tmp_path / "t.flo")
    flowio.write_flo(path, flow)
    back = flowio.read_flo(path)
    np.testing.assert_array_equal(back, flow)


def test_reads_all_bundled_gt(tmp_path):
    # one seeded multi-motion field per Middlebury sequence size, with an
    # unknown-flow band, written as .flo and read back bit for bit
    for k, (seq, dims) in enumerate(sorted(EXPECTED_DIMS.items())):
        gt = synth.multi_motion_flow(*dims, seed=k)
        gt[: dims[0] // 10] = 1e10  # unknown flow (> UNKNOWN_FLOW_THRESH)
        path = str(tmp_path / f"{seq}.flo")
        flowio.write_flo(path, gt)
        flow = flowio.read_flo(path)
        assert flow.shape[:2] == dims, seq
        assert flow.dtype == np.float32
        np.testing.assert_array_equal(flow, gt)
        known = ~flowio.unknown_flow_mask(flow)
        assert 0 < known.sum() < known.size


def test_bad_tag(tmp_path):
    path = str(tmp_path / "bad.flo")
    with open(path, "wb") as f:
        f.write(struct.pack("<fii", 1.0, 4, 4))
        f.write(b"\0" * (4 * 4 * 8))
    with pytest.raises(flowio.FlowIOError, match="wrong tag"):
        flowio.read_flo(path)


def test_bad_dims(tmp_path):
    path = str(tmp_path / "bad.flo")
    with open(path, "wb") as f:
        f.write(flowio.TAG_STRING)
        f.write(struct.pack("<ii", 0, 4))
    with pytest.raises(flowio.FlowIOError, match="illegal width"):
        flowio.read_flo(path)


def test_too_short_too_long(tmp_path):
    path = str(tmp_path / "s.flo")
    with open(path, "wb") as f:
        f.write(flowio.TAG_STRING)
        f.write(struct.pack("<ii", 4, 4))
        f.write(b"\0" * (4 * 4 * 8 - 4))
    with pytest.raises(flowio.FlowIOError, match="too short"):
        flowio.read_flo(path)
    with open(path, "wb") as f:
        f.write(flowio.TAG_STRING)
        f.write(struct.pack("<ii", 4, 4))
        f.write(b"\0" * (4 * 4 * 8 + 4))
    with pytest.raises(flowio.FlowIOError, match="too long"):
        flowio.read_flo(path)


def test_wrong_extension(tmp_path):
    with pytest.raises(flowio.FlowIOError, match="extension"):
        flowio.read_flo(str(tmp_path / "x.png"))
    with pytest.raises(flowio.FlowIOError, match="extension"):
        flowio.write_flo(str(tmp_path / "x.png"), np.zeros((2, 2, 2), np.float32))


def test_unknown_flow_threshold():
    assert flowio.unknown_flow(1e9 + 1, 0.0)
    assert not flowio.unknown_flow(1e9, 0.0)  # strict > threshold
    assert flowio.unknown_flow(0.0, -2e9)
    assert flowio.unknown_flow(np.nan, 0.0)


def test_colorwheel_reference_values():
    wheel = flowio.make_colorwheel()
    assert wheel.shape == (55, 3)
    # spot values derived from the construction loops (rw_flow.cpp:294-299)
    np.testing.assert_array_equal(wheel[0], (255, 0, 0))  # pure red
    np.testing.assert_array_equal(wheel[14], (255, 255 * 14 // 15, 0))
    np.testing.assert_array_equal(wheel[15], (255, 255, 0))  # yellow start
    np.testing.assert_array_equal(wheel[21], (0, 255, 0))  # green start
    np.testing.assert_array_equal(wheel[25], (0, 255, 255))  # cyan start
    np.testing.assert_array_equal(wheel[36], (0, 0, 255))  # blue start
    np.testing.assert_array_equal(wheel[49], (255, 0, 255))  # magenta start


def test_compute_color_zero_flow_is_white_ish():
    # rad = 0 -> col = 1 - 0*(1-col) = 1 -> 255 everywhere
    rgb = flowio.compute_color(np.float32(0), np.float32(0))
    np.testing.assert_array_equal(rgb, (255, 255, 255))


def test_flow_to_color_unknown_black():
    flow = np.zeros((2, 2, 2), np.float32)
    flow[0, 0] = (2e9, 0)
    rgb = flowio.flow_to_color(flow)
    np.testing.assert_array_equal(rgb[0, 0], (0, 0, 0))
    assert rgb.shape == (2, 2, 3)


def test_flow_to_color_scaling_override():
    flow = np.zeros((1, 2, 2), np.float32)
    flow[0, 1] = (1.0, 0.0)
    a = flowio.flow_to_color(flow)
    b = flowio.flow_to_color(flow, max_motion=2.0)
    assert not np.array_equal(a[0, 1], b[0, 1])


def test_color_legend_shape():
    img = flowio.color_legend(10)
    assert img.shape == (21, 21, 3)
    # center = zero flow = white
    np.testing.assert_array_equal(img[10, 10], (255, 255, 255))


def test_average_epe():
    gt = np.zeros((4, 4, 2), np.float32)
    fl = np.zeros((4, 4, 2), np.float32)
    fl[..., 0] = 3.0
    fl[..., 1] = 4.0
    assert flowio.average_epe(gt, fl) == pytest.approx(5.0)
    # unknown pixels excluded from both count and sum
    gt[0, 0] = (2e9, 0)
    fl[0, 0] = (123.0, 456.0)
    assert flowio.average_epe(gt, fl) == pytest.approx(5.0)
    assert flowio.calculate_mse is flowio.average_epe
