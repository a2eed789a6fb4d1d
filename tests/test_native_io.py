"""Native C++ I/O runtime vs the pure-Python codecs."""

import numpy as np
import pytest

from blockbasedmotionestimation.utils import flowio, native_io

pytestmark = pytest.mark.skipif(
    not native_io.available(), reason="native library failed to build"
)


def test_flo_roundtrip_native(tmp_path, rng):
    flow = rng.standard_normal((24, 32, 2)).astype(np.float32)
    p = tmp_path / "x.flo"
    native_io.write_flo(p, flow)
    np.testing.assert_array_equal(native_io.read_flo(p), flow)
    # cross-compat with the Python codec both ways
    np.testing.assert_array_equal(flowio.read_flo(p), flow)
    p2 = tmp_path / "y.flo"
    flowio.write_flo(p2, flow)
    np.testing.assert_array_equal(native_io.read_flo(p2), flow)


def test_flo_batch_read(tmp_path, rng):
    flows = [rng.standard_normal((12, 16, 2)).astype(np.float32) for _ in range(5)]
    paths = []
    for i, f in enumerate(flows):
        p = tmp_path / f"{i}.flo"
        native_io.write_flo(p, f)
        paths.append(p)
    batch = native_io.read_flo_batch(paths, nthreads=3)
    np.testing.assert_array_equal(batch, np.stack(flows))


def test_flo_errors(tmp_path):
    p = tmp_path / "bad.flo"
    p.write_bytes(b"JUNKJUNKJUNK")
    with pytest.raises(native_io.NativeIOError):
        native_io.read_flo(p)
    with pytest.raises(native_io.NativeIOError):
        native_io.read_flo(tmp_path / "missing.flo")


def test_pgm_roundtrip(tmp_path, rng):
    img = rng.integers(0, 256, size=(17, 23), dtype=np.uint8)
    p = tmp_path / "x.pgm"
    native_io.write_pgm(p, img)
    np.testing.assert_array_equal(native_io.read_pgm(p), img)


def test_pgm_ascii_and_comments(tmp_path):
    img = np.arange(12, dtype=np.uint8).reshape(3, 4)
    p = tmp_path / "a.pgm"
    body = " ".join(str(v) for v in img.ravel())
    p.write_text(f"P2\n# a comment\n4 3\n255\n{body}\n")
    np.testing.assert_array_equal(native_io.read_pgm(p), img)


def test_native_epe_matches_python(rng):
    gt = rng.standard_normal((20, 30, 2)).astype(np.float32)
    fl = rng.standard_normal((20, 30, 2)).astype(np.float32)
    gt[3, 4] = 1e10  # unknown-flow pixel must be excluded
    want = flowio.average_epe(gt, fl)
    got = native_io.average_epe(gt, fl)
    assert abs(want - got) < 1e-6


def test_reference_gt_files_native():
    import os

    path = "/root/reference/middlebury/gt-flow/Dimetrodon/flow10.flo"
    if not os.path.exists(path):
        pytest.skip("reference gt-flow not mounted")
    a = native_io.read_flo(path)
    b = flowio.read_flo(path)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (388, 584, 2)


# ---- PNG / Targa codecs (imageLib ImageIOpng.cpp / ImageIO.cpp analogues) ----


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_roundtrip(tmp_path, rng, channels):
    shape = (19, 27) if channels == 1 else (19, 27, channels)
    img = rng.integers(0, 256, size=shape, dtype=np.uint8)
    p = tmp_path / "x.png"
    native_io.write_png(p, img)
    np.testing.assert_array_equal(native_io.read_png(p), img)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_png_native_read_matches_pil(tmp_path, rng, mode):
    from PIL import Image

    ch = {"L": 1, "RGB": 3, "RGBA": 4}[mode]
    shape = (23, 31) if ch == 1 else (23, 31, ch)
    img = rng.integers(0, 256, size=shape, dtype=np.uint8)
    p = tmp_path / "pil.png"
    Image.fromarray(img, mode=mode).save(p)
    np.testing.assert_array_equal(native_io.read_png(p), img)


def test_png_native_write_read_by_pil(tmp_path, rng):
    from PIL import Image

    img = rng.integers(0, 256, size=(14, 18, 3), dtype=np.uint8)
    p = tmp_path / "ours.png"
    native_io.write_png(p, img)
    np.testing.assert_array_equal(np.asarray(Image.open(p)), img)


def test_png_filtered_encodings_decode(tmp_path):
    # libpng/PIL pick Sub/Up/Average/Paeth adaptively on smooth content;
    # a diagonal gradient forces non-None filters through the unfilter path.
    y, x = np.mgrid[0:64, 0:80]
    img = ((y * 3 + x * 2) % 256).astype(np.uint8)
    p = tmp_path / "grad.png"
    try:
        import cv2

        cv2.imwrite(str(p), img)
    except ImportError:
        from PIL import Image

        Image.fromarray(img).save(p, optimize=True)
    np.testing.assert_array_equal(native_io.read_png(p), img)


def test_png_rejects_palette(tmp_path, rng):
    from PIL import Image

    img = rng.integers(0, 256, size=(8, 8, 3), dtype=np.uint8)
    p = tmp_path / "pal.png"
    Image.fromarray(img).convert("P").save(p)
    with pytest.raises(native_io.NativeIOError, match="unsupported"):
        native_io.read_png(p)


def test_png_rejects_truncated(tmp_path, rng):
    img = rng.integers(0, 256, size=(16, 16), dtype=np.uint8)
    p = tmp_path / "t.png"
    native_io.write_png(p, img)
    data = p.read_bytes()
    p.write_bytes(data[: len(data) - 20])
    with pytest.raises(native_io.NativeIOError):
        native_io.read_png(p)


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("rle", [False, True])
def test_tga_roundtrip(tmp_path, rng, channels, rle):
    shape = (13, 21) if channels == 1 else (13, 21, channels)
    img = rng.integers(0, 256, size=shape, dtype=np.uint8)
    p = tmp_path / "x.tga"
    native_io.write_tga(p, img, rle=rle)
    np.testing.assert_array_equal(native_io.read_tga(p), img)


def test_tga_rle_compresses_runs(tmp_path):
    img = np.full((32, 64, 3), 200, dtype=np.uint8)
    raw, packed = tmp_path / "raw.tga", tmp_path / "rle.tga"
    native_io.write_tga(raw, img, rle=False)
    native_io.write_tga(packed, img, rle=True)
    assert packed.stat().st_size < raw.stat().st_size / 10
    np.testing.assert_array_equal(native_io.read_tga(packed), img)


def test_tga_bottom_up_and_pil_interop(tmp_path, rng):
    from PIL import Image

    img = rng.integers(0, 256, size=(11, 17, 3), dtype=np.uint8)
    p = tmp_path / "pil.tga"
    Image.fromarray(img).save(p)  # PIL writes bottom-up origin
    np.testing.assert_array_equal(native_io.read_tga(p), img)
    q = tmp_path / "ours.tga"
    native_io.write_tga(q, img, rle=True)
    np.testing.assert_array_equal(np.asarray(Image.open(q)), img)


def test_write_image_gray_png_native_fallback(tmp_path, rng):
    img = rng.integers(0, 256, size=(9, 12), dtype=np.uint8)
    p = tmp_path / "g.png"
    native_io.write_png(p, img)
    np.testing.assert_array_equal(flowio.read_gray(p), img)
