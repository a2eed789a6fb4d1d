"""CLI end-to-end: estimate/evaluate/colorize/legend subcommands."""

import numpy as np
import pytest

from blockbasedmotionestimation import cli
from blockbasedmotionestimation.utils import flowio


@pytest.fixture
def frames(tmp_path, rng):
    m = 8
    base = rng.integers(0, 256, size=(48 + 2 * m, 64 + 2 * m), dtype=np.uint8)
    im1 = base[m : m + 48, m : m + 64]
    im2 = base[m - 1 : m - 1 + 48, m + 2 : m + 2 + 64]
    p1, p2 = tmp_path / "f1.png", tmp_path / "f2.png"
    flowio.write_image(p1, im1)
    flowio.write_image(p2, im2)
    return p1, p2


def test_estimate_writes_flo_and_png(tmp_path, frames, capsys):
    p1, p2 = frames
    out = tmp_path / "flow.flo"
    png = tmp_path / "flow.png"
    rc = cli.main([
        "estimate", str(p1), str(p2), str(out), "--png", str(png),
        "--levels", "2", "--block", "4", "--search", "8", "--interp", "1",
    ])
    assert rc == 0
    assert "Seconds:" in capsys.readouterr().out
    flow = flowio.read_flo(out)
    assert flow.shape == (48, 64, 2)
    # the dominant motion is the planted translation (u=-2, v=+1)
    assert np.median(flow[..., 0]) == -2.0
    assert np.median(flow[..., 1]) == 1.0
    assert png.exists()


def test_estimate_with_gt_prints_epe(tmp_path, frames, capsys):
    p1, p2 = frames
    gt = np.zeros((48, 64, 2), dtype=np.float32)
    gt[..., 0], gt[..., 1] = -2.0, 1.0
    gt_path = tmp_path / "gt.flo"
    flowio.write_flo(gt_path, gt)
    rc = cli.main([
        "estimate", str(p1), str(p2), str(tmp_path / "o.flo"), "--gt", str(gt_path),
        "--levels", "2", "--block", "4", "--search", "8", "--interp", "1",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "The MSE is" in out  # reference print parity (main_class.cpp:82)


def test_evaluate_and_colorize_and_legend(tmp_path, rng, capsys):
    flow = rng.standard_normal((20, 30, 2)).astype(np.float32)
    fp = tmp_path / "f.flo"
    flowio.write_flo(fp, flow)
    assert cli.main(["evaluate", str(fp), str(fp)]) == 0
    assert "average EPE: 0.0" in capsys.readouterr().out

    png = tmp_path / "c.png"
    assert cli.main(["colorize", str(fp), str(png)]) == 0
    assert png.exists()

    legend = tmp_path / "l.png"
    assert cli.main(["legend", str(legend), "--range", "5"]) == 0
    assert legend.exists()


def test_graft_entry_single_chip():
    import __graft_entry__ as g
    import jax

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (96, 128, 2)


def test_cli_sequence(tmp_path, rng):
    from blockbasedmotionestimation import cli
    from blockbasedmotionestimation.utils import flowio

    m = 10
    base = rng.integers(0, 256, size=(48 + 2 * m, 64 + 2 * m), dtype=np.uint8)
    for k in range(3):
        flowio.write_image(
            str(tmp_path / f"f{k:03d}.png"), base[k : k + 48, 2 * k : 2 * k + 64]
        )
    out = tmp_path / "flows"
    rc = cli.main([
        "sequence", str(tmp_path / "f*.png"), str(out),
        "--levels", "1", "--block", "8", "--search", "16", "--interp", "1",
        "--regularizer", "windowed", "--batch", "2",
    ])
    assert rc == 0
    assert sorted(p.name for p in out.glob("*.flo")) == [
        "flow00000.flo", "flow00001.flo"
    ]
    f0 = flowio.read_flo(str(out / "flow00000.flo"))
    assert f0.shape == (48, 64, 2)
