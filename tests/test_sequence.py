"""Sequence runner: per-pair checkpoints, resume, report."""

import json
import os

import numpy as np

from blockbasedmotionestimation.config import MotionConfig
from blockbasedmotionestimation.models import sequence
from blockbasedmotionestimation.utils import flowio


def _frames(rng, n=4, h=24, w=32):
    m = 6
    base = rng.integers(0, 256, size=(h + 2 * m, w + 2 * m), dtype=np.uint8)
    return [base[m + i : m + i + h, m - i : m - i + w] for i in range(n)]


def test_sequence_writes_checkpoints_and_report(tmp_path, rng):
    cfg = MotionConfig(
        block_sizes=(4,), search_sizes=(8,), interp_factor=1, regularizer="fourcolor"
    )
    frames = _frames(rng)
    results = sequence.run_sequence(frames, tmp_path, cfg)
    assert len(results) == 3
    assert not any(r.skipped for r in results)
    for i in range(3):
        flow = flowio.read_flo(tmp_path / sequence.flo_name(i))
        assert flow.shape == (24, 32, 2)
    report = json.loads((tmp_path / "report.json").read_text())
    assert report["computed"] == 3 and report["resumed"] == 0


def test_sequence_resumes_after_partial_run(tmp_path, rng):
    cfg = MotionConfig(
        block_sizes=(4,), search_sizes=(8,), interp_factor=1, regularizer="fourcolor"
    )
    frames = _frames(rng)
    sequence.run_sequence(frames[:3], tmp_path, cfg)  # pairs 0, 1 done
    seen = []
    results = sequence.run_sequence(
        frames, tmp_path, cfg, progress=lambda r: seen.append(r.index)
    )
    assert [r.skipped for r in results] == [True, True, False]
    assert seen == [0, 1, 2]
    report = json.loads((tmp_path / "report.json").read_text())
    assert report["resumed"] == 2 and report["computed"] == 1


def test_no_torn_checkpoint_tmp_left(tmp_path, rng):
    cfg = MotionConfig(
        block_sizes=(4,), search_sizes=(8,), interp_factor=1, regularizer="fourcolor"
    )
    sequence.run_sequence(_frames(rng, n=2), tmp_path, cfg)
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]


def test_sequence_batched_matches_single(tmp_path, rng):
    from blockbasedmotionestimation.config import tiny_config
    from blockbasedmotionestimation.models import sequence

    cfg = tiny_config(block_sizes=(8,), search_sizes=(16,), regularizer="windowed")
    frames = [rng.integers(0, 256, size=(48, 64), dtype=np.uint8) for _ in range(5)]
    d1, d2 = tmp_path / "single", tmp_path / "batched"
    sequence.run_sequence(frames, d1, cfg)
    r = sequence.run_sequence(frames, d2, cfg, batch_size=3)
    assert [x.index for x in r] == [0, 1, 2, 3]
    from blockbasedmotionestimation.utils import flowio
    for i in range(4):
        a = flowio.read_flo(str(d1 / sequence.flo_name(i)))
        b = flowio.read_flo(str(d2 / sequence.flo_name(i)))
        np.testing.assert_array_equal(a, b)


def test_sequence_out_stride_and_f16(tmp_path, rng):
    # on-device subsampling + f16 transfer (the 4K D2H-tax controls): the
    # checkpoint holds exactly the full field subsampled at the stride, and
    # f16 is lossless for quarter-pel production-range values
    from blockbasedmotionestimation.config import tiny_config
    from blockbasedmotionestimation.utils import flowio

    cfg = tiny_config(block_sizes=(8,), search_sizes=(16,), regularizer="windowed")
    frames = [rng.integers(0, 256, size=(48, 64), dtype=np.uint8) for _ in range(3)]
    d1, d2 = tmp_path / "full", tmp_path / "sub"
    sequence.run_sequence(frames, d1, cfg)
    r = sequence.run_sequence(
        frames, d2, cfg, out_stride=2, transfer_dtype="f16"
    )
    assert [x.index for x in r] == [0, 1]
    for i in range(2):
        full = flowio.read_flo(str(d1 / sequence.flo_name(i)))
        sub = flowio.read_flo(str(d2 / sequence.flo_name(i)))
        assert sub.shape == (24, 32, 2)
        np.testing.assert_array_equal(sub, full[::2, ::2])
