"""Synthetic-warp evaluation against real Middlebury ground-truth geometry."""

import os

import numpy as np
import pytest

from blockbasedmotionestimation.config import MotionConfig
from blockbasedmotionestimation.models import evaluate
from blockbasedmotionestimation.utils import flowio, synth

GT_DIR = "/root/reference/middlebury/gt-flow"

needs_gt = pytest.mark.skipif(
    not os.path.isdir(GT_DIR), reason="reference gt-flow not mounted"
)


def test_warp_recovers_translation(rng):
    im2 = synth.textured_image(64, 80, rng)
    flow = np.zeros((64, 80, 2), dtype=np.float32)
    flow[..., 0], flow[..., 1] = 3.0, -2.0
    im1 = synth.warp_backward(im2, flow)
    # integer-flow warp == pure shift in the interior
    np.testing.assert_array_equal(im1[4:-4, 4:-4], im2[2:-6, 7:-1])


def test_textured_image_stats(rng):
    img = synth.textured_image(96, 128, rng)
    assert img.dtype == np.uint8
    assert img.std() > 20  # enough contrast to match blocks


@needs_gt
def test_dimetrodon_synth_epe_reasonable():
    # Real Dimetrodon GT geometry (584x388, max |flow| ~4.7px), synthesized
    # texture pair; a 2-level / 16px-block / 32px-search config must land
    # well under 1px average EPE on a brightness-constant pair.
    cfg = MotionConfig(
        block_sizes=(16, 16), search_sizes=(32, 32),
        interp_factor=1, regularizer="fourcolor",
    )
    r = evaluate.evaluate_sequence("Dimetrodon", GT_DIR, cfg)
    assert r.shape == (388, 584)
    assert r.epe < 1.0, f"EPE too high: {r.epe}"


@needs_gt
def test_report_formatting():
    cfg = MotionConfig(
        block_sizes=(16,), search_sizes=(24,), interp_factor=1,
        regularizer="fourcolor",
    )
    results = evaluate.evaluate_middlebury(GT_DIR, cfg, sequences=("Venus",))
    rep = evaluate.format_report(results)
    assert "Venus" in rep and "mean" in rep


@needs_gt
def test_production_robustness_envelope():
    # r2 VERDICT item 7 / r3 item 2: pin the production schedule's
    # photometric-robustness ENVELOPE in CI, so a rival/windowed regression
    # under brightness-constancy violations fails loudly.  The committed
    # full-config record is EVAL_robust.md; this is its fast sentinel
    # (2-level/16px quick config, 2 sequences, 3 nuisance points).
    #
    # The property pinned is RELATIVE: the production schedule (windowed +
    # rival r8) must track the unrestricted fourcolor baseline under
    # nuisance - absolute EPE legitimately explodes under gain/offset
    # (SAD has no photometric normalization, exactly like the reference's
    # cv::norm(NORM_L1) cost), but the windowed/rival restriction must not
    # ADD degradation beyond a small margin.
    base = MotionConfig(
        block_sizes=(16, 16), search_sizes=(32, 32), interp_factor=1,
        regularizer="windowed", rival_window=False, rival_radius=None,
    )
    prod = base.replace(rival_window=True, rival_radius=8)
    four = base.replace(regularizer="fourcolor")
    seqs = ("Dimetrodon", "Urban2")
    variants = {
        "clean": {},
        "noise_s8": {"noise_sigma": 8.0},
        "combined": {"gain": 1.06, "offset": 6.0, "noise_sigma": 4.0},
    }
    means = {}
    for cname, cfg in (("prod", prod), ("four", four)):
        for vname, kw in variants.items():
            epes = [
                evaluate.evaluate_sequence_photometric(
                    s, GT_DIR, cfg, **kw
                ).epe
                for s in seqs
            ]
            means[cname, vname] = float(np.mean(epes))
    # production tracks the unrestricted baseline under every nuisance
    for vname in variants:
        assert means["prod", vname] <= means["four", vname] + 0.05, (
            vname, means
        )
    # absolute envelopes (calibrated from the committed quick run, +margin)
    assert means["prod", "clean"] < 0.75, means
    assert means["prod", "noise_s8"] < 0.85, means
    # noise adds little: the degradation envelope itself is pinned
    assert means["prod", "noise_s8"] - means["prod", "clean"] < 0.15, means
