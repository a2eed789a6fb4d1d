"""Windowed (search-window-reuse) regularizer: equivalence + quality."""

import os

import numpy as np
import pytest

from blockbasedmotionestimation.config import MotionConfig
from blockbasedmotionestimation.models import engine
from blockbasedmotionestimation.utils import synth


def _pair(rng, h, w, dy=2, dx=-3, margin=10):
    base = rng.integers(0, 256, size=(h + 2 * margin, w + 2 * margin), dtype=np.uint8)
    return (
        base[margin : margin + h, margin : margin + w],
        base[margin + dy : margin + dy + h, margin + dx : margin + dx + w],
    )


def test_windowed_equals_fourcolor_when_deltas_small(rng):
    # uniform translation: in the interior every candidate delta is far below
    # the radius, so windowed must be BIT-IDENTICAL to fourcolor there (the
    # zero-padding border can seed junk MVs whose neighbor deltas exceed R,
    # the documented deviation)
    cfg4 = MotionConfig(
        block_sizes=(8, 8), search_sizes=(24, 24), interp_factor=1,
        regularizer="fourcolor",
    )
    cfgw = cfg4.replace(regularizer="windowed")
    im1, im2 = _pair(rng, 64, 64, dy=1, dx=-2)
    a = np.asarray(engine.estimate_flow_driver(im1, im2, cfg4))
    b = np.asarray(engine.estimate_flow_driver(im1, im2, cfgw))
    np.testing.assert_array_equal(a[16:-16, 16:-16], b[16:-16, 16:-16])
    assert (a == b).all(axis=-1).mean() > 0.9


def test_windowed_single_level_equals_fourcolor_exactly(rng):
    # with ONE level the prediction is zero everywhere, so every candidate
    # (a neighbor's winner, |mv| <= R by construction) is structurally
    # in-window: windowed must equal fourcolor bit for bit, no tolerance
    cfg4 = MotionConfig(
        block_sizes=(8,), search_sizes=(24,), interp_factor=1,
        regularizer="fourcolor",
    )
    cfgw = cfg4.replace(regularizer="windowed")
    im1 = rng.integers(0, 256, size=(64, 64), dtype=np.uint8)
    im2 = rng.integers(0, 256, size=(64, 64), dtype=np.uint8)
    a = np.asarray(engine.estimate_flow_driver(im1, im2, cfg4))
    b = np.asarray(engine.estimate_flow_driver(im1, im2, cfgw))
    np.testing.assert_array_equal(a, b)


def test_windowed_random_frames_close_to_fourcolor(rng):
    # independent random frames, TWO levels (the coarse prediction makes
    # exclusions real): fields may differ at excluded-candidate blocks but
    # must agree almost everywhere; rival windows must agree even closer.
    # Measured minima over seeds: windowed 0.943, rival 0.972 (r2 VERDICT
    # item 8: thresholds tightened from the old trivially-passing 0.85).
    cfg4 = MotionConfig(
        block_sizes=(8, 8), search_sizes=(24, 24), interp_factor=1,
        regularizer="fourcolor",
    )
    im1 = rng.integers(0, 256, size=(64, 64), dtype=np.uint8)
    im2 = rng.integers(0, 256, size=(64, 64), dtype=np.uint8)
    a = np.asarray(engine.estimate_flow_driver(im1, im2, cfg4))
    w = np.asarray(
        engine.estimate_flow_driver(im1, im2, cfg4.replace(regularizer="windowed"))
    )
    frac_w = (a == w).all(axis=-1).mean()
    assert frac_w > 0.92, frac_w
    riv = np.asarray(
        engine.estimate_flow_driver(
            im1, im2, cfg4.replace(regularizer="windowed", rival_window=True)
        )
    )
    frac_r = (a == riv).all(axis=-1).mean()
    assert frac_r > 0.96, frac_r
    assert frac_r >= frac_w, (frac_r, frac_w)


@pytest.mark.skipif(
    not os.path.isdir("/root/reference/middlebury/gt-flow"),
    reason="reference gt-flow not mounted",
)
def test_windowed_epe_matches_fourcolor_on_dimetrodon():
    from blockbasedmotionestimation.models import evaluate

    cfg4 = MotionConfig(
        block_sizes=(16, 16), search_sizes=(32, 32), interp_factor=1,
        regularizer="fourcolor",
    )
    cfgw = cfg4.replace(regularizer="windowed")
    gt_dir = "/root/reference/middlebury/gt-flow"
    e4 = evaluate.evaluate_sequence("Dimetrodon", gt_dir, cfg4).epe
    ew = evaluate.evaluate_sequence("Dimetrodon", gt_dir, cfgw).epe
    assert ew < 1.0
    # measured delta is ~0 on Dimetrodon (EVAL.md / EVAL_full.md); the old
    # 0.1 tolerance could hide an Urban-sized regression (r2 VERDICT item 8)
    assert abs(ew - e4) < 0.02, (ew, e4)


def test_windowed_tiled_equals_untiled(rng):
    import jax
    from jax.sharding import Mesh
    from blockbasedmotionestimation.parallel import tiled

    cfg = MotionConfig(
        block_sizes=(4, 4), search_sizes=(6, 6), interp_factor=1,
        regularizer="windowed",
    )
    im1, im2 = _pair(rng, 128, 64, dy=1, dx=-1, margin=16)
    mesh = Mesh(np.array(jax.devices()), ("ty",))
    want = np.asarray(engine.estimate_flow_padded(im1, im2, cfg))
    got = np.asarray(tiled.estimate_flow_padded_tiled(im1, im2, cfg, mesh))
    np.testing.assert_array_equal(got, want)


def test_windowed_pallas_cv_matches_xla(rng):
    # the Pallas (Triton route, interpreted) CV path must be bit-identical
    # to the XLA CV path
    cfgx = MotionConfig(
        block_sizes=(8, 8), search_sizes=(24, 24), interp_factor=1,
        regularizer="windowed", search_impl="xla",
    )
    cfgp = cfgx.replace(search_impl="triton_interpret")
    im1, im2 = _pair(rng, 64, 64, dy=1, dx=-2)
    a = np.asarray(engine.estimate_flow_driver(im1, im2, cfgx))
    b = np.asarray(engine.estimate_flow_driver(im1, im2, cfgp))
    np.testing.assert_array_equal(a, b)


def test_windowed_tiled_pallas_equals_untiled(rng):
    # the Pallas cost-volume kernel under shard_map (traced row0)
    import jax
    from jax.sharding import Mesh
    from blockbasedmotionestimation.parallel import tiled

    cfg = MotionConfig(
        block_sizes=(4, 4), search_sizes=(6, 6), interp_factor=1,
        regularizer="windowed", search_impl="triton_interpret",
    )
    im1, im2 = _pair(rng, 128, 64, dy=1, dx=-1, margin=16)
    mesh = Mesh(np.array(jax.devices()), ("ty",))
    want = np.asarray(engine.estimate_flow_padded(im1, im2, cfg))
    got = np.asarray(tiled.estimate_flow_padded_tiled(im1, im2, cfg, mesh))
    np.testing.assert_array_equal(got, want)


def test_windowed_pallas_ssd_matches_xla(rng):
    cfgx = MotionConfig(
        block_sizes=(8, 8), search_sizes=(24, 24), interp_factor=1,
        regularizer="windowed", search_impl="xla", cost="ssd",
    )
    cfgp = cfgx.replace(search_impl="triton_interpret")
    im1, im2 = _pair(rng, 64, 64, dy=-2, dx=1)
    a = np.asarray(engine.estimate_flow_driver(im1, im2, cfgx))
    b = np.asarray(engine.estimate_flow_driver(im1, im2, cfgp))
    np.testing.assert_array_equal(a, b)


def test_fused_search_winner_matches_block_search(rng):
    # windowed_level's grid0 (the fused spiral argmin over the pooled cost
    # volume) must be BIT-IDENTICAL to ops.search.block_search_level: same
    # windows, same costs, same (cost, spiral-rank) tie-break.
    import jax.numpy as jnp

    from blockbasedmotionestimation.ops.search import block_search_level
    from blockbasedmotionestimation.ops.windowed import windowed_level

    im1np, im2np = _pair(rng, 64, 64, dy=3, dx=-2)
    im1, im2 = jnp.asarray(im1np), jnp.asarray(im2np)
    bs, ss = 8, 24
    pred = jnp.asarray(
        rng.integers(-4, 5, size=(64 // bs, 64 // bs, 2)), dtype=jnp.float32
    )
    want = np.asarray(block_search_level(im1, im2, pred, bs, ss))
    # sweeps_per_round=0 makes every regularization round a no-op adoption of
    # the incumbent, so the output is the subdivided search winner
    got = np.asarray(
        windowed_level(im1, im2, pred, bs, ss, lam0=4.0, sweeps_per_round=0)
    )
    want_dense = np.repeat(np.repeat(want, bs, axis=0), bs, axis=1)
    np.testing.assert_array_equal(got, want_dense)


def test_fused_pred_center_close_to_search_center(rng):
    # the fused (prediction-centered) path vs the two-pass (winner-centered)
    # path: identical on a clean translation, near-identical on noise
    cfgp = MotionConfig(
        block_sizes=(8, 8), search_sizes=(24, 24), interp_factor=1,
        regularizer="windowed", window_center="pred",
    )
    cfgs = cfgp.replace(window_center="search")
    assert cfgp.uses_fused_windowed and not cfgs.uses_fused_windowed
    im1, im2 = _pair(rng, 64, 64, dy=1, dx=-2)
    a = np.asarray(engine.estimate_flow_driver(im1, im2, cfgp))
    b = np.asarray(engine.estimate_flow_driver(im1, im2, cfgs))
    np.testing.assert_array_equal(a[16:-16, 16:-16], b[16:-16, 16:-16])
    assert (a == b).all(axis=-1).mean() > 0.9


def test_rival_window_recovers_far_candidates(rng):
    # the exclusion pathology, isolated: true motion +20 px everywhere, but a
    # 2-parent-wide strip of blocks gets a zero prediction.  The search can
    # only reach pred +- 16, so strip blocks end up wrong; their neighbors'
    # correct MV (+20) is > R=16 from the strip's window center, so plain
    # windowed can NEVER adopt it - rival windows (centered on the
    # most-different neighbor winner) make it evaluable, like fourcolor's
    # unrestricted gathers (motion_framework.cpp:594-602) do
    import jax.numpy as jnp

    from blockbasedmotionestimation.ops.windowed import windowed_level

    h, w, bs, ss, dx = 96, 128, 8, 24, 20
    base = synth.textured_image(h + 64, w + 64, rng)
    im1 = base[32 : 32 + h, 32 : 32 + w]
    # im1's block at p matches im2 at p + dx: flow u = +dx everywhere
    im2 = base[32 : 32 + h, 32 - dx : 32 - dx + w]
    pred = np.full((h // bs, w // bs, 2), (dx, 0), np.float32)
    pred[:, 6:8] = 0.0  # the polluted strip (parent cols 6-7)
    args = (jnp.asarray(im1), jnp.asarray(im2), jnp.asarray(pred), bs, ss)
    plain = np.asarray(windowed_level(*args, lam0=4.0, sweeps_per_round=2))
    riv = np.asarray(windowed_level(*args, lam0=4.0, sweeps_per_round=2, rival=True))
    strip = (slice(16, 80), slice(6 * bs, 8 * bs))
    assert not (plain[strip][..., 0] == dx).any(), "strip unexpectedly reachable"
    assert (riv[strip][..., 0] == dx).all() and (riv[strip][..., 1] == 0).all()
    # away from the strip both paths must agree with the planted motion
    good = (slice(16, 80), slice(2 * bs, 5 * bs))
    assert (plain[good][..., 0] == dx).all() and (riv[good][..., 0] == dx).all()


def test_rival_equals_windowed_when_no_exclusions(rng):
    # uniform small translation: every candidate stays in the primary window,
    # so the rival path must be bit-identical in the interior
    cfgw = MotionConfig(
        block_sizes=(8, 8), search_sizes=(24, 24), interp_factor=1,
        regularizer="windowed",
    )
    cfgr = cfgw.replace(rival_window=True)
    im1, im2 = _pair(rng, 64, 64, dy=1, dx=-2)
    a = np.asarray(engine.estimate_flow_driver(im1, im2, cfgw))
    b = np.asarray(engine.estimate_flow_driver(im1, im2, cfgr))
    np.testing.assert_array_equal(a[16:-16, 16:-16], b[16:-16, 16:-16])
    assert (a == b).all(axis=-1).mean() > 0.9


def _rival_scene(rng):
    # uniform +20 px motion: beyond the 2-level config's reach at the fine
    # level's window, so rival windows carry real exclusions
    h, w, dx = 96, 128, 20
    base = synth.textured_image(h + 64, w + 64, rng)
    return (
        base[32 : 32 + h, 32 : 32 + w],
        base[32 : 32 + h, 32 - dx : 32 - dx + w],
    )


def test_rival_pallas_matches_xla(rng):
    # the rival volumes from the Pallas cost-volume kernel must give fields
    # bit-identical to the XLA rival path, on a scene with real exclusions
    cfgx = MotionConfig(
        block_sizes=(8, 8), search_sizes=(24, 24), interp_factor=1,
        regularizer="windowed", rival_window=True, rival_radius=None,
    )
    im1, im2 = _rival_scene(rng)
    a = np.asarray(engine.estimate_flow_driver(im1, im2, cfgx))
    b = np.asarray(engine.estimate_flow_driver(
        im1, im2, cfgx.replace(search_impl="triton_interpret")
    ))
    np.testing.assert_array_equal(a, b)


def test_rival_pallas_matches_xla_radius8(rng):
    # reduced rival radius (r2 < R: the rival window has its own extent)
    cfgx = MotionConfig(
        block_sizes=(8, 8), search_sizes=(24, 24), interp_factor=1,
        regularizer="windowed", rival_window=True, rival_radius=8,
    )
    im1, im2 = _rival_scene(rng)
    a = np.asarray(engine.estimate_flow_driver(im1, im2, cfgx))
    b = np.asarray(engine.estimate_flow_driver(
        im1, im2, cfgx.replace(search_impl="triton_interpret")
    ))
    np.testing.assert_array_equal(a, b)


def test_rival_bs16_pallas_matches_xla(rng):
    # bs=16: the kernel pools a cur=8 middle round too (sizes 2..16)
    cfgx = MotionConfig(
        block_sizes=(16,), search_sizes=(48,), interp_factor=1,
        regularizer="windowed", rival_window=True, rival_radius=8,
    )
    base = synth.textured_image(128, 160, rng)
    im1, im2 = base[:96, :128], base[4:100, 3:131]
    a = np.asarray(engine.estimate_flow_driver(im1, im2, cfgx))
    b = np.asarray(engine.estimate_flow_driver(
        im1, im2, cfgx.replace(search_impl="triton_interpret")
    ))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["windowed", "fourcolor"])
def test_zsad_recovers_translation_under_gain_offset(rng, mode):
    # zero-mean SAD (cost="zsad"): a planted translation under a gain+offset
    # brightness change must still be recovered exactly in the interior -
    # the robustness cost the raw-SAD reference lacks (EVAL_robust.md shows
    # raw SAD collapsing to ~2.4-2.9 EPE under these nuisances)
    cfg = MotionConfig(
        block_sizes=(16, 16), search_sizes=(32, 32), interp_factor=1,
        regularizer=mode, rival_window=(mode == "windowed"), cost="zsad",
    )
    base = rng.integers(30, 200, size=(176, 208), dtype=np.uint8)
    im1 = base[:160, :192]
    im2 = np.clip(
        base[3:163, 5:197].astype(np.float64) * 1.10 + 12.0, 0, 255
    ).astype(np.uint8)
    f = np.asarray(engine.estimate_flow_driver(im1, im2, cfg))
    inner = f[48:-48, 48:-48]
    np.testing.assert_array_equal(
        inner, np.broadcast_to([-5.0, -3.0], inner.shape)
    )


def test_zsad_equals_sad_on_clean_pair(rng):
    # with no photometric nuisance and strong texture, zsad and sad agree on
    # the recovered uniform translation (sanity: the mean-subtraction does
    # not distort the clean case)
    base = rng.integers(0, 256, size=(144, 176), dtype=np.uint8)
    im1, im2 = base[:128, :160], base[2:130, 3:163]
    flows = {}
    for cost in ("sad", "zsad"):
        cfg = MotionConfig(
            block_sizes=(16, 16), search_sizes=(32, 32), interp_factor=1,
            regularizer="windowed", rival_window=True, cost=cost,
        )
        flows[cost] = np.asarray(engine.estimate_flow_driver(im1, im2, cfg))
    np.testing.assert_array_equal(
        flows["sad"][40:-40, 40:-40], flows["zsad"][40:-40, 40:-40]
    )


def test_rival_radius_per_level_tuple_equals_scalar(rng):
    # a uniform per-level tuple must be BIT-IDENTICAL to the scalar setting
    # (pure plumbing: cfg.rival_radius_at resolves the same radius per level)
    cfg_s = MotionConfig(
        block_sizes=(8, 8), search_sizes=(24, 24), interp_factor=1,
        regularizer="windowed", rival_window=True, rival_radius=4,
    )
    cfg_t = cfg_s.replace(rival_radius=(4, 4))
    im1, im2 = _pair(rng, 64, 64, dy=2, dx=-3)
    a = np.asarray(engine.estimate_flow_driver(im1, im2, cfg_s))
    b = np.asarray(engine.estimate_flow_driver(im1, im2, cfg_t))
    np.testing.assert_array_equal(a, b)


def test_rival_radius_per_level_mixed(rng):
    # (fine, coarse) = (2, None): the coarse level runs FULL-radius rival,
    # the fine level radius 2.  Sanity: a clamping-huge coarse entry equals
    # None there (both resolve to the level's primary radius), and the
    # mixed schedule stays a valid flow field of the right shape.
    cfg_mixed = MotionConfig(
        block_sizes=(8, 8), search_sizes=(24, 24), interp_factor=1,
        regularizer="windowed", rival_window=True, rival_radius=(2, None),
    )
    cfg_huge = cfg_mixed.replace(rival_radius=(2, 999))
    im1, im2 = _pair(rng, 64, 64, dy=2, dx=-3)
    a = np.asarray(engine.estimate_flow_driver(im1, im2, cfg_mixed))
    b = np.asarray(engine.estimate_flow_driver(im1, im2, cfg_huge))
    np.testing.assert_array_equal(a, b)
    assert a.shape == (64, 64, 2)


def test_rival_radius_tuple_validation():
    with pytest.raises(ValueError, match="rival_radius"):
        MotionConfig(block_sizes=(8, 8), search_sizes=(24, 24),
                     interp_factor=1, rival_radius=())
    with pytest.raises(ValueError, match="rival_radius"):
        MotionConfig(block_sizes=(8, 8), search_sizes=(24, 24),
                     interp_factor=1, rival_radius=(4, -1))


def test_rival_radius_tuple_extends_last(rng):
    # a short tuple repeats its last entry for deeper levels: (4,) on a
    # 2-level config must equal (4, 4) bit for bit
    cfg_a = MotionConfig(
        block_sizes=(8, 8), search_sizes=(24, 24), interp_factor=1,
        regularizer="windowed", rival_window=True, rival_radius=(4,),
    )
    cfg_b = cfg_a.replace(rival_radius=(4, 4))
    im1, im2 = _pair(rng, 64, 64, dy=2, dx=-3)
    a = np.asarray(engine.estimate_flow_driver(im1, im2, cfg_a))
    b = np.asarray(engine.estimate_flow_driver(im1, im2, cfg_b))
    np.testing.assert_array_equal(a, b)


def test_rival_radius_per_level_tiled_equals_untiled(rng):
    # the per-level schedule must survive row tiling bit-exactly (the level
    # index, not just the radius value, is threaded through the tiled body)
    import jax
    from jax.sharding import Mesh
    from blockbasedmotionestimation.parallel import tiled

    cfg = MotionConfig(
        block_sizes=(4, 4), search_sizes=(6, 6), interp_factor=1,
        regularizer="windowed", rival_window=True, rival_radius=(1, None),
    )
    im1, im2 = _pair(rng, 128, 64, dy=1, dx=-1, margin=16)
    mesh = Mesh(np.array(jax.devices()), ("ty",))
    want = np.asarray(engine.estimate_flow_padded(im1, im2, cfg))
    got = np.asarray(tiled.estimate_flow_padded_tiled(im1, im2, cfg, mesh))
    np.testing.assert_array_equal(got, want)


def test_rival_tiled_pallas_equals_untiled(rng):
    import jax
    from jax.sharding import Mesh
    from blockbasedmotionestimation.parallel import tiled

    cfg = MotionConfig(
        block_sizes=(4, 4), search_sizes=(6, 6), interp_factor=1,
        regularizer="windowed", rival_window=True,
        search_impl="triton_interpret",
    )
    im1, im2 = _pair(rng, 128, 64, dy=1, dx=-1, margin=16)
    mesh = Mesh(np.array(jax.devices()), ("ty",))
    want = np.asarray(engine.estimate_flow_padded(im1, im2, cfg))
    got = np.asarray(tiled.estimate_flow_padded_tiled(im1, im2, cfg, mesh))
    np.testing.assert_array_equal(got, want)


def test_fused_pallas_matches_xla(rng):
    cfgx = MotionConfig(
        block_sizes=(8, 8), search_sizes=(24, 24), interp_factor=1,
        regularizer="windowed", search_impl="xla",
    )
    cfgp = cfgx.replace(search_impl="triton_interpret")
    assert cfgx.uses_fused_windowed
    im1, im2 = _pair(rng, 64, 64, dy=2, dx=1)
    a = np.asarray(engine.estimate_flow_driver(im1, im2, cfgx))
    b = np.asarray(engine.estimate_flow_driver(im1, im2, cfgp))
    np.testing.assert_array_equal(a, b)


def test_rstore_equals_dense():
    # seeded multi-motion geometry within the search reach, one level: the
    # prediction is zero, so every candidate lies inside the primary window
    # and nothing is excluded - windowed with rival windows must then equal
    # fourcolor bit for bit (the rival volumes are built but never adopted)
    im1, im2, _ = synth.multi_motion_pair(64, 96, seed=4, max_motion=6)
    cfg4 = MotionConfig(
        block_sizes=(8,), search_sizes=(24,), interp_factor=1,
        regularizer="fourcolor",
    )
    a = np.asarray(engine.estimate_flow_driver(im1, im2, cfg4))
    for rr in (None, 4):
        cfgr = cfg4.replace(
            regularizer="windowed", rival_window=True, rival_radius=rr
        )
        b = np.asarray(engine.estimate_flow_driver(im1, im2, cfgr))
        np.testing.assert_array_equal(a, b)


def _masked_sweep(cv, ddy, ddx, r, m2, n2, lci, lcj):
    """Reference candidate selection: 1-hot masked sums over every delta."""
    side = 2 * r + 1
    slab = np.asarray(cv).reshape(side * side, m2, 2, n2, 2)[:, :, lci, :, lcj]
    dy = np.clip(np.asarray(ddy) + r, 0, side - 1)
    dx = np.clip(np.asarray(ddx) + r, 0, side - 1)
    out = np.zeros(dy.shape, np.float32)
    for d in range(side * side):
        hit = (dy * side + dx) == d
        out += np.where(hit, slab[d][..., None].astype(np.float32), 0.0)
    return out


@pytest.mark.parametrize(
    "r,dtype,lci,lcj",
    [(2, np.uint16, 0, 0), (3, np.uint16, 1, 0), (4, np.int32, 0, 1),
     (1, np.float32, 1, 1)],
)
def test_select_costs_matches_masked_sweep(rng, r, dtype, lci, lcj):
    # the color step's candidate read (one gather per candidate) must equal
    # the masked sweep over all (2R+1)^2 deltas bit for bit, including keys
    # outside [-R, R] (clipped; masked out-of-window downstream) and int32
    # costs above 2^24 (both round once on the f32 cast)
    from blockbasedmotionestimation.ops.windowed import _select_costs

    side = 2 * r + 1
    m2, n2 = 3, 5
    hi = 1 << 30 if dtype == np.int32 else 60000
    cv = rng.integers(0, hi, size=(side * side, 2 * m2, 2 * n2)).astype(dtype)
    ddy = rng.integers(-r - 2, r + 3, size=(m2, n2, 9)).astype(np.int32)
    ddx = rng.integers(-r - 2, r + 3, size=(m2, n2, 9)).astype(np.int32)
    got = np.asarray(_select_costs(cv, ddy, ddx, r, m2, n2, lci, lcj))
    want = _masked_sweep(cv, ddy, ddx, r, m2, n2, lci, lcj)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
