"""Tiled (multi-device) engine correctness on a forced-8-device CPU mesh.

The key property: row tiling + halo exchange must be NUMERICALLY INVISIBLE -
the tiled fourcolor/jacobi pipeline equals the untiled one bit for bit,
because every bounds check is global and the halos cover the worst-case MV
reach (SURVEY.md section 5, long-context analogue).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from blockbasedmotionestimation.config import MotionConfig
from blockbasedmotionestimation.models import engine
from blockbasedmotionestimation.parallel import tiled


def _mesh(names=("ty",), shape=None):
    devs = np.array(jax.devices())
    if shape is None:
        shape = (len(devs),)
    return Mesh(devs.reshape(shape), names)


def _pair(rng, h, w, dy=2, dx=-3, margin=16):
    base = rng.integers(0, 256, size=(h + 2 * margin, w + 2 * margin), dtype=np.uint8)
    im1 = base[margin : margin + h, margin : margin + w]
    im2 = base[margin + dy : margin + dy + h, margin + dx : margin + dx + w]
    return im1, im2


def test_mv_bound_recursion():
    # gather-mode regularizers adopt only existing candidates: no R growth
    cfg = MotionConfig(regularizer="fourcolor")  # 4 levels, extents 16
    assert tiled.mv_bound(cfg, 3) == 16
    assert tiled.mv_bound(cfg, 2) == 48
    assert tiled.mv_bound(cfg, 1) == 112
    assert tiled.mv_bound(cfg, 0) == 240
    # the production default (windowed + rival) grows by R per coarser level
    cfgw = MotionConfig()
    assert tiled.mv_bound(cfgw, 3) == 16
    assert tiled.mv_bound(cfgw, 2) == 80
    assert tiled.mv_bound(cfgw, 1) == 208
    assert tiled.mv_bound(cfgw, 0) == 464


def test_mv_cap_shards_1080p_level0():
    # the bench config CANNOT shard 1080p without a cap (VERDICT r1): the
    # worst-case halo exceeds the per-device strip at every level.  With
    # mv_cap=64 and tile-aware padding, level 0 shards 8 ways.
    from blockbasedmotionestimation.ops import pad as pad_ops

    cfg = MotionConfig(interp_factor=1, regularizer="windowed", mv_cap=64)
    p = pad_ops.compute_padding(1080, 1920, cfg, row_tiles=8)
    # parity-aware color steps: strips need only be block-aligned, so the
    # tile-aware padding equals the untiled padding (1280, not r2's 1536 -
    # the +20% tax is gone) and each tile holds 5 (odd) block rows
    assert p.padded_h == 1280, p
    assert (p.padded_h // 8) // 32 == 5
    strip = p.padded_h // 8
    halo = tiled.im2_halo(cfg, 0)
    assert halo == 64 + 16 + 16  # cap + spiral extent + window reach
    assert tiled._level_shardable(p.padded_h, p.padded_w, 32, 8)
    assert halo < strip, (halo, strip)
    # without the cap the halo swallows the strip (the r1 failure mode)
    uncapped = cfg.replace(mv_cap=None)
    assert tiled.im2_halo(uncapped, 0) >= strip


def test_mv_cap_tiled_equals_untiled_near_bound(rng):
    # adversarial: the planted motion sits AT the cap, so boundary tiles
    # exercise the outermost halo rows the bound promises; the level only
    # shards BECAUSE of the cap, and tiled must still equal untiled
    cfg = MotionConfig(
        block_sizes=(4, 4, 4), search_sizes=(12, 12, 12), interp_factor=1,
        regularizer="windowed", mv_cap=8,
    )
    h, t = 256, 8
    assert not tiled.im2_halo(cfg.replace(mv_cap=None), 0) < h // t
    assert tiled.im2_halo(cfg, 0) < h // t
    im1, im2 = _pair(rng, h, 64, dy=8, dx=-8, margin=16)
    mesh = _mesh()
    want = np.asarray(engine.estimate_flow_padded(im1, im2, cfg))
    got = np.asarray(tiled.estimate_flow_padded_tiled(im1, im2, cfg, mesh))
    np.testing.assert_array_equal(got, want)
    # the cap must not have stopped the engine from finding the true motion
    # (_pair shifts base by (dy, dx), so flow = (-dx, -dy))
    assert (want[64:192, 24:40] == np.float32([8, -8])).all()


def test_rival_tiled_equals_untiled(rng):
    # the rival pick reads neighbor-tile winners (1-row ppermute exchange,
    # edge-replicated at frame boundaries): tiled == untiled bit for bit
    cfg = MotionConfig(
        block_sizes=(4, 4), search_sizes=(6, 6), interp_factor=1,
        regularizer="windowed", rival_window=True,
    )
    im1, im2 = _pair(rng, 128, 64, dy=1, dx=-1)
    mesh = _mesh()
    want = np.asarray(engine.estimate_flow_padded(im1, im2, cfg))
    got = np.asarray(tiled.estimate_flow_padded_tiled(im1, im2, cfg, mesh))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["fourcolor", "jacobi"])
def test_tiled_equals_untiled(rng, mode):
    # 128 rows over 8 devices = 16-row tiles; bs 4 -> 4 block rows per tile
    # (even, preserving color parity); halo bound = 6 < 16.
    cfg = MotionConfig(
        block_sizes=(4, 4), search_sizes=(6, 6), interp_factor=1, regularizer=mode
    )
    im1, im2 = _pair(rng, 128, 64, dy=1, dx=-1)
    mesh = _mesh()

    want = np.asarray(engine.estimate_flow_padded(im1, im2, cfg))
    got = np.asarray(tiled.estimate_flow_padded_tiled(im1, im2, cfg, mesh))
    np.testing.assert_array_equal(got, want)


def test_tiled_coarse_fallback_equals_untiled(rng):
    # second level is 64 rows / 8 devices = 8 rows = 2 block rows (even) but
    # halo (14) > tile rows (8): the coarse level must fall back to replicated
    # execution and still match.
    cfg = MotionConfig(
        block_sizes=(4, 4), search_sizes=(10, 10), interp_factor=1,
        regularizer="fourcolor",
    )
    im1, im2 = _pair(rng, 128, 64, dy=2, dx=1)
    mesh = _mesh()
    want = np.asarray(engine.estimate_flow_padded(im1, im2, cfg))
    got = np.asarray(tiled.estimate_flow_padded_tiled(im1, im2, cfg, mesh))
    np.testing.assert_array_equal(got, want)


def test_batch_tiled_combined_matches_untiled(rng):
    # ONE program sharding batch over "batch" AND rows over "ty" (the
    # multihost layout): equals the untiled per-pair engine bit for bit
    cfg = MotionConfig(
        block_sizes=(4, 4), search_sizes=(6, 6), interp_factor=1,
        regularizer="windowed",
    )
    mesh = _mesh(("batch", "ty"), (2, 4))
    pairs = [_pair(rng, 64, 64, dy=d % 3, dx=-(d % 2)) for d in range(4)]
    im1s = np.stack([p[0] for p in pairs])
    im2s = np.stack([p[1] for p in pairs])
    got = np.asarray(
        tiled.estimate_flow_padded_batch_tiled(im1s, im2s, cfg, mesh)
    )
    for b in range(4):
        want = np.asarray(engine.estimate_flow_padded(im1s[b], im2s[b], cfg))
        np.testing.assert_array_equal(got[b], want)


def test_batch_sharded_matches_single(rng):
    cfg = MotionConfig(
        block_sizes=(4,), search_sizes=(8,), interp_factor=1, regularizer="fourcolor"
    )
    mesh = _mesh(("batch",))
    pairs = [_pair(rng, 32, 48, dy=d % 3, dx=-(d % 2)) for d in range(8)]
    im1s = np.stack([p[0] for p in pairs])
    im2s = np.stack([p[1] for p in pairs])

    batched = np.asarray(tiled.estimate_flow_batch(im1s, im2s, cfg, mesh))
    for b in range(8):
        single = np.asarray(engine.estimate_flow_driver(im1s[b], im2s[b], cfg))
        np.testing.assert_array_equal(batched[b], single)


@pytest.mark.parametrize("mode", ["fourcolor", "windowed"])
def test_tiled_odd_block_rows_equals_untiled(rng, mode):
    # 96 rows / 8 devices = 12-row strips = 3 block rows per tile (ODD):
    # exercises the per-tile color-parity offsets ((ci + row0_b) % 2) and
    # the pad-aware halo exchange in the first round (r2's engine required
    # even strips and would have refused to shard this level at all)
    cfg = MotionConfig(
        block_sizes=(4, 4), search_sizes=(6, 6), interp_factor=1,
        regularizer=mode,
    )
    assert tiled._level_shardable(96, 64, 4, 8)
    im1, im2 = _pair(rng, 96, 64, dy=1, dx=-1)
    mesh = _mesh()
    want = np.asarray(engine.estimate_flow_padded(im1, im2, cfg))
    got = np.asarray(tiled.estimate_flow_padded_tiled(im1, im2, cfg, mesh))
    np.testing.assert_array_equal(got, want)


def test_tiled_odd_block_rows_rival_equals_untiled(rng):
    # odd strips + rival windows: the rival 1-row winner exchange and the
    # parity-aware color steps must compose
    cfg = MotionConfig(
        block_sizes=(4, 4), search_sizes=(6, 6), interp_factor=1,
        regularizer="windowed", rival_window=True,
    )
    im1, im2 = _pair(rng, 96, 64, dy=2, dx=-1)
    mesh = _mesh()
    want = np.asarray(engine.estimate_flow_padded(im1, im2, cfg))
    got = np.asarray(tiled.estimate_flow_padded_tiled(im1, im2, cfg, mesh))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "mode,rival",
    [("fourcolor", False), ("windowed", False), ("windowed", True)],
)
def test_tiled_2d_equals_untiled(rng, mode, rival):
    # 2-D (ty x tx) spatial tiling - the reference's own split is by
    # COLUMNS (parallel.h:20-58); here both axes compose, with corner halos
    # carried by the rows-then-columns exchange order.  Column count per
    # tile is 5 blocks (ODD) to exercise the column parity offsets.
    cfg = MotionConfig(
        block_sizes=(4, 4), search_sizes=(6, 6), interp_factor=1,
        regularizer=mode, rival_window=rival,
    )
    im1, im2 = _pair(rng, 96, 80, dy=1, dx=-2)
    mesh = _mesh(("ty", "tx"), (2, 4))
    want = np.asarray(engine.estimate_flow_padded(im1, im2, cfg))
    got = np.asarray(
        tiled.estimate_flow_padded_tiled(im1, im2, cfg, mesh, axis_x="tx")
    )
    np.testing.assert_array_equal(got, want)


def test_derive_mv_cap_properties():
    # the derived cap is (a) sufficient: level 0 shards at the tile-aware
    # padding; (b) maximal: cap+1 would not; (c) None when the uncapped
    # halo already fits; (d) a loud error when no cap can fit
    from blockbasedmotionestimation.ops import pad as pad_ops

    cfg = MotionConfig(interp_factor=1, regularizer="windowed")
    cap = tiled.derive_mv_cap(cfg, 1080, 1920, 8)
    assert cap is not None
    p = pad_ops.compute_padding(1080, 1920, cfg, row_tiles=8)
    strip = p.padded_h // 8
    assert tiled.im2_halo(cfg.replace(mv_cap=cap), 0) < strip
    assert tiled.im2_halo(cfg.replace(mv_cap=cap + 1), 0) >= strip
    assert tiled.derive_mv_cap(cfg, 1080, 1920, 1) is None  # whole frame fits
    with pytest.raises(ValueError, match="cannot shard"):
        tiled.derive_mv_cap(cfg, 256, 256, 8)  # 32-row strips < any legal halo
    # the plan names the levels that shard under the derived cap
    plan = tiled.plan_tiling(
        cfg.replace(mv_cap=cap), p.padded_h, p.padded_w, 8
    )
    assert plan[0]["rows_ok"]


def test_tiled_warns_when_fully_replicated(rng):
    # out-of-box row tiling whose halo swallows every strip must SAY so
    # instead of silently computing the whole frame on all 8 devices
    cfg = MotionConfig(
        block_sizes=(4, 4), search_sizes=(8, 8), interp_factor=1,
        regularizer="windowed",
    )
    plan = tiled.plan_tiling(cfg, 32, 64, 8)
    assert not any(e["rows_ok"] or e["cols_ok"] for e in plan)
    im1, im2 = _pair(rng, 32, 64, dy=1, dx=-1)
    mesh = _mesh()
    with pytest.warns(UserWarning, match="REPLICATED"):
        got = np.asarray(tiled.estimate_flow_padded_tiled(im1, im2, cfg, mesh))
    want = np.asarray(engine.estimate_flow_padded(im1, im2, cfg))
    np.testing.assert_array_equal(got, want)


def test_estimate_flow_tiled_auto(rng):
    # unpadded frames + a mesh: auto derives the cap and tile-aware padding,
    # shards the finest level, and equals the untiled engine at the SAME
    # derived config (the out-of-box path the reference's split never
    # needed tuning for, parallel.h:20-58)
    from blockbasedmotionestimation.ops import pad as pad_ops

    cfg = MotionConfig(
        block_sizes=(4, 4, 4), search_sizes=(12, 12, 12), interp_factor=1,
        regularizer="windowed",
    )
    h, w = 250, 64
    t = 8
    cap = tiled.derive_mv_cap(cfg, h, w, t)
    assert cap is not None  # uncapped halo exceeds the strips
    run_cfg = cfg.replace(mv_cap=cap)
    p = pad_ops.compute_padding(h, w, run_cfg, row_tiles=t)
    plan = tiled.plan_tiling(run_cfg, p.padded_h, p.padded_w, t)
    assert plan[0]["rows_ok"]

    im1, im2 = _pair(rng, h, w, dy=2, dx=-1)
    mesh = _mesh()
    got = np.asarray(tiled.estimate_flow_tiled_auto(im1, im2, cfg, mesh))
    assert got.shape == (h, w, 2)
    want = np.asarray(
        engine.estimate_flow_padded(
            pad_ops.pad_frame(jnp.asarray(im1), p),
            pad_ops.pad_frame(jnp.asarray(im2), p),
            run_cfg,
        )
    )[p.pad_y : p.pad_y + h, p.pad_x : p.pad_x + w]
    np.testing.assert_array_equal(got, want)


def test_batch_tiled_3axis_matches_untiled(rng):
    # the full composition in ONE program: batch x rows x columns (what
    # __graft_entry__.dryrun_multichip now exercises on the driver side)
    cfg = MotionConfig(
        block_sizes=(4, 4), search_sizes=(6, 6), interp_factor=1,
        regularizer="windowed", rival_window=True,
    )
    mesh = _mesh(("batch", "ty", "tx"), (2, 2, 2))
    pairs = [_pair(rng, 24, 64, dy=d % 3, dx=-(d % 2)) for d in range(2)]
    im1s = np.stack([p[0] for p in pairs])
    im2s = np.stack([p[1] for p in pairs])
    got = np.asarray(
        tiled.estimate_flow_padded_batch_tiled(
            im1s, im2s, cfg, mesh, "batch", "ty", "tx"
        )
    )
    for b in range(2):
        want = np.asarray(engine.estimate_flow_padded(im1s[b], im2s[b], cfg))
        np.testing.assert_array_equal(got[b], want)


def test_tiled_2d_coarse_fallback(rng):
    # levels whose columns can't split block-aligned fall back to row-only
    # or replicated execution and still match untiled exactly
    cfg = MotionConfig(
        block_sizes=(4, 4, 4), search_sizes=(8, 8, 8), interp_factor=1,
        regularizer="windowed", mv_cap=4,
    )
    im1, im2 = _pair(rng, 128, 96, dy=2, dx=1)
    mesh = _mesh(("ty", "tx"), (4, 2))
    want = np.asarray(engine.estimate_flow_padded(im1, im2, cfg))
    got = np.asarray(
        tiled.estimate_flow_padded_tiled(im1, im2, cfg, mesh, axis_x="tx")
    )
    np.testing.assert_array_equal(got, want)


def test_tiled_2d_cell_rounds_urban_geometry():
    # 2-D tiling on seeded multi-motion geometry: real discontinuities push
    # rival candidates across tile boundaries, so the corner-composed halo
    # exchange carries live data.  Bit-exact tiled == untiled.
    from blockbasedmotionestimation.utils import synth

    cfg = MotionConfig(
        block_sizes=(8, 8), search_sizes=(16, 16), interp_factor=1,
        regularizer="windowed", rival_window=True,
    )
    h, w, t, tx = 128, 64, 4, 2
    assert tiled.im2_halo(cfg, 0) < min(h // t, w // tx)
    im1, im2, _ = synth.multi_motion_pair(h, w, seed=5, max_motion=4)
    mesh = _mesh(("ty", "tx"), (t, tx))
    want = np.asarray(engine.estimate_flow_padded(im1, im2, cfg))
    got = np.asarray(
        tiled.estimate_flow_padded_tiled(im1, im2, cfg, mesh, axis_x="tx")
    )
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "layout,scene,impl",
    [
        ("rows", "shift", "xla"),
        ("rows", "multi", "xla"),
        ("2d", "shift", "xla"),
        ("2d", "multi", "xla"),
        ("rows", "multi", "triton_interpret"),
        ("2d", "shift", "triton_interpret"),
    ],
)
def test_tiled_geometry_equals_untiled(rng, layout, scene, impl):
    # both pyramid levels shard (1-D: 8 row strips of 32 rows; 2-D: 4 x 2
    # tiles) under the production schedule with rival windows; neighbor MVs
    # cross tiles only through the per-step halo exchange.  Bit-exact vs the
    # untiled engine, on a translation and on seeded multi-motion geometry,
    # with the XLA cost volumes and with the Pallas kernel inside shard_map.
    from blockbasedmotionestimation.utils import synth

    cfg = MotionConfig(
        block_sizes=(8, 8), search_sizes=(16, 16), interp_factor=1,
        regularizer="windowed", rival_window=True, search_impl=impl,
    )
    if layout == "rows":
        h, w, shape, names = 256, 64, (8,), ("ty",)
    else:
        h, w, shape, names = 128, 64, (4, 2), ("ty", "tx")
    strip_w = w // shape[1] if len(shape) == 2 else w
    for lvl in (0, 1):
        assert tiled.im2_halo(cfg, lvl) < min((h >> lvl) // shape[0], strip_w >> lvl)
    if scene == "shift":
        base = synth.textured_image(h + 32, w + 32, rng)
        im1 = base[16 : 16 + h, 16 : 16 + w]
        im2 = base[18 : 18 + h, 13 : 13 + w]
    else:
        im1, im2, _ = synth.multi_motion_pair(h, w, seed=6, max_motion=4)
    mesh = _mesh(names, shape)
    axis_x = "tx" if len(shape) == 2 else None
    want = np.asarray(engine.estimate_flow_padded(im1, im2, cfg))
    got = np.asarray(
        tiled.estimate_flow_padded_tiled(im1, im2, cfg, mesh, axis_x=axis_x)
    )
    np.testing.assert_array_equal(got, want)
