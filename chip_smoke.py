"""Drive the motion-estimation pipeline once on a GPU and check what comes out.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python chip_smoke.py               # one card, every phase below
    python chip_smoke.py --four-cards  # four cards: the multi-card phase only

Phases (any failure exits non-zero; no result line is printed then):

  1. device   - JAX's first device must be a GPU; prints the card's name and
                power limit as nvidia-smi reports them.
  2. main     - ``estimate_flow_batched`` with the default ``MotionConfig``
                (interp_factor=1) on a seeded 1080p B=8 pair with a known
                integer translation; the interior flow must equal it.
  3. driver   - ``estimate_flow_driver`` with the reference driver's config
                (4x INTER_LINEAR upsampling inside the program) at 584x388;
                the interior must recover a quarter-pel translation.
  4. gpu_cpu  - the default config on a seeded multi-motion pair (256x384,
                B=2) with cost sad, ssd and zsad, once on the GPU and once on
                the CPU in this process.  sad/ssd: bit-equal (integer costs;
                the energy multiplies them by dyadic lambdas, exact in f32).
                zsad: float block means summed in another order on each
                backend flip near-ties; held to ZSAD_MAX_DIFF_SHARE of pixels
                and ZSAD_MAX_EPE px.
  5. kernel   - the Triton cost-volume kernel against the plain XLA build
                (``ops.windowed._compute_cv``) at 1080p level-0 shapes, B=8:
                bs=32, r=16 main and r=12 rival, every cur, sad and ssd;
                bit-equal.
  6. four     - (``--four-cards`` only) ``tiled.estimate_flow_batch`` with
                B=8 over a 4-card "batch" mesh, and
                ``tiled.estimate_flow_tiled_auto`` on a 1080p pair row-tiled
                over 4 cards; each bit-equal to the single-card result on
                card 0, with the output spread over all 4 cards.

Times and peak memory are printed for information beside the card's name and
power limit.  The last line is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

import argparse
import json
import subprocess
import time

import numpy as np

import jax

from blockbasedmotionestimation.utils import compile_cache

compile_cache.enable()

import jax.numpy as jnp

from blockbasedmotionestimation.config import MotionConfig
from blockbasedmotionestimation.models import engine
from blockbasedmotionestimation.ops import pad as pad_ops
from blockbasedmotionestimation.utils import synth

ZSAD_MAX_DIFF_SHARE = 0.02
ZSAD_MAX_EPE = 0.1

CARD = ""  # "name, power limit" from nvidia-smi, printed beside every number


def check(ok, msg: str) -> None:
    """Fail the phase (unlike ``assert``, this survives ``python -O``)."""
    if not ok:
        raise RuntimeError(msg)


def log(msg: str) -> None:
    print(f"[{CARD}] {msg}" if CARD else msg, flush=True)


def translated_batch(b, h, w, dy, dx, seed=0):
    """(im1s, im2s) uint8 noise with im1(x) = im2(x - (dy, dx)): flow (-dx, -dy)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, size=(b, h + 16, w + 16), dtype=np.uint8)
    return base[:, :h, :w], base[:, dy : dy + h, dx : dx + w]


def phase_device() -> None:
    global CARD
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {dev.platform!r}")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(out, flush=True)
    CARD = out.splitlines()[0].strip()
    log(f"device: {dev.device_kind}, {len(jax.devices())} visible")


def timed(fn, *args, reps=3):
    """(result, compile+first-run seconds, steady seconds per call)."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        out = jax.block_until_ready(fn(*args))
    return out, first, (time.perf_counter() - t0) / reps


def phase_main(h=1080, w=1920, b=8, margin=128) -> None:
    cfg = MotionConfig(interp_factor=1)
    dy, dx = 5, 9
    a, c = translated_batch(b, h, w, dy, dx)
    dev = jax.devices()[0]
    a, c = jax.device_put(a, dev), jax.device_put(c, dev)
    run = lambda x, y: engine.estimate_flow_batched(x, y, cfg)[0]
    flow, first, per_call = timed(run, a, c)
    p = pad_ops.compute_padding(h, w, cfg)
    flow = np.asarray(flow)[:, p.pad_y : p.pad_y + h, p.pad_x : p.pad_x + w]
    check(flow.shape == (b, h, w, 2), f"main: flow shape {flow.shape}")
    check(np.isfinite(flow).all(), "main: non-finite flow")
    inner = flow[:, margin:-margin, margin:-margin]
    want = np.float32([-dx, -dy])
    bad = int((inner != want).any(axis=-1).sum())
    check(bad == 0, f"main: {bad} interior pixels miss the translation {want}")
    peak = (dev.memory_stats() or {}).get("peak_bytes_in_use", -1)
    log(
        f"main: {h}x{w} B={b} default config ok; compile+first {first:.3f} s, "
        f"{per_call / b * 1e3:.3f} ms/field, peak device memory "
        f"{peak / 2**30:.3f} GiB"
    )


def phase_driver(h=388, w=584, margin=48) -> None:
    cfg = MotionConfig()  # the reference driver: interp_factor=4
    mv = np.float32([1.25, -0.75])  # quarter-pel (u, v)
    rng = np.random.default_rng(1)
    im2 = synth.textured_image(h, w, rng)
    im1 = synth.warp_backward(im2, np.broadcast_to(mv, (h, w, 2)))
    flow, first, per_call = timed(
        lambda x, y: engine.estimate_flow_driver(x, y, cfg),
        jnp.asarray(im1), jnp.asarray(im2),
    )
    flow = np.asarray(flow)
    check(flow.shape == (h, w, 2), f"driver: flow shape {flow.shape}")
    check(np.isfinite(flow).all(), "driver: non-finite flow")
    inner = flow[margin:-margin, margin:-margin]
    hit = float((inner == mv).all(axis=-1).mean())
    check(hit >= 0.99, f"driver: only {hit:.4f} of the interior recovers {mv}")
    log(
        f"driver: {h}x{w} interp 4 ok ({hit:.4f} of the interior exact); "
        f"compile+first {first:.3f} s, {per_call * 1e3:.3f} ms/field"
    )


def phase_gpu_cpu(h=256, w=384, b=2, gpu=None, cpu=None) -> None:
    gpu = jax.devices("gpu")[0] if gpu is None else gpu
    cpu = jax.devices("cpu")[0] if cpu is None else cpu
    pairs = [synth.multi_motion_pair(h, w, seed) for seed in range(b)]
    a = np.stack([p[0] for p in pairs])
    c = np.stack([p[1] for p in pairs])
    for cost in ("sad", "ssd", "zsad"):
        cfg = MotionConfig(interp_factor=1, cost=cost)
        f = [
            np.asarray(
                engine.estimate_flow_batched(
                    jax.device_put(a, d), jax.device_put(c, d), cfg
                )[0]
            )
            for d in (gpu, cpu)
        ]
        check(np.isfinite(f[0]).all(), f"gpu_cpu {cost}: non-finite flow")
        share = float((f[0] != f[1]).any(axis=-1).mean())
        epe = float(np.sqrt(((f[0] - f[1]) ** 2).sum(-1)).mean())
        log(f"gpu_cpu {cost}: differing pixels {share:.6f}, EPE {epe:.6f} px")
        if cost == "zsad":
            check(
                share <= ZSAD_MAX_DIFF_SHARE and epe <= ZSAD_MAX_EPE,
                f"gpu_cpu zsad: beyond tolerance ({share}, {epe} px)",
            )
        else:
            check(share == 0.0, f"gpu_cpu {cost}: GPU and CPU fields differ")


def phase_kernel(b=8) -> None:
    from blockbasedmotionestimation.kernels.cost_volume import (
        pooled_cost_volumes,
    )
    from blockbasedmotionestimation.ops.windowed import _compute_cv

    p = pad_ops.compute_padding(1080, 1920, MotionConfig(interp_factor=1))
    bs = 32
    npy, npx = p.padded_h // bs, p.padded_w // bs
    rng = np.random.default_rng(2)
    for ext, r in ((16, 16), (12, 12)):
        wside = bs + 2 * ext
        patches = jnp.asarray(rng.integers(0, 256, (b, npy, npx, bs, bs)), jnp.int16)
        windows = jnp.asarray(
            rng.integers(0, 256, (b, npy, npx, wside, wside)), jnp.int16
        )
        for cost in ("sad", "ssd"):
            kern = jax.jit(
                jax.vmap(
                    lambda p_, w_: pooled_cost_volumes(
                        p_, w_, bs=bs, ext=ext, r=r, cost=cost
                    )
                )
            )
            vols, first, per_call = timed(kern, patches, windows)
            # the XLA build one field at a time: its stacked scan output and
            # transpose would not fit beside the batch's ssd volumes
            for cur, vol in vols.items():
                ref = jax.jit(
                    lambda p_, w_, cur=cur: _compute_cv(
                        p_, w_, bs, cur, ext, r, cost
                    )
                )
                for i in range(b):
                    same = bool(
                        jnp.array_equal(vol[i], ref(patches[i], windows[i]))
                    )
                    check(same, f"kernel != XLA: r={r} {cost} cur={cur} field {i}")
            log(
                f"kernel: r={r} {cost} B={b} {npy}x{npx} parents, every cur "
                f"bit-equal to XLA; {per_call * 1e3:.3f} ms per call"
            )
            del vols


def phase_four(h=1080, w=1920, b=8) -> None:
    from jax.sharding import Mesh

    from blockbasedmotionestimation.parallel import multihost, tiled

    devs = jax.devices()
    check(len(devs) == 4, f"--four-cards needs 4 devices, found {len(devs)}")
    cfg = MotionConfig(interp_factor=1)
    a, c = translated_batch(b, h, w, 5, 9, seed=3)

    def spread(x):
        used = {s.device for s in x.addressable_shards}
        check(used == set(devs), f"four: output on {len(used)} of 4 cards")

    bmesh = Mesh(np.array(devs), ("batch",))
    got, first, per_call = timed(
        lambda x, y: tiled.estimate_flow_batch(x, y, cfg, bmesh), a, c
    )
    spread(got)
    one = jax.device_put
    want = engine.estimate_flow_driver_batched(
        one(a, devs[0]), one(c, devs[0]), cfg
    )
    check(np.array_equal(np.asarray(got), np.asarray(want)), "four: batch mesh != card 0")
    log(
        f"four: estimate_flow_batch B={b} {h}x{w} over 4 cards bit-equal to "
        f"card 0; {per_call / b * 1e3:.3f} ms/field"
    )

    tmesh = multihost.make_mesh()
    check(dict(tmesh.shape) == {"batch": 1, "ty": 4}, f"four: mesh {tmesh.shape}")
    got, first, per_call = timed(
        lambda x, y: tiled.estimate_flow_tiled_auto(x, y, cfg, tmesh), a[0], c[0]
    )
    spread(got)
    run_cfg = cfg.replace(mv_cap=tiled.derive_mv_cap(cfg, h, w, 4))
    p = pad_ops.compute_padding(h, w, run_cfg, row_tiles=4)
    padded = jax.jit(engine.estimate_flow_padded, static_argnames="cfg")
    want = padded(
        pad_ops.pad_frame(one(a[0], devs[0]), p),
        pad_ops.pad_frame(one(c[0], devs[0]), p),
        cfg=run_cfg,
    )[p.pad_y : p.pad_y + h, p.pad_x : p.pad_x + w]
    check(np.array_equal(np.asarray(got), np.asarray(want)), "four: row tiling != card 0")
    log(
        f"four: estimate_flow_tiled_auto {h}x{w} row-tiled over 4 cards "
        f"(mv_cap {run_cfg.mv_cap}) bit-equal to card 0; "
        f"{per_call * 1e3:.3f} ms/field"
    )


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--four-cards", action="store_true",
        help="run only the four-card phase and its comparison",
    )
    args = ap.parse_args()
    phase_device()
    phases = (
        [phase_four]
        if args.four_cards
        else [phase_main, phase_driver, phase_gpu_cpu, phase_kernel]
    )
    for ph in phases:
        t0 = time.perf_counter()
        ph()
        log(f"{ph.__name__} done in {time.perf_counter() - t0:.3f} s")
    dev = jax.devices()[0]
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
