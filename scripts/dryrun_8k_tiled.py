"""8K-shape row-tiled dryrun on a virtual CPU mesh (BASELINE config #5's
shape), at the SHIPPED search size 64.  Requires mv_cap (the uncapped halo
exceeds any strip) and tile-aware padding; prints per-level shardability and
runs ONE frame end to end, asserting the planted translation is recovered.

XLA CPU hard-codes a 40 s collective rendezvous timeout, so the virtual
host must keep one device's between-ppermute work under it; r2 dodged this
by shrinking the search to 48 on 8 devices, r3 instead runs the SHIPPED
search 64 over 16 thinner strips (288 rows each - half the per-device work,
full production config).

Run: python scripts/dryrun_8k_tiled.py [height width tiles search]
"""

import sys
import time

import os

_T = int(sys.argv[3]) if len(sys.argv) > 3 else 16
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + f" --xla_force_host_platform_device_count={_T}"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from blockbasedmotionestimation.utils import compile_cache

compile_cache.enable()

from blockbasedmotionestimation.config import MotionConfig
from blockbasedmotionestimation.ops import pad as pad_ops
from blockbasedmotionestimation.parallel import tiled
from blockbasedmotionestimation.utils import synth

H = int(sys.argv[1]) if len(sys.argv) > 1 else 4320
W = int(sys.argv[2]) if len(sys.argv) > 2 else 7680
T = _T
SS = int(sys.argv[4]) if len(sys.argv) > 4 else 64

cfg = MotionConfig(
    interp_factor=1, regularizer="windowed", mv_cap=64,
    search_sizes=(SS, SS, SS, SS),
)
p = pad_ops.compute_padding(H, W, cfg, row_tiles=T)
print(f"8K dryrun: {H}x{W} -> padded {p.padded_h}x{p.padded_w}")
for level in range(cfg.num_levels):
    h = p.padded_h >> level
    w = p.padded_w >> level
    bs = cfg.block_sizes[level]
    halo = tiled.im2_halo(cfg, level)
    ok = tiled._level_shardable(h, w, bs, T) and halo < h // T
    print(f"  L{level}: {h}x{w} halo {halo} strip {h // T} -> "
          f"{'SHARDED' if ok else 'replicated'}")

rng = np.random.default_rng(0)
m = 32
base = synth.textured_image(H + 2 * m, W + 2 * m, rng)
im1 = base[m : m + H, m : m + W]
im2 = base[m - 7 : m - 7 + H, m + 11 : m + 11 + W]  # flow = (-11, +7)

mesh = Mesh(np.array(jax.devices()).reshape(T), ("ty",))
im1p = pad_ops.pad_frame(jnp.asarray(im1), p)
im2p = pad_ops.pad_frame(jnp.asarray(im2), p)

# Run LEVEL BY LEVEL as separate programs rather than through the all-levels
# jit: on a virtual CPU host the replicated coarse levels would otherwise
# execute 16x (once per device thread) INSIDE the sharded program, ahead of
# its first ppermute - overrunning XLA CPU's hard 40 s collective
# rendezvous budget at the shipped search size.  Split per level, the
# replicated levels run ONCE on the host and only the sharded level is a
# multi-participant program whose first collective sits at its entry.
# Real chips run the single fused program (each device computes its own
# slice in parallel - no oversubscription).
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from blockbasedmotionestimation.models import engine
from blockbasedmotionestimation.ops import resample

t0 = time.time()
pyr1 = resample.build_pyramid(im1p, cfg.num_levels)
pyr2 = resample.build_pyramid(im2p, cfg.num_levels)
dense = None
for level in range(cfg.num_levels - 1, -1, -1):
    l1, l2 = pyr1[level], pyr2[level]
    h, w = l1.shape
    bs, ss = cfg.block_sizes[level], cfg.search_sizes[level]
    if dense is None:
        pred = jnp.zeros((h // bs, w // bs, 2), dtype=jnp.float32)
    else:
        pred = engine.transfer_mvs(dense, cfg.block_sizes[level + 1], bs)
        pred = jnp.clip(pred, -float(cfg.mv_cap), float(cfg.mv_cap))
    halo = tiled.im2_halo(cfg, level)
    tl0 = time.time()
    if tiled._level_shardable(h, w, bs, T) and halo < h // T:
        sh = NamedSharding(mesh, P("ty", None))
        l1 = jax.device_put(l1, sh)
        l2 = jax.device_put(l2, sh)
        body = tiled._tiled_level_fn(bs, ss, cfg, h, halo, "ty")
        dense = jax.jit(
            shard_map(
                body, mesh=mesh,
                in_specs=(P("ty", None), P("ty", None), P("ty", None, None)),
                out_specs=P("ty", None, None),
                check_vma=False,
            )
        )(l1, l2, pred)
        kind = f"SHARDED x{T}"
    else:
        dense = engine._run_level(l1, l2, pred, bs, ss, cfg)
        kind = "replicated(once)"
    jax.block_until_ready(dense)
    print(f"  L{level} {kind}: {time.time() - tl0:.1f}s", flush=True)
flow = np.asarray(dense)
print(f"end-to-end (compile+run, {T}-device CPU mesh): {time.time() - t0:.1f}s")
inner = flow[p.pad_y + 256 : p.pad_y + H - 256 : 64,
             p.pad_x + 256 : p.pad_x + W - 256 : 64]
frac = ((inner[..., 0] == -11) & (inner[..., 1] == 7)).mean()
print(f"interior exact-motion fraction: {frac:.4f}")
assert frac > 0.99, frac
print("8K tiled dryrun OK")
