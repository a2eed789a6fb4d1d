"""Benchmark: 1080p dense MV fields per second on one device, full pipeline.

Workload: a batch of eight 1080p (1080x1920) grayscale frame pairs through the
library-default ``MotionConfig`` - 4-level pyramid, 32px blocks, 64px search
windows (the reference's shipped config, main_class.cpp:19-21, minus the 4x
Middlebury interpolation trick), windowed regularization with per-level
rival windows down to 1px blocks (the rival-radius schedule (12, full, 8, 8)
holds the windowed-vs-fourcolor gap to 0.0087 mean EPE, EVAL_full.md).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device"}.

vs_baseline: the reference publishes no wall-clock numbers (SURVEY.md section
6), so the denominator is MEASURED: a single-threaded portable C++ replica of
the reference pipeline (spiral SAD search + fast_array cache + Gauss-Seidel
sweeps, ``native/baseline_ref.cpp``), built with g++ -O3 and timed at this
exact workload on a Xeon host - 0.522 s/field = 1.915 fields/s
(``native/BASELINE_CPP.json``).
vs_baseline = measured_fields_per_sec / baseline_fields_per_sec.
"""

import json
import os
import time

import numpy as np

import jax

from blockbasedmotionestimation.utils import compile_cache

compile_cache.enable()

import jax.numpy as jnp

from blockbasedmotionestimation.config import MotionConfig
from blockbasedmotionestimation.models.engine import estimate_flow_batched


def _baseline_fields_per_sec() -> float:
    """Measured C++ single-thread rate (see module docstring)."""
    path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "blockbasedmotionestimation", "native", "BASELINE_CPP.json",
    )
    with open(path) as f:
        return float(json.load(f)["fields_per_sec"])


_BASELINE_FIELDS_PER_SEC = _baseline_fields_per_sec()

H, W = 1080, 1920


def main() -> None:
    cfg = MotionConfig(interp_factor=1)  # the library default at 1080p
    rng = np.random.default_rng(0)
    B = 8  # one jitted program, B fields
    base = rng.integers(0, 256, size=(B, H + 16, W + 16), dtype=np.uint8)
    im1 = jax.device_put(jnp.asarray(base[:, :H, :W]))
    im2 = jax.device_put(jnp.asarray(base[:, 5:5 + H, 9:9 + W]))

    flow, _ = estimate_flow_batched(im1, im2, cfg)  # compile + warm up
    jax.block_until_ready(flow)

    t0 = time.perf_counter()
    flow, _ = estimate_flow_batched(im1, im2, cfg)
    jax.block_until_ready(flow)
    once = time.perf_counter() - t0

    iters = max(1, min(20, int(20.0 / max(once, 1e-3))))
    t0 = time.perf_counter()
    for _ in range(iters):
        flow, _ = estimate_flow_batched(im1, im2, cfg)
        jax.block_until_ready(flow)
    dt = (time.perf_counter() - t0) / iters / B

    fields_per_sec = 1.0 / dt
    dev = jax.devices()[0]
    print(
        json.dumps(
            {
                "metric": "1080p_mv_fields_per_sec_per_device",
                "value": fields_per_sec,
                "unit": "fields/s",
                "vs_baseline": fields_per_sec / _BASELINE_FIELDS_PER_SEC,
                "baseline_fields_per_sec": _BASELINE_FIELDS_PER_SEC,
                "baseline_kind": "measured single-thread C++ replica (native/BASELINE_CPP.json)",
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
