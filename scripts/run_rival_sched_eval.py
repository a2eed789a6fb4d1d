"""Per-level rival-radius schedules: accuracy frontier -> EVAL_rival_sched.json.

EVAL_full.md shows the single global rival_radius=8 trails unrestricted
fourcolor evaluation by 0.073 EPE on Urban2 (large motions get truncated),
while FULL-radius rival closes most of it at ~2x the rival cost.  Coarse
levels have few parents, so full radius THERE is nearly free: this measures
the per-level schedules (finest level first; None = full radius) on the
synthetic GT-warp Middlebury pairs, same protocol as EVAL_rival_full.json.

Run on the GPU from repo root: python scripts/run_rival_sched_eval.py
"""

import json
import os
import time

import _cache  # noqa: F401

from blockbasedmotionestimation.config import MotionConfig
from blockbasedmotionestimation.models import evaluate

GT_DIR = "/root/reference/middlebury/gt-flow"
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "EVAL_rival_sched.json")

SCHEDULES = {
    "r8": 8,
    "sched_8_8_full_full": (8, 8, None, None),
    "sched_8_full_full_full": (8, None, None, None),
    "sched_12_full_full_full": (12, None, None, None),
    # efficient points: full radius ONLY at level 1 (levels 2/3 measured
    # accuracy-neutral; their full-radius rival build is pure cost)
    "sched_8_full_8_8": (8, None, 8, 8),
    "sched_12_full_8_8": (12, None, 8, 8),
}

import json as _json, os as _os
out = {}
if _os.path.exists(OUT):
    out = _json.load(open(OUT))
for label, rr in SCHEDULES.items():
    if label in out:
        print(f"{label}: cached ({out[label]['mean_epe']})", flush=True)
        continue
    cfg = MotionConfig(interp_factor=4, regularizer="windowed",
                       rival_window=True, rival_radius=rr)
    results = {}
    for seq in evaluate.SEQUENCES:
        t0 = time.time()
        r = evaluate.evaluate_sequence(seq, GT_DIR, cfg)
        results[seq] = {"epe": round(r.epe, 4),
                        "seconds": round(time.time() - t0, 1)}
        print(f"{label} {seq}: EPE {r.epe:.4f}", flush=True)
    mean = sum(v["epe"] for v in results.values()) / len(results)
    out[label] = {"rival_radius": repr(rr), "mean_epe": round(mean, 4),
                  "results": results}
    print(f"{label}: mean {mean:.4f}", flush=True)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
print("done ->", OUT)
