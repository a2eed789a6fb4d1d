"""Diagnose the windowed-vs-fourcolor accuracy gap (VERDICT r1 item 1).

Quick config (2-level/16px), synth-warp Middlebury.  Columns:
  fused     windowed, window_center='pred'   (the production fast path)
  twopass   windowed, window_center='search' (winner-centered windows)
  fourcolor unrestricted candidate evaluation (gather-based)
"""

import sys
import time

import _cache  # noqa: F401
import numpy as np

from blockbasedmotionestimation.config import MotionConfig
from blockbasedmotionestimation.models import evaluate

GT_DIR = "/root/reference/middlebury/gt-flow"
SEQS = tuple(sys.argv[1:]) or ("Urban2", "Urban3", "Grove3", "Venus")

base = MotionConfig(block_sizes=(16, 16), search_sizes=(32, 32), interp_factor=1)
variants = [
    ("fused", base.replace(regularizer="windowed", window_center="pred")),
    ("twopass", base.replace(regularizer="windowed", window_center="search")),
    ("fourcolor", base.replace(regularizer="fourcolor")),
]

rows = {s: {} for s in SEQS}
for name, cfg in variants:
    for s in SEQS:
        t0 = time.time()
        r = evaluate.evaluate_sequence(s, GT_DIR, cfg)
        rows[s][name] = r.epe
        print(f"  {name:<10} {s:<12} EPE {r.epe:.4f}  ({time.time()-t0:.1f}s)", flush=True)

print(f"\n{'sequence':<12}" + "".join(f"{n:>11}" for n, _ in variants))
for s in SEQS:
    print(f"{s:<12}" + "".join(f"{rows[s][n]:>11.4f}" for n, _ in variants))
means = [float(np.mean([rows[s][n] for s in SEQS])) for n, _ in variants]
print(f"{'mean':<12}" + "".join(f"{m:>11.4f}" for m in means))
