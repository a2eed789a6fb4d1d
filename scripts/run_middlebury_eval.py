"""Generate EVAL.md: Middlebury synth-warp EPE across configs/modes.

Usage: python scripts/run_middlebury_eval.py [quick|full]
  quick: 2-level 16px config, CPU-friendly
  full:  the reference's shipped 4-level/32px/interp-4 driver config
"""

import sys
import time

import jax
import _cache  # noqa: F401

from blockbasedmotionestimation.config import MotionConfig
from blockbasedmotionestimation.models import evaluate

GT_DIR = "/root/reference/middlebury/gt-flow"
mode = sys.argv[1] if len(sys.argv) > 1 else "quick"

if mode == "full":
    base = MotionConfig(interp_factor=4)  # shipped config (main_class.cpp:19-21)
else:
    base = MotionConfig(
        block_sizes=(16, 16), search_sizes=(32, 32), interp_factor=1
    )

# full mode runs only the windowed-family paths: the gather-based
# fourcolor path at the 4x-interpolated resolution issues pathological
# per-candidate gathers - its full-config
# column comes from the CPU runner (run_fourcolor_full_cpu.py); quick mode
# compares everything directly.
# rival_window/rival_radius default ON since r3: pin every column explicitly
w_cols = [
    ("windowed", base.replace(
        regularizer="windowed", rival_window=False, rival_radius=None)),
    ("rival_r8 (default)", base.replace(
        regularizer="windowed", rival_window=True, rival_radius=8)),
    ("rival_full", base.replace(
        regularizer="windowed", rival_window=True, rival_radius=None)),
]
if mode == "full":
    variants = w_cols
else:
    variants = w_cols + [("fourcolor", base.replace(
        regularizer="fourcolor", rival_window=False, rival_radius=None))]
rows = []
for reg, cfg in variants:
    t0 = time.time()
    results = evaluate.evaluate_middlebury(GT_DIR, cfg)
    dt = time.time() - t0
    rows.append((reg, results, dt))
    for r in results:
        print(f"  {reg} {r.name}: {r.epe:.4f}", flush=True)
    print(f"{reg}: {dt:.1f}s", flush=True)

out = "EVAL.md" if mode != "full" else "EVAL_full.md"
with open(out, "w") as f:
    f.write("# Middlebury evaluation (synthetic GT-warp pairs)\n\n")
    f.write(
        "Frames are synthesized by warping a multi-octave texture through the\n"
        "bundled ground-truth flow (brightness-constancy ideal; input frames\n"
        "are not shipped with the reference). EPE in pixels vs gt-flow.\n\n"
    )
    s_cfg = str(base).replace(f"regularizer='{base.regularizer}', ", "")
    f.write(f"Config (regularizer per column): {s_cfg}\n\nBackend: {jax.default_backend()}\n\n")
    seqs = [r.name for r in rows[0][1]]
    f.write("| sequence | " + " | ".join(r[0] for r in rows) + " |\n")
    f.write("|---|" + "---|" * len(rows) + "\n")
    for i, s in enumerate(seqs):
        vals = " | ".join(f"{r[1][i].epe:.4f}" for r in rows)
        f.write(f"| {s} | {vals} |\n")
    means = " | ".join(
        f"{sum(x.epe for x in r[1]) / len(r[1]):.4f}" for r in rows
    )
    f.write(f"| **mean** | {means} |\n")
print(f"wrote {out}")
