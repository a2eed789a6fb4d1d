"""mv_cap=64 EPE column (r2 VERDICT item 4a) -> EVAL_mvcap.json.

Full shipped config (interp 4) with and without the mv_cap=64 clamp, so the
cap's accuracy impact at the sharding-enabling setting is MEASURED rather
than asserted harmless.  Middlebury GT motion tops out ~10 px (x4 interp =
~40 px processed), safely under the cap, so the expected delta is zero -
this run pins that.

Run on the GPU from repo root: python scripts/run_mvcap_eval.py
"""

import json
import os
import time

import _cache  # noqa: F401

from blockbasedmotionestimation.config import MotionConfig
from blockbasedmotionestimation.models import evaluate

GT_DIR = "/root/reference/middlebury/gt-flow"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "EVAL_mvcap.json")

# rival defaults ON since r3 - pin every column's rival flags explicitly so
# the labels stay truthful across default changes
base = MotionConfig(
    interp_factor=4, regularizer="windowed",
    rival_window=False, rival_radius=None,
)
configs = {
    "windowed": base,
    "windowed_cap64": base.replace(mv_cap=64),
    "rival_r8": base.replace(rival_window=True, rival_radius=8),
    "rival_r8_cap64": base.replace(
        rival_window=True, rival_radius=8, mv_cap=64
    ),
}

out = {}
for cname, cfg in configs.items():
    out[cname] = {}
    for seq in evaluate.SEQUENCES:
        t0 = time.time()
        r = evaluate.evaluate_sequence(seq, GT_DIR, cfg)
        out[cname][seq] = r.epe
        print(f"{cname:16s} {seq:12s}: EPE {r.epe:.4f} "
              f"({time.time()-t0:.0f}s)", flush=True)
        with open(OUT, "w") as f:
            json.dump(out, f, indent=1)
for cname in out:
    vals = list(out[cname].values())
    print(f"{cname}: mean {sum(vals)/len(vals):.4f}")
print("wrote", OUT)
