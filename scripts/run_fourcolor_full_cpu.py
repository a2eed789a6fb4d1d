"""Full shipped-config fourcolor EPE baseline, on CPU (background run).

The gather-based fourcolor path at 4x-interpolated resolution runs as a
separate CPU process beside the accelerator runs; it gives the same numbers
on any backend (the pipeline is deterministic given impl='xla').
Writes EVAL_fourcolor_full.json as sequences complete.
"""

import json
import os
import time

# pin the platform in-process like tests/conftest.py does, so this run
# leaves any accelerator to the other evaluation processes
import _cache  # noqa: F401

import jax

jax.config.update("jax_platforms", "cpu")
assert jax.default_backend() == "cpu", jax.default_backend()

from blockbasedmotionestimation.config import MotionConfig
from blockbasedmotionestimation.models import evaluate

GT_DIR = "/root/reference/middlebury/gt-flow"
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "EVAL_fourcolor_full.json")

cfg = MotionConfig(interp_factor=4, regularizer="fourcolor", search_impl="xla")

results = {}
for seq in evaluate.SEQUENCES:
    t0 = time.time()
    r = evaluate.evaluate_sequence(seq, GT_DIR, cfg)
    results[seq] = {"epe": r.epe, "seconds": time.time() - t0}
    print(f"{seq}: EPE {r.epe:.4f} ({results[seq]['seconds']:.0f}s)", flush=True)
    with open(OUT, "w") as f:
        json.dump({"config": "full fourcolor (xla, cpu)", "results": results}, f, indent=1)
print("done")
