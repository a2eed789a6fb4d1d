"""Photometric-robustness EPE sweep -> EVAL_robust.md + EVAL_robust.json.

The GT-warp suite idealizes brightness constancy; the reference's only
quantitative record (error.txt) is on REAL frames with photometric nuisance.
This sweep measures how each production schedule degrades when frame 1 gets
a controlled gain/offset/noise/occlusion-fill perturbation
(utils.synth.pair_from_gt_photometric).

Run on the GPU from repo root:  python scripts/run_robustness_eval.py [quick]
(quick: 2-level/16px config on 3 sequences for a fast CPU smoke run).

Optional second arg: comma-separated config subset + output suffix, e.g.
``python scripts/run_robustness_eval.py full windowed,rival_r8`` writes
EVAL_robust_windowed_rival_r8.{json,md}.  The unrestricted fourcolor
baseline can run as a separate CPU process
(``JAX_PLATFORMS=cpu ... full fourcolor``) in parallel with the other
configs; ``merge`` combines the partial JSONs into the final
EVAL_robust.md/.json.
"""

import json
import os
import sys
import time

import numpy as np

import _cache  # noqa: F401

from blockbasedmotionestimation.config import MotionConfig
from blockbasedmotionestimation.models import evaluate

GT_DIR = "/root/reference/middlebury/gt-flow"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

VARIANTS = {
    "clean": {},
    "offset+12": {"offset": 12.0},
    "gain1.10": {"gain": 1.10},
    "noise_s4": {"noise_sigma": 4.0},
    "noise_s8": {"noise_sigma": 8.0},
    "occl_fill": {"occlusion_fill": True},
    "combined": {"gain": 1.06, "offset": 6.0, "noise_sigma": 4.0},
}


def _write_md(out: dict, seqs, path: str) -> None:
    lines = [
        "# EVAL_robust — photometric-robustness EPE (synth-warp + nuisance)",
        "",
        "Mean EPE over " + ", ".join(seqs) + " (perturbation applied to frame 1;"
        " see `utils.synth.pair_from_gt_photometric`).  The fourcolor baseline"
        " and the windowed/rival columns come from separate runs.",
        "",
        "| variant | " + " | ".join(out.keys()) + " |",
        "|---|" + "---|" * len(out),
    ]
    for vname in VARIANTS:
        row = [
            f"{out[c][vname]['mean']:.4f}" if vname in out[c] else "n/a"
            for c in out
        ]
        lines.append(f"| {vname} | " + " | ".join(row) + " |")
    lines.append("")
    for cname in out:
        clean = out[cname]["clean"]["mean"]
        worst = max(
            out[cname][v]["mean"] for v in VARIANTS if v in out[cname]
        )
        lines.append(
            f"- **{cname}**: clean {clean:.4f}, worst variant {worst:.4f} "
            f"(degradation {worst - clean:+.4f})."
        )
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def merge(parts: list[str]) -> None:
    """Combine partial EVAL_robust_<suffix>.json files into the final pair."""
    out, seqs = {}, None
    for p in parts:
        with open(p) as f:
            d = json.load(f)
        seqs = d["sequences"]
        out.update(d["results"])
    # canonical column order
    order = [
        c for c in ("fourcolor", "windowed", "rival_r8", "rival_r8_zsad")
        if c in out
    ]
    out = {c: out[c] for c in order + [c for c in out if c not in order]}
    with open(os.path.join(ROOT, "EVAL_robust.json"), "w") as f:
        json.dump({"sequences": seqs, "results": out}, f, indent=1)
    _write_md(out, seqs, os.path.join(ROOT, "EVAL_robust.md"))
    print("wrote EVAL_robust.md / EVAL_robust.json")


def main() -> None:
    if len(sys.argv) > 1 and sys.argv[1] == "merge":
        merge(sys.argv[2:])
        return
    quick = len(sys.argv) > 1 and sys.argv[1] == "quick"
    subset = sys.argv[2].split(",") if len(sys.argv) > 2 else None
    if quick:
        seqs = ("Dimetrodon", "Urban2", "Grove3")
        # rival defaults ON since r3: pin per column
        configs = {
            "windowed": MotionConfig(
                block_sizes=(16, 16), search_sizes=(32, 32), interp_factor=1,
                regularizer="windowed", rival_window=False, rival_radius=None,
            ),
        }
        configs["rival_r8"] = configs["windowed"].replace(
            rival_window=True, rival_radius=8
        )
        configs["fourcolor"] = configs["windowed"].replace(
            regularizer="fourcolor"
        )
    else:
        seqs = evaluate.SEQUENCES
        base = MotionConfig(
            interp_factor=4, regularizer="windowed",
            rival_window=False, rival_radius=None,
        )
        configs = {
            "windowed": base,
            "rival_r8": base.replace(rival_window=True, rival_radius=8),
            "fourcolor": base.replace(regularizer="fourcolor"),
            # r5: zero-mean SAD - the robustness cost (config docs); same
            # production schedule, cost flag only.  Runs on the XLA cost
            # path (zsad is float-valued), so evaluate on CPU like the
            # fourcolor baseline.
            "rival_r8_zsad": base.replace(
                rival_window=True, rival_radius=8, cost="zsad"
            ),
        }

    if subset:
        configs = {c: configs[c] for c in subset}
        suffix = "_" + "_".join(subset)
    else:
        suffix = "_quick" if quick else ""
    jpath = os.path.join(ROOT, f"EVAL_robust{suffix}.json")

    out = {}
    if os.path.exists(jpath):  # resume: variants already measured are kept
        with open(jpath) as f:
            out = json.load(f)["results"]
    for cname, cfg in configs.items():
        out.setdefault(cname, {})
        for vname, kw in VARIANTS.items():
            if vname in out[cname]:
                continue
            epes = []
            for seq in seqs:
                t0 = time.time()
                r = evaluate.evaluate_sequence_photometric(
                    seq, GT_DIR, cfg, **kw
                )
                epes.append(r.epe)
                print(
                    f"{cname:10s} {vname:10s} {seq:12s}: EPE {r.epe:.4f} "
                    f"({time.time()-t0:.0f}s)",
                    flush=True,
                )
            out[cname][vname] = {
                "mean": float(np.mean(epes)),
                "per_seq": dict(zip(seqs, [float(e) for e in epes])),
            }
            with open(jpath, "w") as f:
                json.dump({"sequences": list(seqs), "results": out}, f, indent=1)

    _write_md(out, seqs, os.path.join(ROOT, f"EVAL_robust{suffix}.md"))
    print(f"wrote EVAL_robust{suffix}.md / EVAL_robust{suffix}.json")


if __name__ == "__main__":
    main()
