"""Multi-frame sequence runner with frame-granular checkpoint/resume.

The reference is a one-pair batch program whose only persistence is the
``.flo`` writer (``rw_flow.cpp:139-200``).  Production runs are sequences:
this runner estimates flow for every consecutive frame pair, writes one
``.flo`` (the checkpoint unit) per pair, skips pairs whose output already
exists (resume after interruption), and emits a structured per-pair report -
the observability the reference lacks (SURVEY.md section 5).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Sequence

import numpy as np

from blockbasedmotionestimation.config import MotionConfig
from blockbasedmotionestimation.models.engine import (
    estimate_flow_driver,
    estimate_flow_driver_batched,
)
from blockbasedmotionestimation.utils import flowio


@dataclasses.dataclass
class PairResult:
    index: int
    out_path: str
    seconds: float
    skipped: bool  # already present -> resumed past it


def flo_name(index: int) -> str:
    return f"flow{index:05d}.flo"


def run_sequence(
    frames: Sequence[np.ndarray] | Sequence[str],
    out_dir: str | os.PathLike,
    cfg: MotionConfig,
    progress: Callable[[PairResult], None] | None = None,
    write_report: bool = True,
    batch_size: int = 1,
    out_stride: int = 1,
    transfer_dtype: str = "f32",
) -> list[PairResult]:
    """Estimate flow for every consecutive pair, checkpointing per pair.

    frames: list of (H, W) uint8 arrays or image paths (read as grayscale).
    Existing outputs in out_dir are trusted and skipped (resume semantics);
    delete them to force recompute.  batch_size > 1 groups pending pairs
    into one vmapped device program (throughput mode; the checkpoint unit
    stays one .flo per pair).

    out_stride / transfer_dtype cut the device->host transfer (a 4K field
    is 66 MB of f32 flow).  ``out_stride=s`` subsamples the dense field ON DEVICE at stride s
    before transfer (the reference driver itself writes a stride-subsampled
    field - it samples every interp_factor-th pixel,
    ``main_class.cpp:57-70``); ``transfer_dtype="f16"`` ships float16 and
    upcasts on the host (flow values are quarter-pel integers; f16 is
    exact for |mv| <= 512 at quarter-pel granularity, i.e. every
    Middlebury/production range).  The .flo checkpoint then holds the
    subsampled field at the original numeric values.
    """
    out_dir = os.fspath(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    batch_size = max(1, batch_size)
    if transfer_dtype not in ("f32", "f16"):
        raise ValueError(f"transfer_dtype must be f32 or f16, got {transfer_dtype}")

    import jax
    import jax.numpy as jnp

    @jax.jit
    def _shrink(dev):
        # on-device subsample + downcast BEFORE the device->host copy.
        if out_stride > 1:
            b, h, w, c = dev.shape
            hs, ws = h // out_stride, w // out_stride
            dev = dev[:, : hs * out_stride, : ws * out_stride].reshape(
                b, hs, out_stride, ws, out_stride, c
            )[:, :, 0, :, 0]
        if transfer_dtype == "f16":
            dev = dev.astype(jnp.float16)
        return dev

    cache: dict[int, object] = {}

    def load(i: int):
        # consecutive pairs share a frame; keep a small sliding DEVICE
        # cache so each frame decodes AND uploads once (each 4K frame is
        # 8.3 MB u8 and appears in two pairs)
        if i not in cache:
            f = frames[i]
            arr = (
                flowio.read_gray(f)
                if isinstance(f, (str, os.PathLike))
                else np.asarray(f)
            )
            cache[i] = jax.device_put(jnp.asarray(arr))
            for k in [k for k in cache if k < i - 2 * batch_size]:
                del cache[k]
        return cache[i]

    def write_checkpoint(i: int, flow: np.ndarray, path: str) -> None:
        tmp = path[: -len(".flo")] + ".tmp.flo"
        flowio.write_flo(tmp, flow)
        os.replace(tmp, path)  # atomic: no torn checkpoints on interrupt

    results: list[PairResult] = []

    # pipelined execution: the device program for batch k+1 is ENQUEUED
    # before batch k's results are fetched (the device runs ahead of the
    # host's download + disk writes); .flo checkpoints go to a small thread
    # pool.  At 4K the un-pipelined runner measured ~16x slower than the
    # device (66 MB/.flo transfers + writes on the critical path).
    from concurrent.futures import ThreadPoolExecutor

    def launch(batch: list[tuple[int, str]]):
        # stack ON DEVICE: frames were uploaded once by the device cache
        a = jnp.stack([load(i) for i, _ in batch])
        b = jnp.stack([load(i + 1) for i, _ in batch])
        if batch_size > 1 and len(batch) < batch_size:
            # pad the tail batch to the compiled shape (a fresh batch shape
            # costs a full recompile); extras are dropped
            reps = batch_size - len(batch)
            a = jnp.concatenate([a, jnp.repeat(a[-1:], reps, axis=0)])
            b = jnp.concatenate([b, jnp.repeat(b[-1:], reps, axis=0)])
        if batch_size > 1:
            dev = estimate_flow_driver_batched(a, b, cfg)
        else:
            dev = estimate_flow_driver(a[0], b[0], cfg)[None]
        if out_stride > 1 or transfer_dtype != "f32":
            dev = _shrink(dev)
        return batch, dev, time.time()

    io_pool = ThreadPoolExecutor(max_workers=4)
    write_futs = []

    def drain(in_flight) -> None:
        batch, dev, t0 = in_flight
        flows = np.asarray(dev)  # true barrier: download the whole batch
        if flows.dtype != np.float32:
            flows = flows.astype(np.float32)  # .flo stores f32
        per = (time.time() - t0) / len(batch)
        for (i, path), flow in zip(batch, flows):
            write_futs.append(
                io_pool.submit(write_checkpoint, i, np.ascontiguousarray(flow), path)
            )
            r = PairResult(index=i, out_path=path, seconds=per, skipped=False)
            results.append(r)
            if progress is not None:
                progress(r)

    pending: list[tuple[int, str]] = []
    in_flight = None
    for i in range(len(frames) - 1):
        path = os.path.join(out_dir, flo_name(i))
        if os.path.exists(path):
            r = PairResult(index=i, out_path=path, seconds=0.0, skipped=True)
            results.append(r)
            if progress is not None:
                progress(r)
            continue
        pending.append((i, path))
        if len(pending) >= batch_size:
            nxt = launch(pending)
            pending = []
            if in_flight is not None:
                drain(in_flight)
            in_flight = nxt
    if pending:
        nxt = launch(pending)
        if in_flight is not None:
            drain(in_flight)
        in_flight = nxt
    if in_flight is not None:
        drain(in_flight)
    for f in write_futs:
        f.result()
    io_pool.shutdown()
    results.sort(key=lambda r: r.index)

    if write_report:
        done = [r for r in results if not r.skipped]
        report = {
            "pairs": len(results),
            "computed": len(done),
            "resumed": len(results) - len(done),
            "total_seconds": round(sum(r.seconds for r in done), 3),
            "pairs_per_sec": (
                round(len(done) / max(sum(r.seconds for r in done), 1e-9), 4)
                if done else None
            ),
            "out_stride": out_stride,
            "transfer_dtype": transfer_dtype,
            "config": {
                "block_sizes": list(cfg.block_sizes),
                "search_sizes": list(cfg.search_sizes),
                "interp_factor": cfg.interp_factor,
                "regularizer": cfg.regularizer,
                "cost": cfg.cost,
            },
        }
        with open(os.path.join(out_dir, "report.json"), "w") as f:
            json.dump(report, f, indent=2)
    return results
