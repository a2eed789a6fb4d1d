"""Tracing and performance accounting.

The reference's entire observability is one wall-clock print
(``main_class.cpp:47-55``).  Here:

  * ``phase`` - a context-manager timer that waits for the arrays it is
    given before stopping the clock;
  * ``trace`` - jax.profiler wrapper writing a TensorBoard/perfetto trace.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import jax


def sync(*arrays) -> None:
    """Wait until the device has computed every array."""
    jax.block_until_ready(arrays)


@dataclass
class PhaseTimes:
    times: dict = field(default_factory=dict)

    def report(self) -> str:
        total = sum(self.times.values())
        lines = [f"{name:<28} {t*1000:9.2f} ms" for name, t in self.times.items()]
        lines.append(f"{'total':<28} {total*1000:9.2f} ms")
        return "\n".join(lines)


@contextlib.contextmanager
def phase(name: str, times: PhaseTimes, *sync_arrays):
    t0 = time.time()
    try:
        yield
    finally:
        if sync_arrays:
            sync(*sync_arrays)
        times.times[name] = times.times.get(name, 0.0) + (time.time() - t0)


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace around a block (view in TensorBoard/perfetto)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
