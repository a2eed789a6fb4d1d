"""Multi-host runtime: distributed init + cross-host mesh construction.

The reference has no distributed story at all (single process, one thread
pool; SURVEY.md section 2.4).  This layer needs no hand-written transport:
``jax.distributed.initialize`` brings up the JAX runtime across hosts, and
the engine's collectives (ppermute halo exchange, batch sharding) run over
NVLink between the GPUs of a host and over the network between hosts.

Layout convention: the "batch" axis maps to hosts (frame pairs never cross a
host boundary -> batch traffic stays off the network and is embarrassingly
parallel), and the "ty" row-tiling axis maps to the GPUs within a host (halo
exchange over NVLink).  ``make_mesh`` builds exactly that.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh


def initialize_from_env(**kwargs) -> None:
    """``jax.distributed.initialize`` with standard env fallbacks.

    Respects COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID when set
    (cluster launchers), else lets JAX auto-detect (for cluster managers
    that expose their own metadata).  Idempotent: a second call is a no-op.
    """
    if getattr(initialize_from_env, "_done", False):
        return
    addr = os.environ.get("COORDINATOR_ADDRESS")
    nproc = os.environ.get("NUM_PROCESSES")
    pid = os.environ.get("PROCESS_ID")
    if addr and nproc and pid:
        kwargs.setdefault("coordinator_address", addr)
        kwargs.setdefault("num_processes", int(nproc))
        kwargs.setdefault("process_id", int(pid))
    jax.distributed.initialize(**kwargs)
    initialize_from_env._done = True


def make_mesh(
    batch: int | None = None,
    tiles: int | None = None,
    devices=None,
) -> Mesh:
    """(batch, ty) mesh over all devices.

    Defaults: batch = number of processes (hosts), tiles = local GPUs per
    host - so halo exchange stays on NVLink and batch parallelism across
    hosts.  On one host this is (1, n).
    """
    devices = np.array(jax.devices() if devices is None else devices)
    n = len(devices)
    if batch is None:
        batch = max(jax.process_count(), 1)
        if n % batch:
            batch = 1
    if tiles is None:
        tiles = n // batch
    if batch * tiles != n:
        raise ValueError(f"mesh {batch}x{tiles} != {n} devices")
    return Mesh(devices.reshape(batch, tiles), ("batch", "ty"))


def describe() -> dict:
    """Structured runtime report (the observability the reference lacks)."""
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
        "backend": jax.default_backend(),
    }
