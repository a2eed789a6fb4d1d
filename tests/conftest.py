"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-device sharding logic is validated without a GPU cluster by forcing the
host platform to expose 8 virtual devices, per the standard JAX testing
recipe: ``XLA_FLAGS`` is extended in-process and the platform pinned to the
CPU through ``jax.config`` before any backend is initialized.  Run the suite
with ``JAX_PLATFORMS=cpu python -m pytest tests/``; ``python chip_smoke.py``
runs the compiled GPU kernels on the card.
"""

import os

xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

from blockbasedmotionestimation.utils import compile_cache

# persistent compilation cache: the suite compiles hundreds of programs
# (forced 8-device mesh, interpret-mode Pallas); caching makes repeat runs
# minutes faster
compile_cache.enable()

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
