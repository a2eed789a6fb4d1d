"""One place that points JAX's persistent compilation cache at a directory.

``JAX_COMPILATION_CACHE_DIR``, when set, names the cache and no other path
is set.  Otherwise the cache lives in ``.jax_cache/`` at the root of the
checkout: a fixed path, because the path is part of what a cached entry is
found by.  bench.py, chip_smoke.py, the tests and the scripts call
``enable()`` before their first compile.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable() -> str:
    """Turn the persistent compile cache on; returns its directory."""
    path = os.environ.get(ENV_VAR) or CHECKOUT_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
