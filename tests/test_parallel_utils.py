"""Multihost helpers, profiling utilities and the compile-cache helper."""

import jax
import numpy as np

from blockbasedmotionestimation.parallel import multihost
from blockbasedmotionestimation.utils import profiling


def test_make_mesh_shapes():
    mesh = multihost.make_mesh(batch=2, tiles=4)
    assert mesh.shape == {"batch": 2, "ty": 4}
    mesh = multihost.make_mesh()  # 1 process -> batch 1, all devices tiled
    assert mesh.shape["batch"] * mesh.shape["ty"] == len(jax.devices())


def test_describe_keys():
    d = multihost.describe()
    assert d["process_count"] == 1
    assert d["global_devices"] == len(jax.devices())


def test_phase_timer(rng):
    times = profiling.PhaseTimes()
    x = jax.numpy.asarray(rng.standard_normal((64, 64)).astype(np.float32))
    with profiling.phase("matmul", times, x):
        y = x @ x
    with profiling.phase("matmul", times, y):
        y = y @ x
    assert times.times["matmul"] > 0
    assert "total" in times.report()


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    # JAX_COMPILATION_CACHE_DIR set: the cache goes exactly there
    from blockbasedmotionestimation.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert compile_cache.enable() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_default_inside_checkout(monkeypatch):
    # unset: a fixed .jax_cache/ at the checkout root (listed in .gitignore)
    import os

    from blockbasedmotionestimation.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        assert compile_cache.enable() == os.path.join(root, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == os.path.join(
            root, ".jax_cache"
        )
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
