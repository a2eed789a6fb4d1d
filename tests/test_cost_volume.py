"""The Pallas cost-volume kernel (interpreted on the CPU) and its selection.

The compiled kernel runs only on a GPU; ``chip_smoke.py`` checks it there
against the same XLA reference at 1080p shapes.
"""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from blockbasedmotionestimation.config import MotionConfig
from blockbasedmotionestimation.kernels.cost_volume import pooled_cost_volumes
from blockbasedmotionestimation.ops.search import resolve_impl
from blockbasedmotionestimation.ops.windowed import _compute_cv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(rng, npy, npx, bs, ext):
    ws = bs + 2 * ext
    patches = rng.integers(0, 256, size=(npy, npx, bs, bs)).astype(np.int16)
    windows = rng.integers(0, 256, size=(npy, npx, ws, ws)).astype(np.int16)
    return jnp.asarray(patches), jnp.asarray(windows)


@pytest.mark.parametrize(
    "bs,ext,r,cost",
    [
        (2, 2, 1, "sad"),
        (4, 3, 3, "ssd"),
        (8, 4, 4, "sad"),
        (8, 4, 2, "ssd"),
        (16, 8, 3, "sad"),
        (16, 6, 6, "ssd"),
        (32, 2, 1, "sad"),
        (32, 3, 2, "ssd"),
    ],
)
def test_kernel_matches_compute_cv(rng, bs, ext, r, cost):
    # every pooled size from the one difference pass equals the XLA build
    # of that size (values and dtype), including r < ext (rival volumes)
    patches, windows = _inputs(rng, 3, 5, bs, ext)
    vols = pooled_cost_volumes(
        patches, windows, bs=bs, ext=ext, r=r, cost=cost, interpret=True
    )
    assert sorted(vols) == [2 << k for k in range(bs.bit_length() - 1)]
    for cur, vol in vols.items():
        want = _compute_cv(patches, windows, bs, cur, ext, r, cost)
        assert vol.dtype == want.dtype, cur
        np.testing.assert_array_equal(np.asarray(vol), np.asarray(want))


def test_kernel_under_vmap(rng):
    # the engine vmaps whole levels over frame pairs
    pb = [_inputs(rng, 2, 4, 8, 4) for _ in range(3)]
    patches = jnp.stack([p for p, _ in pb])
    windows = jnp.stack([w for _, w in pb])
    vols = jax.vmap(
        lambda p, w: pooled_cost_volumes(
            p, w, bs=8, ext=4, r=4, cost="sad", interpret=True
        )
    )(patches, windows)
    for i in range(3):
        for cur in (2, 4, 8):
            want = _compute_cv(patches[i], windows[i], 8, cur, 4, 4, "sad")
            np.testing.assert_array_equal(
                np.asarray(vols[cur][i]), np.asarray(want)
            )


def test_kernel_extreme_values():
    # all-255 patches against all-0 windows: the largest cost of every size
    # (ssd at cur=32 is 255^2 * 1024, far above u16)
    bs, ext, r = 32, 1, 1
    patches = jnp.full((1, 2, bs, bs), 255, jnp.int16)
    windows = jnp.zeros((1, 2, bs + 2, bs + 2), jnp.int16)
    for cost, unit in (("sad", 255), ("ssd", 255 * 255)):
        vols = pooled_cost_volumes(
            patches, windows, bs=bs, ext=ext, r=r, cost=cost, interpret=True
        )
        for cur, vol in vols.items():
            assert (np.asarray(vol) == unit * cur * cur).all(), (cost, cur)


def test_kernel_rejects_zsad(rng):
    patches, windows = _inputs(rng, 1, 1, 4, 2)
    with pytest.raises(ValueError, match="sad/ssd"):
        pooled_cost_volumes(
            patches, windows, bs=4, ext=2, r=2, cost="zsad", interpret=True
        )


@pytest.mark.parametrize(
    "impl,cost,want",
    [
        ("auto", "sad", "auto"),
        ("auto", "zsad", "xla"),
        ("xla", "ssd", "xla"),
        ("triton_interpret", "sad", "triton_interpret"),
    ],
)
def test_resolve_impl_on_cpu(impl, cost, want):
    assert jax.default_backend() == "cpu"
    assert resolve_impl(impl, cost) == want


def test_triton_without_gpu_is_an_error():
    # never a silent fallback to the XLA path
    with pytest.raises(RuntimeError, match="needs a GPU"):
        resolve_impl("triton", "sad")
    with pytest.raises(ValueError, match="unknown search impl"):
        resolve_impl("pallas", "sad")


def test_config_rejects_kernel_with_zsad():
    with pytest.raises(ValueError, match="zsad"):
        MotionConfig(cost="zsad", search_impl="triton")
    MotionConfig(cost="zsad", search_impl="auto")


def _smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = cwd
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_refuses_cpu():
    # no accelerator: non-zero exit and no result line
    proc = _smoke(REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    # a directory holding chip_smoke.py and nothing else of the repo
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _smoke(str(tmp_path))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
