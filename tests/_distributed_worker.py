"""Worker for the 2-process jax.distributed CPU test (test_multihost.py).

Each process provisions 4 virtual CPU devices, joins the coordinator, builds
the (batch=2, ty=4) multihost mesh, and runs the combined batch x row-tiled
program on a deterministic 2-pair batch (one pair addressable per process).
Every process then checks its ADDRESSABLE output shards bit-for-bit against
the untiled single-device engine, which it recomputes locally.

Run: _distributed_worker.py <coordinator_addr> <num_processes> <process_id>
"""

import os
import sys


def main() -> int:
    addr, nproc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

    # virtual CPU devices must be provisioned in-process, before backend init
    # (see tests/conftest.py for why the env-var recipe does not work here)
    xla_flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in xla_flags:
        os.environ["XLA_FLAGS"] = (
            xla_flags + " --xla_force_host_platform_device_count=4"
        ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")

    os.environ["COORDINATOR_ADDRESS"] = addr
    os.environ["NUM_PROCESSES"] = str(nproc)
    os.environ["PROCESS_ID"] = str(pid)

    import numpy as np

    from blockbasedmotionestimation.config import MotionConfig
    from blockbasedmotionestimation.models import engine
    from blockbasedmotionestimation.parallel import multihost, tiled

    multihost.initialize_from_env()
    multihost.initialize_from_env()  # idempotency check
    info = multihost.describe()
    assert info["process_count"] == nproc, info
    assert info["local_devices"] == 4, info
    assert info["global_devices"] == 4 * nproc, info

    mesh = multihost.make_mesh()
    assert dict(zip(mesh.axis_names, mesh.devices.shape)) == {
        "batch": nproc, "ty": 4,
    }, mesh

    cfg = MotionConfig(
        block_sizes=(4, 4), search_sizes=(6, 6), interp_factor=1,
        regularizer="windowed",
    )
    h, w = 64, 64
    rng = np.random.default_rng(7)  # same seed everywhere: all pairs known
    base = rng.integers(0, 256, size=(nproc, h + 8, w + 8), dtype=np.uint8)
    im1s = base[:, :h, :w]
    im2s = base[:, 2 : 2 + h, 1 : 1 + w]

    from jax.sharding import NamedSharding, PartitionSpec as P

    sh = NamedSharding(mesh, P("batch", None, None))
    g1 = jax.make_array_from_process_local_data(sh, im1s[pid : pid + 1])
    g2 = jax.make_array_from_process_local_data(sh, im2s[pid : pid + 1])

    flow = tiled.estimate_flow_padded_batch_tiled(g1, g2, cfg, mesh)
    jax.block_until_ready(flow)
    assert flow.shape == (nproc, h, w, 2), flow.shape

    # bit-exactness: every addressable shard equals the untiled engine
    checked = 0
    for shard in flow.addressable_shards:
        b = shard.index[0].start or 0
        want = np.asarray(engine.estimate_flow_padded(im1s[b], im2s[b], cfg))
        got = np.asarray(shard.data)
        rows = shard.index[1]
        np.testing.assert_array_equal(got[0], want[rows])
        checked += 1
    assert checked > 0
    print(f"process {pid}: checked {checked} shards OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
