"""Pooled cost volumes from one difference pass (Pallas, Triton route).

For each parent block and each candidate delta in [-r, r]^2 the kernel
differences the parent's (bs, bs) frame-1 patch against the shifted frame-2
window ONCE and sums the result into every sub-block size the level uses:
the cur=2 volume straight from four stride-2 loads, then each coarser size
by summing 2x2 groups of the next finer one, up to cur=bs (the search
volume).  ``ops.windowed._compute_cv`` - the plain XLA reference - makes one
difference pass per size.

Each program takes a few neighbouring parent blocks of one row and keeps
their patches on chip (an int16 32x32 patch and 64x64 window per parent at
the default config, the shifted window loads served from L1); it walks the
deltas in a loop and writes only the volumes.

Output layout: one volume per size, delta-major ``(side^2, nby, nbx)``, the
layout ``_compute_cv`` returns.  The search argmin reduces it over axis 0
with neighbouring parents on neighbouring addresses, and the rounds'
candidate gather reads neighbouring cells of one colour two elements apart.

sad and ssd only: zsad's per-block mean is float-valued and stays on the
XLA path.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu


def cv_dtype(cur: int, cost: str):
    """Smallest dtype holding a worst-case block cost at sub-block size cur."""
    if cost == "zsad":
        return jnp.float32  # mean-subtracted costs are float-valued
    peak = (255 * 255 if cost == "ssd" else 255) * cur * cur
    return jnp.uint16 if peak < (1 << 16) else jnp.int32


# program shape: parents per program (along a parent row) and warps per
# program.  On an H100 at the 1080p level-0 shapes, 4 parents on 1 warp ran
# fastest of 1-8 parents on 1-4 warps (r=16: 16.5 ms per B=8 call against
# 45.8 ms for 1 parent on 1 warp).
PARENTS_PER_PROGRAM = 4
NUM_WARPS = 1


def _kernel(p_ref, w_ref, *out_refs, bs, ext, r, cost, g):
    py = pl.program_id(0)
    cols = pl.ds(pl.program_id(1) * g, g)
    h = bs // 2
    side = 2 * r + 1
    subs = ((0, 0), (0, 1), (1, 0), (1, 1))
    patch = [
        p_ref[py, cols, pl.ds(a, h, 2), pl.ds(b, h, 2)].astype(jnp.int32)
        for a, b in subs
    ]  # each (g, h, h)

    def delta(dy, dx):
        y0 = ext - r + dy
        x0 = ext - r + dx
        t = None
        for (a, b), pq in zip(subs, patch):
            wq = w_ref[py, cols, pl.ds(y0 + a, h, 2), pl.ds(x0 + b, h, 2)]
            diff = pq - wq.astype(jnp.int32)
            term = jnp.abs(diff) if cost == "sad" else diff * diff
            t = term if t is None else t + term
        # t: (g, f, f) costs at cur=2; pool 2x2 upward to cur=bs
        d = dy * side + dx
        f = h
        for o_ref in out_refs:
            o_ref[d, py, :, cols, :] = t.transpose(1, 0, 2).astype(o_ref.dtype)
            if f > 1:
                t = t.reshape(g, f // 2, 2, f // 2, 2).sum(axis=(2, 4))
                f //= 2

    def row(dy, carry):
        return jax.lax.fori_loop(
            0, side, lambda dx, c: (delta(dy, dx), c)[1], carry
        )

    jax.lax.fori_loop(0, side, row, 0)


@functools.partial(
    jax.jit, static_argnames=("bs", "ext", "r", "cost", "interpret")
)
def pooled_cost_volumes(
    patches: jnp.ndarray,  # (npy, npx, bs, bs) i16 frame-1 parent blocks
    windows: jnp.ndarray,  # (npy, npx, wside, wside) i16 frame-2 windows
    *,
    bs: int,
    ext: int,
    r: int,
    cost: str,
    interpret: bool = False,
) -> dict[int, jnp.ndarray]:
    """{cur: (side^2, npy*f, npx*f) volume} for cur = 2, 4, ..., bs.

    Bit-equal to ``ops.windowed._compute_cv`` at every size (integer sums).
    ``interpret=True`` runs the kernel through the Pallas interpreter (CPU
    tests); otherwise it compiles for the GPU through Triton.
    """
    if cost not in ("sad", "ssd"):
        raise ValueError(f"the cost-volume kernel implements sad/ssd, got {cost}")
    npy, npx = patches.shape[:2]
    side = 2 * r + 1
    curs = []
    cur = 2
    while cur <= bs:
        curs.append(cur)
        cur *= 2
    out_shape = [
        jax.ShapeDtypeStruct(
            (side * side, npy, bs // c, npx, bs // c), cv_dtype(c, cost)
        )
        for c in curs
    ]
    g = math.gcd(npx, PARENTS_PER_PROGRAM)
    outs = pl.pallas_call(
        functools.partial(_kernel, bs=bs, ext=ext, r=r, cost=cost, g=g),
        out_shape=out_shape,
        grid=(npy, npx // g),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="pooled_cost_volumes",
    )(patches, windows)
    return {
        c: o.reshape(side * side, npy * (bs // c), npx * (bs // c))
        for c, o in zip(curs, outs)
    }
