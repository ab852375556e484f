"""In-chunk Gauss-Seidel for the CD block solver as a Pallas kernel
(Triton route, for NVIDIA GPUs).

One sweep of :func:`slim_tpu.ops.cd_kernel._cd_core` visits the
coordinates in chunks of ``CHUNK``; inside a chunk every update depends on
the previous one (the chunk's q entries move with each update), so XLA
runs the 128 steps as 128 tiny dependent programs.  This kernel runs the
whole chunk in one launch: each program owns ``BB`` independent columns
(rows of the block) and keeps their (BB, CHUNK) tiles of the residual
``r = gj - q``, of ``x`` and of the per-coordinate threshold in registers,
reading one row of the chunk's (CHUNK, CHUNK) Gram block per step.

Propagation of the finished chunk to the rest of ``q`` stays outside, as
one XLA matrix product over all B columns (reads each Gram chunk once per
block instead of once per program).

Threshold encoding: ``t[b, i]`` is the column's l1r where coordinate i is
active and the column still live, +inf otherwise; an +inf coordinate keeps
its value (inactive coordinates hold 0, a finished column keeps x).
:func:`slim_tpu.ops.cd_kernel.gs_chunk_xla` is the same step in XLA.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

CHUNK = 128  # coordinates per Gauss-Seidel chunk
BB = 8       # block columns per kernel program


def gs_supported(B: int, chunk: int = CHUNK) -> bool:
    """Shapes the kernel takes: whole programs of BB columns, one chunk."""
    return B >= BB and B % BB == 0 and chunk == CHUNK


def _gs_kernel(r_ref, x_ref, t_ref, l2_ref, d_ref, g_ref, p_ref, o_ref):
    r = r_ref[...]
    x = x_ref[...]
    t = t_ref[...]
    l2 = l2_ref[...]
    lanes = lax.broadcasted_iota(jnp.int32, (1, CHUNK), 1)

    def body(ci, carry):
        r, x = carry
        i = p_ref[ci]
        sel = lanes == i
        # lane i of each register tile: masked row sums
        xc = jnp.sum(jnp.where(sel, x, 0.0), axis=1)
        rc = jnp.sum(jnp.where(sel, r, 0.0), axis=1)
        tc = jnp.sum(jnp.where(sel, t, 0.0), axis=1)
        di = d_ref[i]
        num = rc + di * xc
        cand = jnp.where(num > tc, (num - tc) / (di + l2), 0.0)
        newx = jnp.where(tc < jnp.inf, cand, xc)
        grow = g_ref[i, :]
        r = r - (newx - xc)[:, None] * grow[None, :]
        x = jnp.where(sel, newx[:, None], x)
        return r, x

    _, x = lax.fori_loop(0, CHUNK, body, (r, x))
    o_ref[...] = x


@functools.partial(jax.jit, static_argnames=("interpret",))
def gs_chunk(r, x, t, l2, d, gcc, perm, interpret=False):
    """Gauss-Seidel over one chunk for B columns at once.

    r, x, t : (B, CHUNK) f32   residual gj - q, solution, threshold
    l2 : (B,) f32              per-column l2r
    d : (CHUNK,) f32           diag(G) on the chunk
    gcc : (CHUNK, CHUNK) f32   the chunk's diagonal Gram block
    perm : (CHUNK,) int32      visit order inside the chunk
    Returns the updated x (B, CHUNK).
    """
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    B = x.shape[0]
    if not gs_supported(B, x.shape[1]):
        raise ValueError(f"gs_chunk takes B % {BB} == 0 and width "
                         f"{CHUNK}; got {x.shape}")
    tile = pl.BlockSpec((BB, CHUNK), lambda i: (i, 0))
    vec = pl.BlockSpec((BB,), lambda i: (i,))
    row = pl.BlockSpec((CHUNK,), lambda i: (0,))
    blk = pl.BlockSpec((CHUNK, CHUNK), lambda i: (0, 0))
    return pl.pallas_call(
        _gs_kernel,
        out_shape=jax.ShapeDtypeStruct((B, CHUNK), jnp.float32),
        grid=(B // BB,),
        in_specs=[tile, tile, tile, vec, row, blk, row],
        out_specs=tile,
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="cd_gs_chunk",
    )(r, x, t, l2, d, gcc, perm)
