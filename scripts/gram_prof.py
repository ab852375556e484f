"""Profile the device Gram at ML-20M shape: isolate scatter vs matmul
pass-count cost, and check whether bf16-exact values allow a single bf16
product (DEFAULT precision) instead of the full-f32 HIGHEST one.

Usage: python scripts/gram_prof.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax
import jax.numpy as jnp
import numpy as np

import bench
from slim_tpu.utils import enable_compilation_cache

enable_compilation_cache()

train, name, _ = bench.load_workload()
train = train.infer_ncols()
print(f"{name} {train.nrows}x{train.ncols} nnz={train.nnz}", flush=True)

npad = 28672
rb = 8192
nrb = (train.nrows + rb - 1) // rb
starts = train.indptr[np.minimum(
    np.arange(nrb + 1, dtype=np.int64) * rb, train.nrows)].astype(np.int32)
P = 1 << int(np.diff(starts).max() - 1).bit_length()
nnz = int(train.nnz)
idx_h = train.indices.astype(np.uint16)
print(f"npad {npad} rb {rb} nrb {nrb} P {P}", flush=True)

idx = jnp.asarray(idx_h)
indptr = jnp.asarray(train.indptr.astype(np.int32))
starts_d = jnp.asarray(starts)
jax.block_until_ready((idx, indptr, starts_d))


def make(prec, do_dot=True, do_scatter=True):
    @jax.jit
    def gram_csr(idx, starts, indptr):
        def body(g, k):
            s = starts[k]
            e = s + jnp.arange(P, dtype=jnp.int32)
            valid = e < starts[k + 1]
            esafe = jnp.minimum(e, nnz - 1)
            c = jnp.take(idx, esafe).astype(jnp.int32)
            r = jnp.searchsorted(indptr, esafe, side="right") \
                .astype(jnp.int32) - 1
            l = jnp.where(valid, r - k * rb, rb)
            v = valid.astype(jnp.float32)
            if do_scatter:
                blk = jnp.zeros((rb, npad), jnp.float32)
                blk = blk.at[l, c].add(v, unique_indices=True, mode="drop")
            else:
                blk = jnp.zeros((rb, npad), jnp.float32) \
                    .at[0, 0].add(jnp.sum(v))
            if do_dot:
                g = g + jnp.dot(blk.T, blk,
                                preferred_element_type=jnp.float32,
                                precision=prec)
            else:
                g = g + jnp.sum(blk)
            return g, None

        g0 = jnp.zeros((npad, npad), jnp.float32) if do_dot \
            else jnp.zeros((), jnp.float32)
        g, _ = jax.lax.scan(body, g0, jnp.arange(nrb, dtype=jnp.int32))
        return g

    return gram_csr


variants = [
    ("scatter-only", make(None, do_dot=False)),
    ("highest", make(jax.lax.Precision.HIGHEST)),
    ("default", make(jax.lax.Precision.DEFAULT)),
]
ref = None
for nm, fn in variants:
    def sync(o):
        return float(o.ravel()[0] if o.ndim else o)
    t0 = time.perf_counter()
    out = fn(idx, starts_d, indptr); sync(out)
    t_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = fn(idx, starts_d, indptr); sync(out)
    t_warm = time.perf_counter() - t0
    print(f"{nm}: cold {t_cold:.1f}s warm {t_warm:.2f}s", flush=True)
    if nm == "highest":
        ref = out
    if nm == "default" and ref is not None:
        # binary data: DEFAULT must be bit-exact vs HIGHEST
        d = jnp.max(jnp.abs(out[:2048] - ref[:2048]))
        print(f"default-vs-highest max|diff| (2048 rows): {float(d)}",
              flush=True)
