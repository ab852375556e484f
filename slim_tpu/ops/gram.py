"""Gram matrix (G = AᵀA) computation.

The single most important algorithmic transform of the rebuild
(SURVEY.md §7): the reference recomputes ``ATy = AᵀA[:,j]`` per item column
inside an O(ncols·nnz) scalar loop (src/libslim/estimate.c:411-421) and
sparse inner products inside every CD step (src/libslim/cd.c:123).  We
compute G once -- on the device as tiled dense matrix products, or on the
host with a sparse SpGEMM -- after which both the active-set screen and
every CD sweep become pure vector math against G.

G is symmetric (ncols × ncols), f32.  ``G[i,j] = aᵢᵀaⱼ``; ``diag(G) =
cnorms²`` (the reference's ``aTa*aTa``, cd.c:119-127).
"""

from __future__ import annotations

import numpy as np

from ..types import CSR


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def gram_host(mat: CSR, pad_to: int | None = None) -> np.ndarray:
    """Sparse Gram on the host (C-speed, exploits sparsity).

    Cost is Σᵤ nnzᵤ² -- orders of magnitude below the dense-matmul FLOP
    count when the matrix is very sparse, so this wins for huge sparse
    inputs where even the device would grind through mostly-zero tiles.
    Uses the native OpenMP kernel (writes straight into the padded
    buffer, no intermediate copies); scipy SpGEMM as fallback.
    """
    n = pad_to if pad_to is not None else mat.ncols
    try:
        from .. import native

        if native.available():
            return native.gram_dense(mat, pad_to=n)
    except Exception:
        pass
    sp = mat.to_scipy()
    g = (sp.T @ sp).toarray().astype(np.float32)
    if n != mat.ncols:
        out = np.zeros((n, n), dtype=np.float32)
        out[:mat.ncols, :mat.ncols] = g
        return out
    return g


_gram_acc = None


def _get_gram_acc():
    """Module-level jitted accumulator (defining it per call would
    recompile on every learn)."""
    global _gram_acc
    if _gram_acc is None:
        import jax
        import jax.numpy as jnp

        @jax.jit
        def acc(g, blk):
            return g + jnp.dot(blk.T, blk, preferred_element_type=jnp.float32,
                               precision=jax.lax.Precision.HIGHEST)

        _gram_acc = acc
    return _gram_acc


def gram_device(mat: CSR, pad_to: int | None = None, row_block: int = 8192):
    """Dense tiled Gram on the device: G = Σ_r A_rᵀ A_r over row blocks.

    Each row block is densified host-side (bounded memory) and accumulated
    with f32 products (precision=HIGHEST so implicit 0/1 data gives exact
    integer counts).  Returns a device array.
    """
    import jax.numpy as jnp

    n = pad_to if pad_to is not None else mat.ncols
    n = _round_up(max(n, 1), 128)

    acc = _get_gram_acc()
    g = jnp.zeros((n, n), dtype=jnp.float32)
    vals = mat.values()
    for r0 in range(0, mat.nrows, row_block):
        r1 = min(r0 + row_block, mat.nrows)
        blk = np.zeros((row_block, n), dtype=np.float32)
        s, e = int(mat.indptr[r0]), int(mat.indptr[r1])
        rows = np.repeat(np.arange(r0, r1), np.diff(mat.indptr[r0:r1 + 1]).astype(np.int64))
        blk[rows - r0, mat.indices[s:e]] = vals[s:e]
        g = acc(g, jnp.asarray(blk))
    return g


_gram_sparse_fns: dict = {}


def _get_gram_sparse(rb: int, npad: int):
    """Jitted sparse-to-Gram kernel, cached per (rb, npad).

    Each scan step scatter-densifies ONE row block from its pre-bucketed
    (local_row, col, val) triplets -- padding entries carry local_row=rb,
    which is out of bounds and dropped (mode='drop'), so the in-bounds
    indices stay unique and the scatter takes the fast path -- then
    accumulates G += blkᵀ·blk with exact f32 products.
    """
    key = (rb, npad)
    fn = _gram_sparse_fns.get(key)
    if fn is None:
        import jax
        import jax.numpy as jnp

        @jax.jit
        def gram_sparse(lr, cols, vals):
            def body(g, xs):
                l, c, v = xs
                blk = jnp.zeros((rb, npad), jnp.float32)
                blk = blk.at[l, c].add(v, unique_indices=True, mode="drop")
                return g + jnp.dot(
                    blk.T, blk, preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST), None

            g0 = jnp.zeros((npad, npad), jnp.float32)
            g, _ = jax.lax.scan(body, g0, (lr, cols, vals))
            return g

        fn = _gram_sparse_fns[key] = gram_sparse
    return fn


def gram_device_sparse(mat: CSR, pad_to: int | None = None,
                       row_block: int = 8192):
    """Device Gram that transfers only the sparse triplets (~12·nnz bytes
    instead of n²·4 for the host path or nrows·n·4 for dense row blocks).

    Triplets are bucketed per row block host-side (CSR is already
    row-sorted, so this is a reshape, not a sort): scatter work per scan
    step is O(block nnz), not O(total nnz).
    """
    import jax.numpy as jnp

    n = pad_to if pad_to is not None else mat.ncols
    n = _round_up(max(n, 1), 128)
    nrb = max((mat.nrows + row_block - 1) // row_block, 1)
    starts = mat.indptr[np.minimum(
        np.arange(nrb + 1, dtype=np.int64) * row_block,
        mat.nrows)].astype(np.int64)
    bnnz = np.diff(starts)
    P = 1
    while P < max(int(bnnz.max()) if nrb else 1, 1):
        P *= 2
    lr = np.full((nrb, P), row_block, dtype=np.int32)   # OOB => dropped
    cc = np.zeros((nrb, P), dtype=np.int32)
    vv = np.zeros((nrb, P), dtype=np.float32)
    rows = np.repeat(np.arange(mat.nrows, dtype=np.int64),
                     np.diff(mat.indptr).astype(np.int64))
    vals = mat.values()
    for k in range(nrb):
        s, e = starts[k], starts[k + 1]
        lr[k, :e - s] = (rows[s:e] - k * row_block).astype(np.int32)
        cc[k, :e - s] = mat.indices[s:e]
        vv[k, :e - s] = vals[s:e]
    fn = _get_gram_sparse(row_block, n)
    return fn(jnp.asarray(lr), jnp.asarray(cc), jnp.asarray(vv))


_gram_csr_fns: dict = {}


def _get_gram_csr(rb: int, npad: int, P: int, nrb: int, ones: bool,
                  nnz: int, nrows: int, bf16_exact: bool = False):
    """Jitted CSR-to-Gram kernel: ships only the CSR column indices
    (uint16 when the catalogue fits, i.e. 2 bytes/nnz) and expands the
    per-row-block padded triplets ON DEVICE by gather + searchsorted
    (the 12-byte/nnz padded host triplets of :func:`gram_device_sparse`
    move 6x the bytes).  Values are implicit 1.0 for binary matrices
    (``ones``) and shipped f32 otherwise.

    ``bf16_exact``: every value round-trips through bf16 exactly (always
    true for binary data; true for integer ratings <= 256, the common
    case).  Then a bf16 x bf16 product with f32 accumulation is
    numerically identical to the f32 product -- products of exact-bf16
    inputs are exact in the f32 accumulator -- and runs on the GPU's bf16
    tensor cores instead of full-f32 arithmetic."""
    key = (rb, npad, P, nrb, ones, nnz, nrows, bf16_exact)
    fn = _gram_csr_fns.get(key)
    if fn is None:
        import jax
        import jax.numpy as jnp

        prec = (jax.lax.Precision.DEFAULT if bf16_exact
                else jax.lax.Precision.HIGHEST)

        @jax.jit
        def gram_csr(idx, val, starts, indptr):
            def body(g, k):
                s = starts[k]
                e = s + jnp.arange(P, dtype=jnp.int32)
                valid = e < starts[k + 1]
                esafe = jnp.minimum(e, nnz - 1)
                c = jnp.take(idx, esafe).astype(jnp.int32)
                r = jnp.searchsorted(indptr, esafe, side="right") \
                    .astype(jnp.int32) - 1
                l = jnp.where(valid, r - k * rb, rb)   # OOB pad -> dropped
                if ones:
                    v = valid.astype(jnp.float32)
                else:
                    v = jnp.where(valid, jnp.take(val, esafe), 0.0)
                blk = jnp.zeros((rb, npad), jnp.float32)
                blk = blk.at[l, c].add(v, unique_indices=True, mode="drop")
                if bf16_exact:
                    blk = blk.astype(jnp.bfloat16)
                return g + jnp.dot(
                    blk.T, blk, preferred_element_type=jnp.float32,
                    precision=prec), None

            g0 = jnp.zeros((npad, npad), jnp.float32)
            g, _ = jax.lax.scan(body, g0, jnp.arange(nrb, dtype=jnp.int32))
            return g

        fn = _gram_csr_fns[key] = gram_csr
    return fn


def _values_bf16_exact(vals: np.ndarray) -> bool:
    """True when every value survives an f32->bf16->f32 round trip, so a
    single bf16 product reproduces the HIGHEST-precision Gram exactly."""
    if vals.size == 0:
        return True
    try:
        import ml_dtypes

        rt = vals.astype(ml_dtypes.bfloat16).astype(np.float32)
    except ImportError:
        # bf16 = f32 with the bottom 16 mantissa bits dropped
        rt = (vals.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    return bool(np.array_equal(rt, vals))


def gram_device_csr(mat: CSR, pad_to: int | None = None,
                    row_block: int = 8192):
    """Device Gram shipping ~2 bytes/nnz (binary) or ~6 bytes/nnz: CSR
    column indices (+ values when non-binary) upload once; row ids and the
    per-row-block bucketing are reconstructed on device."""
    import jax
    import jax.numpy as jnp

    n = pad_to if pad_to is not None else mat.ncols
    n = _round_up(max(n, 1), 128)
    nrb = max((mat.nrows + row_block - 1) // row_block, 1)
    starts = mat.indptr[np.minimum(
        np.arange(nrb + 1, dtype=np.int64) * row_block,
        mat.nrows)].astype(np.int32)
    bnnz = np.diff(starts)
    P = 1
    while P < max(int(bnnz.max()) if nrb else 1, 1):
        P *= 2
    vals = mat.values()
    ones = bool(vals.size == 0 or
                (vals[0] == 1.0 and np.all(vals == 1.0)))
    idt = np.uint16 if n <= 65536 else np.int32
    idx_d = mat.dev_put(("idx", idt.__name__),
                        lambda: jnp.asarray(mat.indices.astype(idt)))
    val_d = jnp.zeros((1,), jnp.float32) if ones \
        else mat.dev_put("val32",
                         lambda: jnp.asarray(vals.astype(np.float32)))
    fn = _get_gram_csr(row_block, n, P, nrb, ones, max(int(mat.nnz), 1),
                       mat.nrows,
                       bf16_exact=ones or _values_bf16_exact(vals))
    return fn(idx_d, val_d, jnp.asarray(starts),
              mat.dev_put("gram_indptr32",
                          lambda: jnp.asarray(mat.indptr.astype(np.int32))))


def compute_gram(mat: CSR, mode: str = "auto", pad_to: int | None = None):
    """Compute G, returning a device array padded to ``pad_to`` (multiple of
    128 recommended).

    mode='auto' computes G on the device when the dense G and the
    solver's working set fit the device memory (:func:`gram_fits_device`),
    and on the host with the sparse SpGEMM otherwise (then uploaded).
    """
    import jax.numpy as jnp

    n = pad_to if pad_to is not None else mat.ncols
    if mode == "host" or (mode == "auto" and not gram_fits_device(n)):
        return jnp.asarray(gram_host(mat, pad_to=n))
    if mode in ("device", "auto"):
        return gram_device_csr(mat, pad_to=n)
    raise ValueError(f"unknown gram mode {mode!r}")


# solver columns a block holds next to G (the largest block of
# ops/cd_kernel.MAX_BLOCK)
_WORKSPACE_COLS = 1024


def gram_fits_device(npad: int) -> bool:
    """True when the device can hold what a learn keeps there: G, its
    frequency-relabelled copy and the gather in between (3·npad² f32), plus
    a block's (B, npad) work arrays (~8 of them).  Reads the memory limit of
    this process's first device (another process's devices report none);
    a device that reports none (the CPU) always fits."""
    import jax

    stats = jax.local_devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    if not limit:
        return True
    need = 4 * (3 * npad * npad + 8 * _WORKSPACE_COLS * npad)
    return need <= int(limit)
