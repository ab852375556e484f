"""Top-N prediction.

Device replacement for src/libslim/predict.c: instead of the per-user
marker/candidate scalar loops, user histories are fed as padded index/value
blocks, model rows are gathered from the dense-ified W and reduced on
device, history items are masked out, and ``lax.top_k`` produces the list.

Scoring parity (predict.c:40-58): score(k) = Σ_{i in history} rating_i ·
W[i,k]; items not reachable through any model row never become candidates,
so a user can receive fewer than N recommendations (nrcmds = min(ncand, N),
predict.c:62).  With nonnegative models and ratings this is equivalent to
"score > 0", which is how the dense path detects candidacy.
"""

from __future__ import annotations

import functools
import os

import jax
import numpy as np

from .types import CSR

NEG_INF = np.float32(-np.inf)


def _bucket(n: int) -> int:
    from .solvers.cd import bucket_npad
    return bucket_npad(n)


def _pow2ceil(n: int) -> int:
    m = 8
    while m < n:
        m *= 2
    return m


def _nnz_bucket(n: int) -> int:
    """1/8-octave size bucket for the big flat uploads (model nnz,
    history nnz); see utils.nnz_bucket."""
    from .utils import nnz_bucket

    return nnz_bucket(n)


def _hist_dense(npad, hist_idx, hist_val):
    """Scatter padded histories into a dense (U, npad) ratings matrix plus
    the history-membership mask (marker = -2, predict.c:33-37).  Duplicate
    history entries accumulate, like the reference's += loop."""
    import jax.numpy as jnp

    U = hist_idx.shape[0]
    safe_idx = jnp.where(hist_idx >= 0, hist_idx, npad - 1)
    urow = jnp.broadcast_to(jnp.arange(U)[:, None], hist_idx.shape)
    hd = jnp.zeros((U, npad), jnp.float32).at[urow, safe_idx].add(
        jnp.where(hist_idx >= 0, hist_val, 0.0))
    mask = jnp.zeros((U, npad), bool).at[urow, safe_idx].max(hist_idx >= 0)
    return hd, mask


@functools.partial(jax.jit, static_argnames=("nrcmds",))
def _score_topn_block(W, hist_idx, hist_val, nrcmds):
    """Score one user block and return its top-N.

    W : (npad, npad) dense model, rows = rated item, cols = candidate.
    hist_idx : (U, H) int32 item ids, -1 padding (mapped to the zero row).
    hist_val : (U, H) f32 ratings (0 padding).

    Scores = hist_dense @ W as one matrix product: no (U, H, npad) gather
    intermediate (one power user's H would otherwise set the block's
    memory for everyone).
    """
    import jax
    import jax.numpy as jnp

    npad = W.shape[0]
    hd, mask = _hist_dense(npad, hist_idx, hist_val)
    scores = jnp.dot(hd, W, preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)
    scores = jnp.where(mask, NEG_INF, scores)
    ncand = jnp.sum(scores > 0, axis=1)
    top_scores, top_ids = jax.lax.top_k(scores, nrcmds)
    counts = jnp.minimum(ncand, nrcmds).astype(jnp.int32)
    # one packed f32 block => a single device->host transfer per call
    return _pack_topn(top_ids, top_scores, counts, nrcmds)


def densify_model(model: CSR, npad: int | None = None):
    """Dense device copy of the model, padded with a zero row/col.

    Above ~4k items the host densify + n²·4-byte upload gives way to
    :func:`densify_model_device`, which uploads the sparse model only."""
    import jax.numpy as jnp

    n = max(model.nrows, model.ncols)
    npad = npad if npad is not None else _bucket(n)
    if npad > 4096:
        return densify_model_device(model, npad)
    W = np.zeros((npad, npad), dtype=np.float32)
    rows = np.repeat(np.arange(model.nrows), model.row_nnz().astype(np.int64))
    # accumulate duplicates (predict.c's += loop; fancy assignment would
    # keep only the last entry and diverge from the device scatter-add)
    np.add.at(W, (rows, model.indices), model.values())
    return jnp.asarray(W)


_densify_fns: dict = {}


def densify_model_device(model: CSR, npad: int):
    """Dense device W built from a slim CSR upload (uint16 indices + f32
    values = ~6 bytes/nnz instead of npad²·4: for a 34M-nnz ML-20M-class
    model ~200MB instead of 3.3GB): row ids are recovered with a device
    searchsorted over the indptr and one scatter populates W."""
    import jax.numpy as jnp

    nnz = max(int(model.nnz), 1)
    # pow2-bucket the nnz axis so models of similar size share one
    # compiled program (a raw-nnz key would recompile for every new
    # model); padded entries carry column id npad and are dropped by the
    # OOB scatter mode
    T = _nnz_bucket(nnz)
    key = (npad, T, model.nrows)
    fn = _densify_fns.get(key)
    if fn is None:
        @jax.jit
        def densify(idx, val, indptr):
            e = jnp.arange(T, dtype=jnp.int32)
            rows = jnp.searchsorted(indptr, e, side="right") \
                .astype(jnp.int32) - 1
            # no unique_indices: a model CSR from a file may carry
            # duplicate (row, col) entries, which must accumulate
            return jnp.zeros((npad, npad), jnp.float32).at[
                rows, idx.astype(jnp.int32)].add(val, mode="drop")

        fn = _densify_fns[key] = densify
    dt = np.uint16 if npad < 65536 else np.int32
    idx = np.full(T, npad, dtype=dt)
    idx[:nnz] = model.indices[:nnz] if model.nnz else 0
    val = np.zeros(T, np.float32)
    val[:model.nnz] = model.values()
    return fn(jnp.asarray(idx), jnp.asarray(val),
              jnp.asarray(model.indptr.astype(np.int32)))


class DeviceModelPack:
    """Model retained on device as the solver's flat harvest packs
    (keep_device_model): flat coordinate ids (RANK space -- the solver's
    frequency permutation) + values in target-rank-major run order,
    ~6 bytes/nnz of device memory instead of a dense (npad, npad) W held
    next to the resident Gram during the learn.

    ``densify()`` rebuilds the dense item-space W entirely on device
    (scatter through the rank->item permutation), i.e. exactly
    :func:`densify_model_device` minus its model upload.  Lazy by design:
    the (npad, npad) buffer only exists while predict needs it, not
    during the learn.
    Rank-padding coordinates (>= n, filtered from the host CSR by
    assembly) are dropped so the result equals densify_model(model CSR)
    bit-for-bit."""

    def __init__(self, vals, idx, run_starts, run_lens, p_pad,
                 posmap_pad, n, npad):
        self.vals, self.idx = vals, idx          # (Tb,) device, flat
        self.run_starts = run_starts             # (npad,) host int32
        self.run_lens = run_lens                 # (npad,) host int32 exact
        self.p_pad = p_pad                       # (npad,) host rank->item
        self.posmap_pad = posmap_pad             # (npad,) host item->rank
        self.n, self.npad = n, npad
        self._W = None

    def densify(self):
        if self._W is None:
            self._W = self._densify_scatter()
        return self._W

    def _densify_scatter(self):
        """XLA scatter (run-start table -> searchsorted row recovery)."""
        import jax.numpy as jnp

        npad, n, Tb = self.npad, self.n, int(self.vals.shape[0])
        key = (npad, Tb)
        fn = _densify_fns.get(key)
        if fn is None:
            @jax.jit
            def densify(val, idx, rs, p_pad):
                e = jnp.arange(Tb, dtype=jnp.int32)
                rank = jnp.searchsorted(rs, e, side="right") \
                    .astype(jnp.int32) - 1
                tgt = jnp.take(p_pad, jnp.clip(rank, 0, npad - 1)) \
                    .astype(jnp.int32)
                # coord ranks map to item rows through the permutation;
                # rank-padding coordinates (>= n, filtered from the host
                # CSR by assembly) are dropped, not just parked: the
                # result must equal the host-CSR densify exactly
                row = jnp.take(p_pad,
                               jnp.clip(idx.astype(jnp.int32), 0,
                                        npad - 1)).astype(jnp.int32)
                row = jnp.where(idx.astype(jnp.int32) < n, row, npad)
                return jnp.zeros((npad, npad), jnp.float32).at[
                    row, tgt].add(val, mode="drop")

            fn = _densify_fns[key] = densify
        return fn(self.vals, self.idx, jnp.asarray(self.run_starts),
                  jnp.asarray(self.p_pad))

    def free(self):
        self.vals = self.idx = self._W = None


# dense serving's catalogue limit on a backend that reports no memory
# limit (the CPU backend): a 5.4 GB dense W
HOST_DENSE_PREDICT_NPAD = 36864


def dense_predict_max_npad() -> int:
    """Largest padded catalogue served from a dense (npad, npad) f32 W:
    W plus one scan block's scores (1 GiB) must fit the memory limit
    (``bytes_limit``) of this process's first device.  A function of the
    device alone, so the serving path depends on the shape only.  Above
    it predict takes the padded-sparse scoring path."""
    stats = jax.local_devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    if not limit:
        return HOST_DENSE_PREDICT_NPAD
    return int((max(int(limit) - (1 << 30), 0) // 4) ** 0.5)


# small-catalogue serving: at ml100k scale (npad 2048) the reference's
# per-user sparse loop (predict.c:40-66, reimplemented in
# native/slimrt.cpp:slim_predict_topn) is expected to beat the device
# path -- the whole job is smaller than the dispatch overhead.  Up to this
# npad,
# predict_topn auto-routes to the native host kernel when the caller did
# not pin a path (no W_dev / sparse / scan / precision argument).
# Override with SLIM_PREDICT_NATIVE_NPAD (0 disables the fallback).
NATIVE_PREDICT_NPAD = 4096

# Above NATIVE_PREDICT_NPAD the winner is decided by per-user WORK, not
# catalogue size: the native loop costs O(h*r) per user (h = history nnz,
# r = model row nnz) while every device path writes/score-reduces O(npad)
# per user.  The router sends a job native when h*r < alpha*npad; the
# value of alpha has yet to be fitted on the GPU.  Override with
# SLIM_PREDICT_NATIVE_ALPHA (0 restores the pure-npad rule).
NATIVE_PREDICT_ALPHA = 0.75


def native_predict_applicable(n: int, model: CSR | None = None,
                              hist: CSR | None = None) -> bool:
    """True when :func:`predict_topn` would route an unpinned call for an
    ``n``-item catalogue to the native host kernel.

    With ``model``/``hist`` supplied, catalogues above the small-npad
    threshold are still routed native when the estimated per-user work
    ``mean(history nnz) * mean(model row nnz)`` is below
    ``NATIVE_PREDICT_ALPHA * npad`` -- the crossover where the
    reference-style scalar loop (predict.c:40-66) outruns the device's
    O(npad)-per-user scoring."""
    from . import native

    thr = int(os.environ.get("SLIM_PREDICT_NATIVE_NPAD",
                             NATIVE_PREDICT_NPAD))
    if thr <= 0 or not native.available():
        return False
    npad = _bucket(n)
    if npad <= thr:
        return True
    if model is None or hist is None:
        return False
    alpha = float(os.environ.get("SLIM_PREDICT_NATIVE_ALPHA",
                                 NATIVE_PREDICT_ALPHA))
    hbar = hist.nnz / max(hist.nrows, 1)
    rbar = model.nnz / max(model.nrows, 1)
    return alpha > 0 and hbar * rbar < alpha * npad

# scoring-matmul precision: HIGHEST (full f32) for small catalogues where
# compute is negligible; DEFAULT above this npad, where the scores only
# feed a rank-10 cutoff.  For f32 operands DEFAULT is TF32 on the GPU
# (operands rounded to a 10-bit mantissa, f32 accumulation: each product
# within ~2^-10 relative, so each score of nonnegative terms within
# SCORE_RTOL_DEFAULT) and full f32 on the CPU.  Overridable via
# predict_topn(precision=...).
_BF16_SCORE_NPAD = 8192
SCORE_RTOL_DEFAULT = 2.0 ** -9


def _score_precision(npad, precision):
    import jax

    if precision is not None:
        return precision
    return (jax.lax.Precision.HIGHEST if npad <= _BF16_SCORE_NPAD
            else jax.lax.Precision.DEFAULT)


_predict_scan_fns: dict = {}


def _get_predict_scan(npad, ub, nblocks, P, nrcmds, nnz, n, prec):
    """One-dispatch dense predict: a jitted scan over user blocks.

    The whole history matrix ships ONCE as flat CSR (indices + optional
    values + indptr, ~6 bytes/nnz); each scan step rebuilds one user
    block's dense history rows on device (gather + searchsorted row
    recovery, same trick as ops/gram._get_gram_csr), scores them against
    the resident dense W as one matrix product, and emits the packed
    top-N.  One
    device->host fetch returns every user's result, so the host round
    trips do not scale with the user count (predict.c:40-66 does one
    scalar pass per user instead)."""
    key = (npad, ub, nblocks, P, nrcmds, nnz, n, str(prec))
    fn = _predict_scan_fns.get(key)
    if fn is None:
        import jax
        import jax.numpy as jnp

        @jax.jit
        def run(W, idx, val, indptr, starts):
            has_val = val.shape[0] == idx.shape[0]

            def body(_, k):
                s = starts[k]
                e = s + jnp.arange(P, dtype=jnp.int32)
                valid = e < starts[k + 1]
                esafe = jnp.minimum(e, nnz - 1)
                c = jnp.take(idx, esafe).astype(jnp.int32)
                u = jnp.searchsorted(indptr, esafe, side="right") \
                    .astype(jnp.int32) - 1
                l = jnp.where(valid, u - k * ub, ub)     # OOB pad -> drop
                cin = valid & (c < n)                    # predict.c:35 guard
                l = jnp.where(cin, l, ub)
                v = jnp.where(cin, jnp.take(val, esafe), 0.0) if has_val \
                    else cin.astype(jnp.float32)
                # NO unique_indices: duplicate history entries must
                # accumulate (predict.c's += loop; _hist_dense does the
                # same on the per-block path)
                hd = jnp.zeros((ub, npad), jnp.float32).at[l, c].add(
                    v, mode="drop")
                mask = jnp.zeros((ub, npad), bool).at[l, c].max(
                    cin, mode="drop")
                scores = jnp.dot(hd, W, preferred_element_type=jnp.float32,
                                 precision=prec)
                scores = jnp.where(mask, NEG_INF, scores)
                ncand = jnp.sum(scores > 0, axis=1)
                top_sc, top_id = jax.lax.top_k(scores, nrcmds)
                counts = jnp.minimum(ncand, nrcmds).astype(jnp.int32)
                return None, _pack_topn(top_id, top_sc, counts, nrcmds)

            _, outs = jax.lax.scan(body, None,
                                   jnp.arange(nblocks, dtype=jnp.int32))
            return outs.reshape(nblocks * ub, 2 * nrcmds + 1)

        fn = _predict_scan_fns[key] = run
    return fn


def _predict_topn_scan(hist, nrcmds, user_block, W, n, npad, prec):
    """Dense-W predict over all users in one device dispatch (see
    :func:`_get_predict_scan`).  The scan block is sized by bytes: only
    one score block is live inside the scan, and larger blocks amortize
    the per-block read of W (3.3 GB at ML-20M)."""
    import jax.numpy as jnp

    user_block = max(user_block, min(user_block * 4, max(8, _pow2ceil(int(
        int(os.environ.get("SLIM_PREDICT_SCAN_BYTES", 1 << 30))
        / (npad * 4) + 1)) // 2)))
    nusers = hist.nrows
    nblocks = max((nusers + user_block - 1) // user_block, 1)
    starts = hist.indptr[np.minimum(
        np.arange(nblocks + 1, dtype=np.int64) * user_block,
        nusers)].astype(np.int32)
    P = _pow2ceil(max(int(np.diff(starts).max()) if nblocks else 1, 1))
    # pow2-bucket the flat-CSR length so same-dataset-class jobs share
    # one compiled program regardless of the exact nnz (pad indices carry
    # item id n -> masked by the c < n guard in the kernel)
    T = _nnz_bucket(max(int(hist.nnz), 1))
    idx = np.full(T, n, np.int32)
    if hist.nnz:
        idx[:hist.nnz] = hist.indices
    if hist.data is None:
        val = np.zeros(0, np.float32)
    else:
        val = np.zeros(T, np.float32)
        val[:hist.nnz] = hist.values()
    fn = _get_predict_scan(npad, user_block, nblocks, P, nrcmds, T, n,
                           prec)
    packed = fn(W, jnp.asarray(idx), jnp.asarray(val),
                jnp.asarray(hist.indptr.astype(np.int32)),
                jnp.asarray(starts))
    from .utils import submit_fetch

    all_host = submit_fetch(packed).result()[0][:nusers]
    return _unpack_topn(all_host, nrcmds)


def _topk_chunk_env():
    """SLIM_TOPK_CHUNK, read at call (not trace) time so it can key the
    compiled-function caches -- an in-process A/B flip must not silently
    reuse the previous setting's kernel.

    Default 0 (single-pass ``lax.top_k``): the round-3 hardware A/B at
    262,144-wide rows measured the single pass 5.8x FASTER than the
    32,768-chunk two-stage form (18.3k vs 3.1k users/s) -- XLA's top-k
    lowering does not full-sort the row, while the chunked form's
    (U, C, chunk) reshape relayouts the score block.  The two-stage path
    stays available for A/B and for backends where wide sorts do
    degrade."""
    return int(os.environ.get("SLIM_TOPK_CHUNK", "0"))


def _topk_wide(scores, k, chunk=None):
    """Exact top-k over very wide score rows via two stages: per-chunk
    top-k then top-k over the C·k chunk winners (any global top-k element
    is inside its chunk's top-k, so the composition is exact; tie order
    may differ from a single pass, matching the reference's unstable
    sorts).  A (U, 2M) single-pass top-k makes XLA sort the whole row;
    the chunked form keeps each sort window small.  SLIM_TOPK_CHUNK
    overrides the chunk width (0 disables the two-stage form)."""
    import jax
    import jax.numpy as jnp

    U, npad = scores.shape
    if chunk is None:
        chunk = _topk_chunk_env()
    if chunk > 0 and npad % chunk:
        # bucketed npads are 4096-multiples, not always pow2: use the
        # largest 4096-multiple divisor of npad at most the requested
        # chunk so the two-stage form engages at every bucket
        base = 4096 if npad % 4096 == 0 else 0
        if base:
            d = max((m for m in range(base, chunk + 1, base)
                     if npad % m == 0), default=0)
            chunk = d
        else:
            chunk = 0
    if chunk <= 0 or npad < 2 * chunk or k > chunk:
        return jax.lax.top_k(scores, k)
    C = npad // chunk
    loc_sc, loc_id = jax.lax.top_k(scores.reshape(U, C, chunk), k)
    base = (jnp.arange(C, dtype=jnp.int32) * chunk)[None, :, None]
    flat_sc = loc_sc.reshape(U, C * k)
    flat_id = (loc_id.astype(jnp.int32) + base).reshape(U, C * k)
    top_sc, pos = jax.lax.top_k(flat_sc, k)
    return top_sc, jnp.take_along_axis(flat_id, pos, axis=1)


_predict_scan_sparse_fns: dict = {}


def _get_predict_scan_sparse(npad, ub, nblocks, P, R, nrcmds, nnz, n,
                             topk_chunk=0):
    """One-dispatch sparse predict: a jitted scan over user blocks against
    the resident padded-row model (:func:`sparsify_model_device`).

    Same flat-CSR history shipping and single result fetch as
    :func:`_get_predict_scan`, but scores come from a model-row gather +
    scatter-add instead of a matrix product against dense W, so device
    memory holds nnz·8 model bytes instead of npad²·4 -- the only way a
    2M-item
    catalogue is servable at all (dense W would be 16TB)."""
    key = (npad, ub, nblocks, P, R, nrcmds, nnz, n, topk_chunk)
    fn = _predict_scan_sparse_fns.get(key)
    if fn is None:
        import jax
        import jax.numpy as jnp

        @jax.jit
        def run(Widx, Wval, idx, val, indptr, starts):
            has_val = val.shape[0] == idx.shape[0]

            def body(_, k):
                s = starts[k]
                e = s + jnp.arange(P, dtype=jnp.int32)
                valid = e < starts[k + 1]
                esafe = jnp.minimum(e, nnz - 1)
                c = jnp.take(idx, esafe).astype(jnp.int32)
                u = jnp.searchsorted(indptr, esafe, side="right") \
                    .astype(jnp.int32) - 1
                l = jnp.where(valid, u - k * ub, ub)     # OOB pad -> drop
                cin = valid & (c < n)                    # predict.c:35 guard
                l = jnp.where(cin, l, ub)
                v = jnp.where(cin, jnp.take(val, esafe), 0.0) if has_val \
                    else cin.astype(jnp.float32)
                csafe = jnp.minimum(c, npad - 1)
                wrow_i = jnp.take(Widx, csafe, axis=0)          # (P, R)
                wrow_v = jnp.take(Wval, csafe, axis=0) * v[:, None]
                lw = jnp.broadcast_to(l[:, None], (P, R))
                scores = jnp.zeros((ub, npad), jnp.float32).at[
                    lw.reshape(-1), wrow_i.reshape(-1)].add(
                    wrow_v.reshape(-1), mode="drop")
                mask = jnp.zeros((ub, npad), bool).at[l, csafe].max(
                    cin, mode="drop")
                scores = jnp.where(mask, NEG_INF, scores)
                ncand = jnp.sum(scores > 0, axis=1)
                top_sc, top_id = _topk_wide(scores, nrcmds, topk_chunk)
                counts = jnp.minimum(ncand, nrcmds).astype(jnp.int32)
                return None, _pack_topn(top_id, top_sc, counts, nrcmds)

            _, outs = jax.lax.scan(body, None,
                                   jnp.arange(nblocks, dtype=jnp.int32))
            return outs.reshape(nblocks * ub, 2 * nrcmds + 1)

        fn = _predict_scan_sparse_fns[key] = run
    return fn


def _pack_topn(top_id, top_sc, counts, nrcmds):
    """Pack [ids, scores, counts] into one f32 block (a single
    device->host transfer).  Ids are BITCAST into the f32 lanes (not
    value-cast), so they stay exact beyond 2^24 -- a 2M+-item catalogue
    must not round its item ids; unpack with :func:`_unpack_topn`.

    The bit pattern is biased to ``(id + 1) | 0x40000000`` first: a raw
    id's pattern is a DENORMAL f32 (and -1 is a NaN), and fusions the
    packed block flows through (the lax.scan output stacking in
    particular) may flush denormals to zero.  The bias keeps every lane a
    normal f32 in [2, 4); ids stay exact up to 2^30."""
    import jax
    import jax.numpy as jnp

    ok = jnp.arange(nrcmds)[None, :] < counts[:, None]
    ids_i = jnp.where(ok, top_id.astype(jnp.int32), -1)
    enc = jnp.bitwise_or(ids_i + 1, jnp.int32(0x40000000))
    return jnp.concatenate(
        [jax.lax.bitcast_convert_type(enc, jnp.float32),
         jnp.where(ok, top_sc, 0.0),
         counts.astype(jnp.float32)[:, None]], axis=1)


def _unpack_topn(all_host, nrcmds):
    """Host-side inverse of :func:`_pack_topn`."""
    enc = np.ascontiguousarray(all_host[:, :nrcmds]).view(np.int32)
    ids = (enc & np.int32(0x3FFFFFFF)) - 1
    scores = all_host[:, nrcmds:2 * nrcmds].astype(np.float32)
    counts = all_host[:, 2 * nrcmds].astype(np.int32)
    return ids, scores, counts


def _coo_sorted_runs(keys, vals):
    """Sort COO (key, val) pairs and segment-sum duplicate keys.

    Returns (keys_sorted, is_end, rsum) where is_end marks each run's
    last element and rsum[i] is the TOTAL of element i's run (exact f32
    scatter-add, the same accumulation as the dense paths)."""
    import jax
    import jax.numpy as jnp

    keys, vals = jax.lax.sort((keys, vals), num_keys=1)
    N = keys.shape[0]
    newrun = keys[1:] != keys[:-1]
    start = jnp.concatenate([jnp.ones((1,), bool), newrun])
    is_end = jnp.concatenate([newrun, jnp.ones((1,), bool)])
    run_id = jnp.cumsum(start.astype(jnp.int32)) - 1
    rs = jnp.zeros((N,), jnp.float32).at[run_id].add(vals)
    return keys, is_end, jnp.take(rs, run_id)


def _coo_topn_from_pairs(keys, vals, U, npad, nrcmds):
    """Packed top-N from COO (user*npad + candidate, weight) pairs.

    One sort groups duplicates, a segment scatter-add produces the
    per-(user, candidate) sums, and a second sort by (user, -sum) orders
    every user's candidates so the static top-k is a contiguous gather.
    Keys >= U*npad are padding; history exclusion arrives as -1e30 pairs
    (the run sum goes negative and negative scores are never counted,
    predict.c:33-37's marker)."""
    import jax
    import jax.numpy as jnp

    SENT = U * npad
    keys, is_end, rsum = _coo_sorted_runs(keys, vals)
    N = keys.shape[0]
    end_real = is_end & (keys < SENT)

    u_run = jnp.where(end_real, keys // npad, U)
    negs = jnp.where(end_real, -rsum, jnp.inf)
    cand = jnp.where(end_real, keys % npad, npad - 1)
    u_s, ns_s, cd_s = jax.lax.sort((u_run, negs, cand), num_keys=2)

    pos = jnp.searchsorted(u_s, jnp.arange(U + 1, dtype=jnp.int32)) \
        .astype(jnp.int32)
    take = pos[:-1, None] + jnp.arange(nrcmds, dtype=jnp.int32)[None, :]
    inuser = take < pos[1:, None]
    takes = jnp.minimum(take, N - 1)
    top_sc = jnp.where(inuser, -jnp.take(ns_s, takes), 0.0)
    top_id = jnp.where(inuser, jnp.take(cd_s, takes), -1)

    nc = jnp.zeros((U + 1,), jnp.int32).at[u_run].add(
        (end_real & (rsum > 0)).astype(jnp.int32))
    counts = jnp.minimum(nc[:U], nrcmds)
    return _pack_topn(top_id, top_sc, counts, nrcmds)


_predict_scan_coo_fns: dict = {}

# above this catalogue size the per-user dense score rows of the sparse
# scan cost O(npad) writes + top-k per user; the COO path below costs
# O(history·R·log) per user independent of npad.  Overridable; 0 = off.
COO_PREDICT_NPAD = 1 << 19


def _get_predict_scan_coo(npad, ub, nblocks, P, R, nrcmds, nnz, n):
    """One-dispatch sparse predict that never materializes an npad-wide
    score row: each block's (history entry, model row) pairs become a
    flat COO list keyed by user·npad + candidate, one sort groups the
    duplicates, a segment scatter-add produces the per-(user, candidate)
    sums (exact f32, same accumulation as the dense path), and a second
    sort by (user, -sum) yields every user's candidates in score order,
    from which the static top-k is a contiguous gather.  History
    exclusion rides the same machinery as a -1e30 pair (the run sum goes
    negative, and negative scores are never counted or kept --
    predict.c:33-37's marker).  Work per block is O(P·R·log) independent
    of the catalogue size -- the regime where 2M-item serving is
    competitive."""
    key = (npad, ub, nblocks, P, R, nrcmds, nnz, n)
    fn = _predict_scan_coo_fns.get(key)
    if fn is None:
        import jax
        import jax.numpy as jnp

        SENT = ub * npad                  # caller guarantees < 2^31
        assert SENT < 2 ** 31

        @jax.jit
        def run(Widx, Wval, idx, val, indptr, starts):
            has_val = val.shape[0] == idx.shape[0]

            def body(_, k):
                s = starts[k]
                e = s + jnp.arange(P, dtype=jnp.int32)
                valid = e < starts[k + 1]
                esafe = jnp.minimum(e, nnz - 1)
                c = jnp.take(idx, esafe).astype(jnp.int32)
                u = jnp.searchsorted(indptr, esafe, side="right") \
                    .astype(jnp.int32) - 1
                l = u - k * ub
                cin = valid & (c < n)                # predict.c:35 guard
                v = jnp.where(cin, jnp.take(val, esafe), 0.0) if has_val \
                    else cin.astype(jnp.float32)
                csafe = jnp.minimum(c, npad - 1)
                wri = jnp.take(Widx, csafe, axis=0)           # (P, R)
                wrv = jnp.take(Wval, csafe, axis=0) * v[:, None]
                key_m = jnp.where(cin[:, None],
                                  l[:, None] * npad + wri, SENT)
                val_m = jnp.where(cin[:, None], wrv, 0.0)
                key_h = jnp.where(cin, l * npad + csafe, SENT)
                val_h = jnp.where(cin, jnp.float32(-1e30), 0.0)

                keys = jnp.concatenate([key_m.reshape(-1), key_h])
                vals = jnp.concatenate([val_m.reshape(-1), val_h])
                return None, _coo_topn_from_pairs(keys, vals, ub, npad,
                                                  nrcmds)

            _, outs = jax.lax.scan(body, None,
                                   jnp.arange(nblocks, dtype=jnp.int32))
            return outs.reshape(nblocks * ub, 2 * nrcmds + 1)

        fn = _predict_scan_coo_fns[key] = run
    return fn


def _predict_topn_scan_sparse(hist, nrcmds, user_block, Wsp, n, npad):
    """Sparse-model predict over all users in one device dispatch.

    Catalogues at/above SLIM_PREDICT_COO_NPAD (default 2^19) route to the
    COO segment-top-k kernel, whose per-user cost is independent of the
    catalogue size; smaller ones use the dense-score-row scan."""
    import jax.numpy as jnp

    Widx, Wval = Wsp
    R = int(Widx.shape[1])
    coo_npad = int(os.environ.get("SLIM_PREDICT_COO_NPAD",
                                  COO_PREDICT_NPAD))
    use_coo = coo_npad > 0 and npad >= coo_npad
    if use_coo:
        # the COO sort key is user_local * npad + candidate in int32
        user_block = _coo_user_block(user_block, npad)
    nusers = hist.nrows
    nblocks = max((nusers + user_block - 1) // user_block, 1)
    starts = hist.indptr[np.minimum(
        np.arange(nblocks + 1, dtype=np.int64) * user_block,
        nusers)].astype(np.int32)
    P = _pow2ceil(max(int(np.diff(starts).max()) if nblocks else 1, 1))
    T = _nnz_bucket(max(int(hist.nnz), 1))
    idx = np.full(T, n, np.int32)
    if hist.nnz:
        idx[:hist.nnz] = hist.indices
    if hist.data is None:
        val = np.zeros(0, np.float32)
    else:
        val = np.zeros(T, np.float32)
        val[:hist.nnz] = hist.values()
    if use_coo:
        fn = _get_predict_scan_coo(npad, user_block, nblocks, P, R, nrcmds,
                                   T, n)
    else:
        fn = _get_predict_scan_sparse(npad, user_block, nblocks, P, R,
                                      nrcmds, T, n,
                                      topk_chunk=_topk_chunk_env())
    packed = fn(Widx, Wval, jnp.asarray(idx), jnp.asarray(val),
                jnp.asarray(hist.indptr.astype(np.int32)),
                jnp.asarray(starts))
    from .utils import submit_fetch

    all_host = submit_fetch(packed).result()[0][:nusers]
    return _unpack_topn(all_host, nrcmds)


_sparsify_fns: dict = {}


def sparsify_model_device(model: CSR, npad: int | None = None):
    """Padded-row device copy of the model for the large-N predict path.

    Returns (Widx (npad, R) int32, Wval (npad, R) f32): row i holds the
    candidate ids / weights of model row i, padded with (npad-1, 0.0).
    Memory is npad·R·8 bytes instead of npad²·4 -- a 2M-item model with
    ~100 nnz/row fits in ~1.6GB of device memory where the dense copy
    needs 16TB.

    Built on device from a slim CSR upload (~6-8 bytes/nnz instead of
    the npad·R·8 host-built arrays): row ids
    recovered by a searchsorted over the indptr, in-row position by
    subtracting the row start, then one scatter per output array.

    ``SLIM_PREDICT_WVAL_BF16=1`` stores Wval as bfloat16 (model memory
    npad·R·6 instead of ·8 and half the value-gather bandwidth at 2M-item
    scale); scores still multiply/accumulate in f32, so only the model
    weights round (~2^-8 relative) -- the same trade the dense path makes
    above ``_BF16_SCORE_NPAD``.
    """
    import jax
    import jax.numpy as jnp

    n = max(model.nrows, model.ncols)
    npad = npad if npad is not None else _bucket(n)
    nnz_row = model.row_nnz().astype(np.int64)
    R = _pow2ceil(max(int(nnz_row.max()) if model.nrows else 1, 1))
    T = _nnz_bucket(max(int(model.nnz), 1))
    nrows = model.nrows
    bf16 = os.environ.get("SLIM_PREDICT_WVAL_BF16") == "1"
    key = (npad, R, T, nrows, bf16)
    fn = _sparsify_fns.get(key)
    if fn is None:
        @jax.jit
        def build(idx, val, indptr):
            e = jnp.arange(T, dtype=jnp.int32)
            rows = jnp.searchsorted(indptr, e, side="right") \
                .astype(jnp.int32) - 1
            live = e < indptr[nrows]
            rows_s = jnp.where(live, rows, npad)     # pads -> OOB, dropped
            pos = e - jnp.take(indptr, jnp.clip(rows, 0, nrows))
            Wi = jnp.full((npad, R), npad - 1, jnp.int32).at[
                rows_s, pos].set(idx.astype(jnp.int32), mode="drop",
                                 unique_indices=True)
            vdt = jnp.bfloat16 if bf16 else jnp.float32
            Wv = jnp.zeros((npad, R), vdt).at[
                rows_s, pos].set(val.astype(vdt), mode="drop",
                                 unique_indices=True)
            return Wi, Wv

        fn = _sparsify_fns[key] = build
    dt = np.uint16 if npad <= 65536 else np.int32
    idx = np.full(T, npad - 1, dtype=dt)
    idx[:model.nnz] = model.indices
    val = np.zeros(T, np.float32)
    val[:model.nnz] = model.values()
    return fn(jnp.asarray(idx), jnp.asarray(val),
              jnp.asarray(model.indptr.astype(np.int32)))


@functools.partial(jax.jit, static_argnames=("nrcmds", "topk_chunk"))
def _score_topn_block_sparse(Widx, Wval, hist_idx, hist_val, nrcmds,
                             topk_chunk=0):
    """Sparse-model variant of :func:`_score_topn_block`: gather the padded
    model rows of each history item and scatter-add into per-user dense
    score vectors ((U, npad) -- the only dense object, so memory scales
    with the user block, not n²).  Scoring parity with predict.c:40-58.
    """
    import jax
    import jax.numpy as jnp

    npad = Widx.shape[0]
    U, H = hist_idx.shape
    safe_idx = jnp.where(hist_idx >= 0, hist_idx, npad - 1)
    cand = Widx[safe_idx]                            # (U, H, R) gather
    w = Wval[safe_idx] * hist_val[:, :, None]        # (U, H, R)
    urow = jnp.broadcast_to(jnp.arange(U)[:, None, None], cand.shape)
    scores = jnp.zeros((U, npad), jnp.float32).at[
        urow.reshape(-1), cand.reshape(-1)].add(w.reshape(-1))
    mask = jnp.zeros((U, npad), bool).at[
        jnp.arange(U)[:, None], safe_idx].max(hist_idx >= 0)
    scores = jnp.where(mask, NEG_INF, scores)
    ncand = jnp.sum(scores > 0, axis=1)
    top_scores, top_ids = _topk_wide(scores, nrcmds, topk_chunk)
    counts = jnp.minimum(ncand, nrcmds).astype(jnp.int32)
    return _pack_topn(top_ids, top_scores, counts, nrcmds)


def predict_topn(model: CSR, hist: CSR, nrcmds: int = 10,
                 user_block: int = 1024, W_dev=None, sparse: bool | None = None,
                 precision=None, scan: bool | None = None):
    """Batch top-N for every user row of ``hist``.

    Returns (ids (nusers, nrcmds) int32 with -1 padding,
             scores (nusers, nrcmds) f32,
             counts (nusers,) int32).
    Mirrors Py_SLIM_Predict (pyapi.c:530-563) which loops SLIM_GetTopN over
    all rows.  Large dense-W jobs take the one-dispatch scan path
    (:func:`_get_predict_scan`); ``scan`` forces it on/off.
    """
    import jax.numpy as jnp

    n = max(model.nrows, model.ncols, hist.ncols)
    npad = _bucket(n)
    if isinstance(W_dev, DeviceModelPack):
        # solver-retained model: rebuild the dense W on device (no model
        # upload); a shape mismatch falls back to the upload path
        W_dev = W_dev.densify() if W_dev.npad == npad else None
    # small-catalogue regime: route unpinned calls to the native host
    # kernel (see NATIVE_PREDICT_NPAD).  Any explicit path choice -- a
    # resident device model, sparse=, scan=, or precision= -- keeps the
    # call on device (bench/tests pin their paths this way).
    if (W_dev is None and sparse is None and scan is None
            and precision is None and native_predict_applicable(n, model,
                                                                hist)):
        from . import native

        return native.predict_topn(model, hist, nrcmds=nrcmds)
    if sparse is None:
        sparse = (isinstance(W_dev, tuple)
                  or (W_dev is None and npad > dense_predict_max_npad()))
    if not sparse and (scan or (scan is None
                                and hist.nrows > 4 * user_block)):
        W = W_dev if W_dev is not None else densify_model(model, npad)
        return _predict_topn_scan(hist, nrcmds, user_block, W, n,
                                  npad, _score_precision(npad, precision))
    if sparse:
        # a resident padded-row model may be passed through W_dev as the
        # (Widx, Wval) tuple (the serving pattern: sparsify once)
        Wsp = W_dev if isinstance(W_dev, tuple) \
            else sparsify_model_device(model, npad)
        if scan or (scan is None and hist.nrows > 4 * user_block):
            # inside the scan only ONE score block is live (XLA reuses
            # the buffer across steps), so the per-block byte budget can
            # be much larger than the async per-block path below, where
            # dispatched blocks pile up in flight; bigger blocks = fewer
            # top-k passes per served user
            ub_scan = min(user_block * 8, max(8, _pow2ceil(int(
                int(os.environ.get("SLIM_PREDICT_SCAN_BYTES", 1 << 30))
                / (npad * 4) + 1)) // 2))
            return _predict_topn_scan_sparse(hist, nrcmds, ub_scan, Wsp,
                                             n, npad)
        coo = int(os.environ.get("SLIM_PREDICT_COO_NPAD",
                                 COO_PREDICT_NPAD))
        block_coo = coo > 0 and npad >= coo
        if block_coo:
            # COO block: no npad-wide rows, only the int32 key bound
            user_block = _coo_user_block(user_block, npad)
        else:
            # per-user dense score rows are the only O(n) object: size
            # the user block so a block's scores stay within ~256MB
            user_block = min(
                user_block,
                max(8, _pow2ceil(int(256e6 / (npad * 4) + 1)) // 2))
    else:
        block_coo = False
        W = W_dev if W_dev is not None else densify_model(model, npad)

    nusers = hist.nrows
    # power-of-two history width => stable compiled shapes across datasets
    H = _pow2ceil(max(int(hist.row_nnz().max()) if nusers else 1, 1))
    ids = np.full((nusers, nrcmds), -1, dtype=np.int32)
    scores = np.zeros((nusers, nrcmds), dtype=np.float32)
    counts = np.zeros(nusers, dtype=np.int32)

    hidx, hval = hist.padded_rows(width=H)
    # clamp out-of-range history ids (predict.c:35 guards id < ncols)
    hidx = np.where(hidx >= n, -1, hidx)
    if hist.data is None:
        hval = (hidx >= 0).astype(np.float32)

    # dispatch all user blocks, then one concatenated device->host fetch
    ub = min(user_block, _pow2ceil(max(nusers, 1)))
    packed = []
    for u0 in range(0, nusers, ub):
        u1 = min(u0 + ub, nusers)
        bi = np.full((ub, H), -1, dtype=np.int32)
        bv = np.zeros((ub, H), dtype=np.float32)
        bi[:u1 - u0] = hidx[u0:u1]
        bv[:u1 - u0] = hval[u0:u1]
        if block_coo:
            fn = _coo_topn_hist_jit(npad, n, nrcmds, ub, H,
                                    int(Wsp[0].shape[1]))
            packed.append(fn(Wsp[0], Wsp[1], jnp.asarray(bi),
                             jnp.asarray(bv)))
        elif sparse:
            packed.append(_score_topn_block_sparse(
                Wsp[0], Wsp[1], jnp.asarray(bi), jnp.asarray(bv), nrcmds,
                topk_chunk=_topk_chunk_env()))
        else:
            packed.append(_score_topn_block(W, jnp.asarray(bi),
                                            jnp.asarray(bv), nrcmds))
    if packed:
        import jax.numpy as _jnp

        all_host = np.asarray(_jnp.concatenate(packed, axis=0))
        for k, u0 in enumerate(range(0, nusers, ub)):
            u1 = min(u0 + ub, nusers)
            blk = all_host[k * ub:k * ub + (u1 - u0)]
            ids[u0:u1], scores[u0:u1], counts[u0:u1] = \
                _unpack_topn(blk, nrcmds)
    return ids, scores, counts


def _coo_topn_from_hist(Widx, Wval, bi, bv, nrcmds, npad, n):
    """COO segment-top-k top-N for one padded history block (U, H) --
    the same math as _get_predict_scan_coo's body, from padded rows
    instead of a flat-CSR slice.  Jittable and shard_map-compatible
    (purely local ops); returns the packed (U, 2k+1) block."""
    import jax
    import jax.numpy as jnp

    U, H = bi.shape
    R = Widx.shape[1]
    SENT = U * npad
    if SENT >= 2 ** 31:            # int32 sort key bound (see _coo_user_block)
        raise ValueError(f"U*npad = {SENT} overflows the int32 COO key")

    hin = (bi >= 0) & (bi < n)
    safe = jnp.where(hin, bi, npad - 1)
    wri = jnp.take(Widx, safe.reshape(-1), axis=0).reshape(U, H, R)
    wrv = jnp.take(Wval, safe.reshape(-1), axis=0).reshape(U, H, R) \
        * bv[..., None]
    l3 = jnp.broadcast_to(
        jnp.arange(U, dtype=jnp.int32)[:, None, None], (U, H, R))
    key_m = jnp.where(hin[..., None], l3 * npad + wri, SENT)
    val_m = jnp.where(hin[..., None], wrv, 0.0)
    l2 = jnp.broadcast_to(jnp.arange(U, dtype=jnp.int32)[:, None], (U, H))
    key_h = jnp.where(hin, l2 * npad + safe, SENT)
    val_h = jnp.where(hin, jnp.float32(-1e30), 0.0)
    keys = jnp.concatenate([key_m.reshape(-1), key_h.reshape(-1)])
    vals = jnp.concatenate([val_m.reshape(-1), val_h.reshape(-1)])
    return _coo_topn_from_pairs(keys, vals, U, npad, nrcmds)


_coo_hist_fns: dict = {}


def _coo_topn_hist_jit(npad, n, nrcmds, U, H, R):
    """Jitted, shape-keyed wrapper of :func:`_coo_topn_from_hist` for the
    per-block (non-scan) path."""
    key = (npad, n, nrcmds, U, H, R)
    fn = _coo_hist_fns.get(key)
    if fn is None:
        import jax

        @jax.jit
        def run(Wi, Wv, bi, bv):
            return _coo_topn_from_hist(Wi, Wv, bi, bv, nrcmds, npad, n)

        fn = _coo_hist_fns[key] = run
    return fn


_coo_cand_fns: dict = {}


def _get_coo_cand_scores(npad, U, H, R, C, n, exclude_history):
    """Per-block candidate scores from the padded-row model WITHOUT an
    (U, npad) score row: the block's (history, model row) COO pairs are
    sorted and segment-summed (exactly like _get_predict_scan_coo), then
    each candidate's score is a searchsorted join against the sorted run
    keys.  ``exclude_history`` adds the -1e30 history pairs and returns
    the per-user scored-item count (predict_candidate_scores semantics);
    without it, history items keep their scores (GetRec_1vsk)."""
    key = (npad, U, H, R, C, n, exclude_history)
    fn = _coo_cand_fns.get(key)
    if fn is None:
        import jax
        import jax.numpy as jnp

        SENT = U * npad
        assert SENT < 2 ** 31 - 1

        @jax.jit
        def run(Widx, Wval, bi, bv, cd):
            hin = bi >= 0
            safe = jnp.where(hin, bi, npad - 1)
            wri = jnp.take(Widx, safe.reshape(-1), axis=0) \
                .reshape(U, H, R)
            wrv = jnp.take(Wval, safe.reshape(-1), axis=0) \
                .reshape(U, H, R) * bv[..., None]
            l3 = jnp.broadcast_to(
                jnp.arange(U, dtype=jnp.int32)[:, None, None], (U, H, R))
            key_m = jnp.where(hin[..., None], l3 * npad + wri, SENT)
            val_m = jnp.where(hin[..., None], wrv, 0.0)
            if exclude_history:
                l2 = jnp.broadcast_to(
                    jnp.arange(U, dtype=jnp.int32)[:, None], (U, H))
                key_h = jnp.where(hin, l2 * npad + safe, SENT)
                val_h = jnp.where(hin, jnp.float32(-1e30), 0.0)
                keys = jnp.concatenate([key_m.reshape(-1),
                                        key_h.reshape(-1)])
                vals = jnp.concatenate([val_m.reshape(-1),
                                        val_h.reshape(-1)])
            else:
                keys = key_m.reshape(-1)
                vals = val_m.reshape(-1)
            keys, is_end, rsum = _coo_sorted_runs(keys, vals)
            N = keys.shape[0]

            uq = jnp.arange(U, dtype=jnp.int32)[:, None]
            qk = jnp.where((cd >= 0) & (cd < n),
                           uq * npad + jnp.clip(cd, 0, npad - 1),
                           SENT + 1).reshape(-1)
            pos = jnp.clip(jnp.searchsorted(keys, qk), 0, N - 1) \
                .astype(jnp.int32)
            hit = jnp.take(keys, pos) == qk
            cs = jnp.where(hit, jnp.take(rsum, pos), 0.0).reshape(U, C)

            end_real = is_end & (keys < SENT)
            nsc = jnp.zeros((U + 1,), jnp.int32).at[
                jnp.where(end_real, keys // npad, U)].add(
                (end_real & (rsum > 0)).astype(jnp.int32))
            return cs, nsc[:U]

        fn = _coo_cand_fns[key] = run
    return fn


def _coo_user_block(user_block, npad):
    """Largest block the int32 user*npad + candidate key admits."""
    while user_block > 1 and user_block * npad >= 2 ** 31:
        user_block //= 2
    if user_block * npad >= 2 ** 31:
        raise ValueError(
            f"catalogue too large for the int32 COO sort key "
            f"(npad={npad} >= 2^31); per-user COO predict needs an int64 "
            f"key variant at this scale")
    return user_block


def predict_candidate_scores(model: CSR, hist: CSR, cand: np.ndarray,
                             W_dev=None, user_block: int = 1024,
                             sparse: bool | None = None):
    """Scores of an explicit candidate list per user, with the history
    excluded -- the vectorised core of the CLI neg-file mode
    (slim_predict.c:110-143: GetTopN over ALL items, then candidates keep
    their score if they were in the scored list, 0 otherwise).

    ``cand`` is (nusers, C) int32 with -1 padding.  Returns
    (cscores (nusers, C) f32  -- 0 for unscored/-1/history candidates,
     nscored (nusers,) int32  -- the user's scored-item count over ALL
     items, the reference's GetTopN return used to truncate the final
     list).
    """
    import jax
    import jax.numpy as jnp

    n = max(model.nrows, model.ncols, hist.ncols)
    npad = _bucket(n)
    if isinstance(W_dev, DeviceModelPack):
        W_dev = W_dev.densify() if W_dev.npad == npad else None
    if sparse is None:
        sparse = W_dev is None and npad > dense_predict_max_npad()
    use_coo = False
    if sparse:
        Wsp = sparsify_model_device(model, npad)
        coo = int(os.environ.get("SLIM_PREDICT_COO_NPAD",
                                 COO_PREDICT_NPAD))
        use_coo = coo > 0 and npad >= coo
        if use_coo:
            # no npad-wide rows in the COO join; only the int32 sort key
            # bounds the block
            user_block = _coo_user_block(user_block, npad)
        else:
            user_block = min(
                user_block,
                max(8, _pow2ceil(int(256e6 / (npad * 4) + 1)) // 2))
    else:
        W = W_dev if W_dev is not None else densify_model(model, npad)

    nusers, C = cand.shape
    H = _pow2ceil(max(int(hist.row_nnz().max()) if nusers else 1, 1))
    hidx, hval = hist.padded_rows(width=H)
    hidx = np.where(hidx >= n, -1, hidx)
    if hist.data is None:
        hval = (hidx >= 0).astype(np.float32)

    block_dense = _get_cand_score_block(npad, n, "dense")
    block_sp = _get_cand_score_block(npad, n, "sparse")

    out_cs = np.zeros((nusers, C), np.float32)
    out_ns = np.zeros(nusers, np.int32)
    ub = min(user_block, _pow2ceil(max(nusers, 1)))
    for u0 in range(0, nusers, ub):
        u1 = min(u0 + ub, nusers)
        bi = np.full((ub, H), -1, dtype=np.int32)
        bv = np.zeros((ub, H), dtype=np.float32)
        cd = np.full((ub, C), -1, dtype=np.int32)
        bi[:u1 - u0] = hidx[u0:u1]
        bv[:u1 - u0] = hval[u0:u1]
        cd[:u1 - u0] = cand[u0:u1]
        if use_coo:
            fn = _get_coo_cand_scores(npad, ub, H, int(Wsp[0].shape[1]),
                                      C, n, True)
            cs, ns = fn(Wsp[0], Wsp[1], jnp.asarray(bi), jnp.asarray(bv),
                        jnp.asarray(cd))
            # history runs carry the -1e30 marker sum; the reference's
            # cs>0 rule zeroes them like the masked dense path
            cs = jnp.where(cs > 0, cs, 0.0)
        elif sparse:
            cs, ns = block_sp(Wsp[0], Wsp[1], jnp.asarray(bi),
                              jnp.asarray(bv), jnp.asarray(cd))
        else:
            cs, ns = block_dense(W, jnp.asarray(bi), jnp.asarray(bv),
                                 jnp.asarray(cd))
        out_cs[u0:u1] = np.asarray(cs)[:u1 - u0]
        out_ns[u0:u1] = np.asarray(ns)[:u1 - u0]
    return out_cs, out_ns


@jax.jit
def _score_block_sparse(Widx, Wval, hist_idx, hist_val):
    """Per-user dense score rows from the padded-sparse model (no masking,
    no top-k) -- shared by the 1vsk candidate-gather path."""
    import jax.numpy as jnp

    npad = Widx.shape[0]
    U = hist_idx.shape[0]
    safe_idx = jnp.where(hist_idx >= 0, hist_idx, npad - 1)
    cand = Widx[safe_idx]
    w = Wval[safe_idx] * hist_val[:, :, None]
    urow = jnp.broadcast_to(jnp.arange(U)[:, None, None], cand.shape)
    return jnp.zeros((U, npad), jnp.float32).at[
        urow.reshape(-1), cand.reshape(-1)].add(w.reshape(-1))


# shape-keyed jitted blocks for the candidate-restricted paths: defining
# fresh @jax.jit closures inside every call would retrace + recompile per
# invocation; every other predict path uses module-level caches for the
# same reason.
_cand_score_fns: dict = {}
_1vsk_block_fns: dict = {}


def _get_cand_score_block(npad, n, kind):
    """fn(W..., bi, bv, cd) -> (candidate scores, per-user scored count)
    for predict_candidate_scores; kind = 'dense' | 'sparse'."""
    key = (npad, n, kind)
    fn = _cand_score_fns.get(key)
    if fn is not None:
        return fn
    import jax
    import jax.numpy as jnp

    def _cands(scores, cd):
        nscored = jnp.sum(scores > 0, axis=1).astype(jnp.int32)
        safe_cd = jnp.clip(cd, 0, npad - 1)
        cs = jnp.take_along_axis(scores, safe_cd, axis=1)
        return jnp.where((cd >= 0) & (cd < n) & (cs > 0), cs, 0.0), nscored

    if kind == "dense":
        @jax.jit
        def run(Wm, bi, bv, cd):
            hd, mask = _hist_dense(npad, bi, bv)
            scores = jnp.dot(hd, Wm, preferred_element_type=jnp.float32,
                             precision=jax.lax.Precision.HIGHEST)
            return _cands(jnp.where(mask, NEG_INF, scores), cd)
    else:
        @jax.jit
        def run(Wi, Wv, bi, bv, cd):
            scores = _score_block_sparse(Wi, Wv, bi, bv)
            safe_idx = jnp.where(bi >= 0, bi, npad - 1)
            U = bi.shape[0]
            mask = jnp.zeros((U, npad), bool).at[
                jnp.arange(U)[:, None], safe_idx].max(bi >= 0)
            return _cands(jnp.where(mask, NEG_INF, scores), cd)

    _cand_score_fns[key] = run
    return run


def _gather_cands_traced(scores, cand, kk, npad, n, from_cands):
    """Top-kk over the candidate set (GetRec_1vsk's intersect+sort)."""
    import jax
    import jax.numpy as jnp

    if from_cands:
        cscores = scores                                 # already (U, nnegs)
    else:
        safe_cand = jnp.clip(cand, 0, npad - 1)
        in_range = (cand >= 0) & (cand < n)
        cscores = jnp.where(
            in_range, jnp.take_along_axis(scores, safe_cand, axis=1), 0.0)
    top_sc, top_pos = jax.lax.top_k(cscores, kk)
    top_ids = jnp.take_along_axis(cand, top_pos, axis=1)
    return top_ids.astype(jnp.int32), top_sc


def _get_1vsk_block(npad, n, kk, kind):
    """fn(...) -> (top ids, top scores) for predict_topn_1vsk; kind =
    'dense' | 'sparse' | 'from_cands' (pre-gathered candidate scores)."""
    key = (npad, n, kk, kind)
    fn = _1vsk_block_fns.get(key)
    if fn is not None:
        return fn
    import jax
    import jax.numpy as jnp

    if kind == "dense":
        @jax.jit
        def run(Wm, bi, bv, cand):
            hd, _ = _hist_dense(npad, bi, bv)           # no history mask:
            scores = jnp.dot(hd, Wm,                    # GetRec_1vsk keeps
                             preferred_element_type=jnp.float32,
                             precision=jax.lax.Precision.HIGHEST)
            return _gather_cands_traced(scores, cand, kk, npad, n, False)
    elif kind == "sparse":
        @jax.jit
        def run(Wi, Wv, bi, bv, cand):
            scores = _score_block_sparse(Wi, Wv, bi, bv)
            return _gather_cands_traced(scores, cand, kk, npad, n, False)
    else:
        @jax.jit
        def run(cs, cand):
            return _gather_cands_traced(cs, cand, kk, npad, n, True)

    _1vsk_block_fns[key] = run
    return run


def predict_topn_1vsk(model: CSR, hist: CSR, negitems: np.ndarray,
                      nrcmds: int = 10, W_dev=None, user_block: int = 1024,
                      sparse: bool | None = None):
    """1-vs-k candidate-restricted prediction (GetRec_1vsk,
    predict.c:77-133).

    ``negitems`` is (nusers, nnegs) int32; out-of-range ids keep score 0 but
    still occupy candidate slots (predict.c:97-106).  History items are NOT
    excluded from the candidate set (marker only protects non-candidates).
    """
    import jax
    import jax.numpy as jnp

    n = max(model.nrows, model.ncols, hist.ncols)
    npad = _bucket(n)
    if isinstance(W_dev, DeviceModelPack):
        W_dev = W_dev.densify() if W_dev.npad == npad else None
    if sparse is None:
        sparse = W_dev is None and npad > dense_predict_max_npad()
    use_coo = False
    if sparse:
        Wsp = sparsify_model_device(model, npad)
        coo = int(os.environ.get("SLIM_PREDICT_COO_NPAD",
                                 COO_PREDICT_NPAD))
        use_coo = coo > 0 and npad >= coo
        if use_coo:
            user_block = _coo_user_block(user_block, npad)
        else:
            user_block = min(
                user_block,
                max(8, _pow2ceil(int(256e6 / (npad * 4) + 1)) // 2))
    else:
        W = W_dev if W_dev is not None else densify_model(model, npad)

    nusers, nnegs = negitems.shape
    H = _pow2ceil(max(int(hist.row_nnz().max()) if nusers else 1, 1))
    hidx, hval = hist.padded_rows(width=H)
    hidx = np.where(hidx >= n, -1, hidx)
    if hist.data is None:
        hval = (hidx >= 0).astype(np.float32)

    kk = min(nrcmds, nnegs)
    block = _get_1vsk_block(npad, n, kk, "dense")
    block_sparse = _get_1vsk_block(npad, n, kk, "sparse")

    ids = np.full((nusers, min(nrcmds, nnegs)), -1, dtype=np.int32)
    scores = np.zeros((nusers, min(nrcmds, nnegs)), dtype=np.float32)
    ub = min(user_block, _pow2ceil(max(nusers, 1)))
    for u0 in range(0, nusers, ub):
        u1 = min(u0 + ub, nusers)
        bi = np.full((ub, H), -1, dtype=np.int32)
        bv = np.zeros((ub, H), dtype=np.float32)
        cd = np.full((ub, nnegs), -1, dtype=np.int32)
        bi[:u1 - u0] = hidx[u0:u1]
        bv[:u1 - u0] = hval[u0:u1]
        cd[:u1 - u0] = negitems[u0:u1]
        if use_coo:
            fn = _get_coo_cand_scores(npad, ub, H, int(Wsp[0].shape[1]),
                                      nnegs, n, False)
            cs, _ = fn(Wsp[0], Wsp[1], jnp.asarray(bi), jnp.asarray(bv),
                       jnp.asarray(cd))
            tid, tsc = _get_1vsk_block(npad, n, kk, "from_cands")(
                cs, jnp.asarray(cd))
        elif sparse:
            tid, tsc = block_sparse(Wsp[0], Wsp[1], jnp.asarray(bi),
                                    jnp.asarray(bv), jnp.asarray(cd))
        else:
            tid, tsc = block(W, jnp.asarray(bi), jnp.asarray(bv),
                             jnp.asarray(cd))
        ids[u0:u1] = np.asarray(tid)[:u1 - u0]
        scores[u0:u1] = np.asarray(tsc)[:u1 - u0]
    counts = np.full(nusers, ids.shape[1], dtype=np.int32)
    return ids, scores, counts
