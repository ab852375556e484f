"""Batched coordinate-descent block solver.

Accelerator reformulation of the reference's per-column CD
(src/libslim/cd.c:101-142 + driver src/libslim/estimate.c:328-558): a block
of B item columns is solved simultaneously against the shared Gram matrix
G = AᵀA.  All sparse vector ops of the reference become dense vector math:

* ``aTy``            -> ``G[:, j]``  (the target's Gram column)
* ``aᵢᵀ yhat``       -> ``q[i] - G[i,i]·x[i]`` with ``q = G x`` maintained
                         incrementally (the reference maintains ``yhat`` in
                         user space at O(nnz) per update; we maintain ``q``
                         in item space at O(n) per update, B-way batched)
* soft-threshold + nonnegativity (cd.c:125-128) is unchanged:
  ``x_i = max(num - l1r, 0) / (G[i,i] + l2r)`` (no negative branch).

The update order is a per-sweep random permutation shared across the block
(the reference shuffles per column with a shared-state ``rand()``,
cd.c:76-86 -- benign nondeterminism; we use a counter-based key so runs are
reproducible).  Convergence per column: Σ(Δx)² < optTol (cd.c:135-138);
per-column sweep cap min(50·nnz_j, maxniters) (estimate.c:448-449).

``q`` is recomputed with one matrix product at the start of every sweep,
so f32 drift from the incremental rank-1 updates never accumulates across
sweeps.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .cd_triton import CHUNK, gs_chunk


def fslim_active_mask(gj, diag, self_ids, n_valid, nnbrs, simtype,
                      col_ids=None, self_norms=None):
    """FSLIM neighbour selection from Gram columns (neighbors.c:16-125).

    Candidates are items co-rated with the target (gj > 0), excluding the
    target itself; similarity is ``dotp`` = aᵀb, ``cos`` = aᵀb/‖b‖ (the
    target's own norm is a constant per column so the ranking matches full
    cosine; neighbors.c:82-83), ``jac`` = aᵀb/(‖b‖+‖a‖-aᵀb)
    (neighbors.c:107-109; the reference uses 2-norms, not squared).  The
    top-nnbrs by similarity become the CD active set.

    ``col_ids`` (width,) maps positions to global item ids when operating
    in a compacted coordinate space (defaults to arange); ``self_norms``
    (B,) supplies ‖a_j‖ directly when ``diag`` is compacted (jac only).
    Restricting the top-k to a union superset of the true top sets is
    exact: every column's global top-nnbrs is inside the union, so the
    restricted ranking returns the same set.
    """
    B, width = gj.shape
    cnorms = jnp.sqrt(diag)
    ids = col_ids if col_ids is not None else \
        jnp.arange(width, dtype=self_ids.dtype)
    cand = (gj > 0) & (ids[None, :] != self_ids[:, None]) \
        & (ids[None, :] < n_valid)
    if simtype == "dotp":
        sim = gj
    elif simtype == "cos":
        sim = gj / jnp.maximum(cnorms[None, :], 1e-30)
    elif simtype == "jac":
        selfn = self_norms if self_norms is not None else jnp.take(
            cnorms, jnp.clip(self_ids, 0, width - 1))
        denom = cnorms[None, :] + selfn[:, None] - gj
        sim = gj / jnp.where(jnp.abs(denom) > 1e-30, denom, 1e-30)
    else:
        raise ValueError(f"unknown simtype {simtype!r}")
    sim = jnp.where(cand, sim, -jnp.inf)
    k = max(1, min(int(nnbrs), width))
    if width >= 1 << 18:
        # two-stage exact top-k: a single-pass top_k sorts the whole
        # 2M-wide row; the chunked composition keeps each sort window
        # small (see predict._topk_wide -- any global top-k element is
        # inside its chunk's top-k)
        from ..predict import _topk_wide

        vals, ids_k = _topk_wide(sim, k, chunk=32768)
    else:
        vals, ids_k = jax.lax.top_k(sim, k)
    valid = jnp.isfinite(vals)
    return jnp.zeros((B, width), bool).at[
        jnp.arange(B)[:, None], ids_k].max(valid)


# Precision of the f32 products of the sweep.  HIGHEST is full f32 on every
# backend (on the GPU: no TF32 rounding of the operands); the objective
# epilogue always uses it.
HIGHEST = jax.lax.Precision.HIGHEST
# the GPU sweep's products (sweep-start q, chunk propagation): three TF32
# tensor-core passes, f32-level accuracy (never bare TF32).  On an H100
# this cut the ML-20M learn from 25.2 s to 20.6 s at an objective within
# 1e-9 relative; the CPU has no TF32 algorithms.
TF32_X3 = jax.lax.DotAlgorithmPreset.TF32_TF32_F32_X3


class Sweep(NamedTuple):
    impl: str          # in-chunk step: "triton" (Pallas kernel) | "xla"
    precision: object  # precision of the sweep's products


def sweep_impl(kernel: str = "auto", platform: str | None = None) -> Sweep:
    """The block solve for a platform: the Triton chunk kernel
    (:mod:`slim_tpu.ops.cd_triton`) with TF32x3 products on ``gpu``, the
    XLA chunk step with HIGHEST products everywhere else.  ``kernel``
    ("auto" | "triton" | "xla", ``SlimConfig.kernel``) pins the step; the
    precision still follows the platform."""
    if platform is None:
        platform = jax.devices()[0].platform
    if kernel == "auto":
        kernel = "triton" if platform == "gpu" else "xla"
    gpu_kernel = kernel == "triton" and platform == "gpu"
    return Sweep(kernel, TF32_X3 if gpu_kernel else HIGHEST)


# Largest block (columns solved together) per implementation on the
# compact path (solvers/cd._compact_block_size picks the size below it).
# Where the unions do not grow with the block, larger blocks amortise the
# per-block gathers and harvest, and the Triton sweep's products run more
# efficiently: on an H100 the ML-20M learn took 20.6 s at B=1024 against
# 24.9 s at B=512.
MAX_BLOCK = {"xla": 256, "triton": 1024}


def check_sweep_domain(impl: str, B: int, width: int) -> None:
    """Reject a (B, width) block the chosen implementation cannot take,
    before anything is traced or dispatched."""
    if impl not in ("xla", "triton"):
        raise ValueError(f"unknown sweep implementation {impl!r}")
    if width % CHUNK:
        raise ValueError(f"coordinate width {width} is not a multiple of "
                         f"{CHUNK}")
    if impl == "triton":
        from .cd_triton import gs_supported

        if not gs_supported(B):
            raise ValueError(f"the Triton sweep takes blocks of a multiple "
                             f"of its program width; got B={B}")


@functools.partial(
    jax.jit, static_argnames=("shuffle", "fslim_nnbrs", "simtype", "impl",
                              "precision"))
def cd_solve_block_ids(G, j_ids, col_maxniters, x0, n_valid,
                       l1r, l2r, optTol, seed, shuffle=True,
                       fslim_nnbrs=0, simtype="cos", impl="xla",
                       precision=HIGHEST):
    """Column-id entry point: derives gj / active-set / yty from G inside
    the compiled program (one compile for the whole learn loop instead of
    per-block eager slicing).

    ``j_ids`` padded entries should point at a zero column of G (the
    driver pads with npad-1); their caps must be 0.  ``l1r``/``l2r``
    accept a scalar or a per-column (B,) vector (per-column regularisation
    powers the parallel-grid mselect mode).
    """
    diag = jnp.diagonal(G)
    gj = jnp.take(G, j_ids, axis=1).T                       # (B, npad)
    B, npad = gj.shape
    l1r = jnp.broadcast_to(jnp.asarray(l1r, gj.dtype).reshape(-1), (B,))
    l2r = jnp.broadcast_to(jnp.asarray(l2r, gj.dtype).reshape(-1), (B,))
    cols = jnp.arange(npad, dtype=j_ids.dtype)
    if fslim_nnbrs > 0:
        active = fslim_active_mask(gj, diag, j_ids, n_valid,
                                   fslim_nnbrs, simtype)
    else:
        active = (gj > l1r[:, None]) & (cols[None, :] != j_ids[:, None])
    yty = jnp.take(diag, j_ids)
    return _cd_core(G, gj, diag, active, x0, col_maxniters, yty,
                    l1r, l2r, optTol, seed, shuffle, impl, precision)


@functools.partial(jax.jit, static_argnames=("shuffle", "impl", "precision"))
def cd_solve_block(G, gj, diag, active, x0, col_maxniters, yty,
                   l1r, l2r, optTol, seed, shuffle=True, impl="xla",
                   precision=HIGHEST):
    return _cd_core(G, gj, diag, active, x0, col_maxniters, yty,
                    l1r, l2r, optTol, seed, shuffle, impl, precision)


@functools.partial(jax.jit, static_argnames=("fslim_nnbrs", "simtype"))
def block_union_masks_batched(G, j_ids_all, l1r, fslim_nnbrs=0,
                              simtype="cos"):
    """Union active sets for MANY blocks in one dispatch (vmapped
    :func:`block_union_mask` over (nblocks, B) column ids); returns
    (S_all (nblocks, npad), counts (nblocks,))."""
    def one(j_ids):
        return block_union_mask(G, j_ids, l1r, G.shape[0],
                                fslim_nnbrs=fslim_nnbrs, simtype=simtype)

    return jax.vmap(one)(j_ids_all)


@jax.jit
def count_over(x, eps):
    """Per-column model nnz: count of entries > eps (reference keeps
    entries > EPSILON=1e-7, slim.h:61)."""
    return jnp.sum(x > eps, axis=1, dtype=jnp.int32)


@functools.partial(jax.jit, static_argnames=("Tpad", "idx16"))
def pack_flat(x, eps, offsets, Tpad, idx16):
    """Exact-size flat harvest pack (device-side model compaction).

    x (B, K) nonneg solution block; offsets (B,) exclusive prefix sums of
    the per-column counts (host-computed from a prior :func:`count_over`
    fetch); Tpad static >= total count.  Returns (vals (Tpad,) f32,
    idx (Tpad,) uint16|int32): entries of column b land at
    [offsets[b], offsets[b]+cnt[b]) in ascending coordinate order.  The
    device->host harvest then moves exactly 6 (or 8) bytes per model
    nonzero -- no top-M overflow refetches, no width-K padding.
    """
    B, K = x.shape
    mask = x > eps
    rank = jnp.cumsum(mask.astype(jnp.int32), axis=1) - 1
    pos = jnp.where(mask, offsets[:, None] + rank, Tpad)
    flat_val = jnp.zeros((Tpad,), x.dtype).at[pos.reshape(-1)].set(
        x.reshape(-1), mode="drop", unique_indices=True)
    cols = jnp.broadcast_to(
        jnp.arange(K, dtype=jnp.int32)[None, :], (B, K))
    idt = jnp.uint16 if idx16 else jnp.int32
    flat_idx = jnp.zeros((Tpad,), idt).at[pos.reshape(-1)].set(
        cols.astype(idt).reshape(-1), mode="drop", unique_indices=True)
    return flat_val, flat_idx


@functools.partial(jax.jit, static_argnames=("nblocks", "B"))
def block_union_flags(G, nblocks, B, l1r):
    """Screening-union membership flags for consecutive-rank blocks in one
    slice-reduce pass over G (no per-block gathers, no device argsorts).

    Returns u (nblocks, npad) bool: u[b, i] = coordinate i is active for
    some column of block b (columns [b*B, (b+1)*B), self excluded).  The
    driver compacts u on device (:func:`compact_union_ids`) and fetches
    only the per-block counts.
    """
    npad = G.shape[0]
    total = nblocks * B
    Gb = G[:, :min(total, npad)]
    if total > npad:
        Gb = jnp.pad(Gb, ((0, 0), (0, total - npad)))
    over = (Gb > jnp.asarray(l1r, G.dtype)).reshape(npad, nblocks, B)
    cnt = jnp.sum(over, axis=2)                       # (npad, nblocks)
    rows = jnp.arange(npad)
    # remove the self term when coordinate i's own column is in block b
    self_block = rows // B
    self_over = jnp.diagonal(G) > jnp.asarray(l1r, G.dtype)
    self_term = (jnp.arange(nblocks)[None, :] == self_block[:, None]) \
        & self_over[:, None] & (rows < min(total, npad))[:, None]
    return ((cnt - self_term.astype(cnt.dtype)) > 0).T   # (nblocks, npad)


@functools.partial(jax.jit, static_argnames=("f",))
def group_union_flags(u, f):
    """Union flags of blocks ``f`` times wider from :func:`block_union_flags`
    of consecutive blocks: row g ORs rows [g*f, (g+1)*f) (exact: a union
    of unions).  Returns (flags (ceil(nblocks/f), npad), counts)."""
    nb, npad = u.shape
    ng = -(-nb // f)
    ug = jnp.pad(u, ((0, ng * f - nb), (0, 0))).reshape(ng, f, npad)
    ug = jnp.any(ug, axis=1)
    return ug, jnp.sum(ug, axis=1, dtype=jnp.int32)


@jax.jit
def compact_union_ids(u):
    """Compact the (nblocks, npad) union flags ON DEVICE.

    Returns (ids (nblocks, npad) int32, counts (nblocks,) int32): ids[b]
    holds block b's flagged coordinate ids ascending, padded with npad-1
    (the zero row/col, same convention as block_union_mask).  The driver
    fetches only ``counts`` (the first post-Gram sync, a few hundred
    bytes) and slices each block's (K,) list from the device-resident
    ``ids`` -- the (nblocks, npad) flag matrix never leaves the device
    and no host-side index lists are built or re-uploaded (the screen
    this serves: estimate.c:411-421).
    """
    npad = u.shape[1]
    iota = jnp.arange(npad, dtype=jnp.int32)
    # inactive entries sort after every real id, then clamp to npad-1
    keys = jnp.where(u, iota[None, :], jnp.int32(1 << 30))
    ids = jnp.minimum(jnp.sort(keys, axis=1), jnp.int32(npad - 1))
    return ids, jnp.sum(u, axis=1, dtype=jnp.int32)


@functools.partial(jax.jit, static_argnames=("K", "fslim_nnbrs", "simtype"))
def block_union_mask(G, j_ids, l1r, K, fslim_nnbrs=0, simtype="cos"):
    """Screen a block and extract its union active set.

    Returns (S, union_count): S = (K,) compacted coordinate ids (ascending;
    padded entries point at npad-1, the zero row/col), union_count = true
    union size so the caller can grow K when it overflows.

    The union set is what makes large catalogues tractable: after
    frequency relabeling the blocks' active sets overlap heavily (popular
    items dominate every screen), so K_union ≈ K_active per column rather
    than B x K_active.
    """
    npad = G.shape[0]
    gj = jnp.take(G, j_ids, axis=1).T                  # (B, npad)
    B = gj.shape[0]
    l1v = jnp.broadcast_to(jnp.asarray(l1r, gj.dtype).reshape(-1), (B,))
    cols = jnp.arange(npad, dtype=j_ids.dtype)
    if fslim_nnbrs > 0:
        active = fslim_active_mask(gj, jnp.diagonal(G), j_ids, npad,
                                   fslim_nnbrs, simtype)
    else:
        active = (gj > l1v[:, None]) & (cols[None, :] != j_ids[:, None])
    u = jnp.any(active, axis=0)                        # (npad,)
    count = jnp.sum(u.astype(jnp.int32))
    # ascending active ids first: sort key puts active coords (key=idx)
    # before inactive ones (key=idx+npad); padded tail -> npad-1
    key = jnp.where(u, cols, cols + npad)
    order = jnp.argsort(key)[:K]
    pos = jnp.arange(K, dtype=j_ids.dtype)
    S = jnp.where(pos < count, order.astype(j_ids.dtype), npad - 1)
    return S, count


@functools.partial(
    jax.jit, static_argnames=("shuffle", "impl", "precision", "fslim_nnbrs",
                              "simtype"))
def cd_solve_block_compact(G, S, j_ids, col_maxniters, x0s,
                           l1r, l2r, optTol, seed, shuffle=True, impl="xla",
                           precision=HIGHEST, fslim_nnbrs=0, simtype="cos"):
    """Solve a block in the compacted coordinate space S (from
    :func:`block_union_mask`).

    Exact: coordinates outside S are inactive for every column of the
    block (for FSLIM, S is the union of the per-column top-k sets, so the
    restricted top-k returns the same sets), and restricting the solve to
    S changes nothing; per-sweep cost drops from O(npad²) to O(K²).
    ``x0s`` is the warm start already gathered into compact space ((B, K)).
    """
    npad = G.shape[0]
    B = j_ids.shape[0]
    K = S.shape[0]
    l1v = jnp.broadcast_to(jnp.asarray(l1r, G.dtype).reshape(-1), (B,))
    l2v = jnp.broadcast_to(jnp.asarray(l2r, G.dtype).reshape(-1), (B,))

    # compact Gram: row gather then column gather
    Gs = jnp.take(jnp.take(G, S, axis=0), S, axis=1)   # (K, K)
    diag_full = jnp.diagonal(G)
    diag_s = jnp.take(diag_full, S)
    gjs = jnp.take(jnp.take(G, j_ids, axis=1).T, S, axis=1)  # (B, K)
    yty = jnp.take(diag_full, j_ids)

    pad_mask = S != (npad - 1)                         # real compact coords
    if fslim_nnbrs > 0:
        active_s = fslim_active_mask(
            gjs, diag_s, j_ids, npad, fslim_nnbrs, simtype,
            col_ids=S, self_norms=jnp.sqrt(yty)) & pad_mask[None, :]
    else:
        active_s = (gjs > l1v[:, None]) & (S[None, :] != j_ids[:, None]) \
            & pad_mask[None, :]

    return _cd_core(Gs, gjs, diag_s, active_s, x0s, col_maxniters, yty,
                    l1v, l2v, optTol, seed, shuffle, impl, precision)


def gs_chunk_xla(r, x, t, l2, d, gcc, perm):
    """In-chunk Gauss-Seidel in XLA: the same arithmetic and order as the
    Triton kernel :func:`slim_tpu.ops.cd_triton.gs_chunk` (same arguments,
    see there), one dependent (B,)-sized step per coordinate."""
    B, C = x.shape

    def body(ci, carry):
        r, x = carry
        i = perm[ci]
        xc = jax.lax.dynamic_slice(x, (0, i), (B, 1))[:, 0]
        rc = jax.lax.dynamic_slice(r, (0, i), (B, 1))[:, 0]
        tc = jax.lax.dynamic_slice(t, (0, i), (B, 1))[:, 0]
        di = d[i]
        num = rc + di * xc
        cand = jnp.where(num > tc, (num - tc) / (di + l2), 0.0)
        newx = jnp.where(tc < jnp.inf, cand, xc)
        grow = jax.lax.dynamic_slice(gcc, (i, 0), (1, C))[0]
        r = r - (newx - xc)[:, None] * grow[None, :]
        x = jax.lax.dynamic_update_slice(x, newx[:, None], (0, i))
        return r, x

    _, x = jax.lax.fori_loop(0, C, body, (r, x))
    return x


def _cd_core(G, gj, diag, active, x0, col_maxniters, yty,
             l1r, l2r, optTol, seed, shuffle=True, impl="xla",
             precision=HIGHEST):
    """Solve B columns of the SLIM elastic-net problem against shared G.

    Parameters
    ----------
    G : (n, n) f32          symmetric Gram matrix (padded cols are zero).
    gj : (B, n) f32         Gram columns of the B targets: gj[b] = G[:, J[b]].
    diag : (n,) f32         diag(G) = squared column norms.
    active : (B, n) bool    active-set mask (screen G[:,j] > l1r, i != j --
                            estimate.c:412-421 -- or FSLIM neighbour set).
    x0 : (B, n) f32         warm start (caller pre-masks to the active set,
                            estimate.c:453-471).
    col_maxniters : (B,) i32  per-column sweep caps.
    yty : (B,) f32          ||y_j||² = G[j,j] for residual computation.
    l1r, l2r : scalar or per-column (B,) vector.
    optTol : scalar.
    seed : i32 scalar       base for the per-sweep permutation keys.
    shuffle : static bool   permuted vs cyclic coordinate order.
    impl : static str       the in-chunk Gauss-Seidel step: "triton", the
                            Pallas kernel (:mod:`slim_tpu.ops.cd_triton`),
                            or "xla", :func:`gs_chunk_xla`.
    precision : static      precision of the sweep's products (the
                            objective epilogue is always HIGHEST); see
                            :func:`sweep_impl`.

    Returns
    -------
    x : (B, n) f32 solutions (zero outside active set).
    niters : (B,) i32 sweeps run per column.
    rstatus : (B,) bool converged-within-cap flag (cd.c:97-98).
    rnorm : (B,) f32   ½||y - Ax||² per column (estimate.c:477-481).
    obj : (B,) f32     full objective per column (estimate.c:484-489).
    """
    B, n = gj.shape
    f32 = gj.dtype
    l1v = jnp.broadcast_to(jnp.asarray(l1r, f32).reshape(-1), (B,))
    l2v = jnp.broadcast_to(jnp.asarray(l2r, f32).reshape(-1), (B,))
    x0 = jnp.where(active, x0, jnp.zeros((), f32))
    tmax = jnp.max(jnp.where(jnp.any(active, axis=1), col_maxniters, 0))
    key = jax.random.PRNGKey(seed)

    def sweep_cond(carry):
        x, q, t, converged, niters = carry
        live = (~converged) & (t < col_maxniters)
        return (t < tmax) & jnp.any(live)

    nchunks = n // CHUNK
    assert n % CHUNK == 0, "pad the coordinate dimension to a CHUNK multiple"

    step = gs_chunk if impl == "triton" else gs_chunk_xla

    def sweep_body(carry):
        x, q, t, converged, niters = carry
        live = (~converged) & (t < col_maxniters)  # (B,)
        # exact q at sweep start: one product kills the f32 drift
        q = jnp.dot(x, G, preferred_element_type=f32, precision=precision)
        if shuffle:
            # randomised visit order = shuffled chunk order x shuffled
            # order within each chunk (shared across the block).  The
            # reference shuffles the flat active list per column
            # (cd.c:115); any decorrelated order serves the same purpose
            # and the optimum is identical (strongly convex problem).
            tkey = jax.random.fold_in(key, t)
            chunk_perm = jax.random.permutation(tkey, nchunks)
            inner_perm = jax.random.permutation(
                jax.random.fold_in(tkey, 1), CHUNK)
        else:
            chunk_perm = jnp.arange(nchunks)
            inner_perm = jnp.arange(CHUNK)
        inner_perm = inner_perm.astype(jnp.int32)
        # the chunks with an active coordinate in a live column, in this
        # sweep's visit order; the loop runs over those only
        has = jnp.any((active & live[:, None]).reshape(B, nchunks, CHUNK),
                      axis=(0, 2))
        order = jnp.argsort(~has[chunk_perm], stable=True)
        clist = chunk_perm[order].astype(jnp.int32)

        def chunk_body(cc, inner):
            x, q, dltx = inner
            base = clist[cc] * CHUNK
            Gloc = jax.lax.dynamic_slice(G, (base, 0), (CHUNK, n))
            Gcc = jax.lax.dynamic_slice(Gloc, (0, base), (CHUNK, CHUNK))
            gj_loc = jax.lax.dynamic_slice(gj, (0, base), (B, CHUNK))
            a_loc = jax.lax.dynamic_slice(active, (0, base), (B, CHUNK))
            x_loc = jax.lax.dynamic_slice(x, (0, base), (B, CHUNK))
            q_loc = jax.lax.dynamic_slice(q, (0, base), (B, CHUNK))
            d_loc = jax.lax.dynamic_slice(diag, (base,), (CHUNK,))
            # threshold encoding of the step: l1r where the coordinate is
            # active in a live column, +inf (keep x) otherwise
            thr = jnp.where(a_loc & live[:, None], l1v[:, None],
                            jnp.asarray(jnp.inf, f32))
            x_new = step(gj_loc - q_loc, x_loc, thr, l2v, d_loc, Gcc,
                         inner_perm)
            dx = x_new - x_loc
            # propagate the finished chunk to the global q: one product
            # over the whole block
            q = q + jnp.dot(dx, Gloc, preferred_element_type=f32,
                            precision=precision)
            x = jax.lax.dynamic_update_slice(x, x_new, (0, base))
            return x, q, dltx + jnp.sum(dx * dx, axis=1)

        x, q, dltx = jax.lax.fori_loop(
            0, jnp.sum(has, dtype=jnp.int32), chunk_body,
            (x, q, jnp.zeros(B, f32)))
        converged = converged | (live & (dltx < optTol))
        niters = niters + live.astype(jnp.int32)
        return x, q, t + 1, converged, niters

    q0 = jnp.dot(x0, G, preferred_element_type=f32, precision=precision)
    x, q, t, converged, niters = jax.lax.while_loop(
        sweep_cond, sweep_body,
        (x0, q0, jnp.zeros((), jnp.int32), jnp.zeros(B, bool),
         jnp.zeros(B, jnp.int32)))

    # final exact q for the residual/objective (estimate.c:477-489):
    # ||y - Ax||² = yᵀy - 2 xᵀ(Aᵀy) + xᵀ G x
    q = jnp.dot(x, G, preferred_element_type=f32, precision=HIGHEST)
    rnorm = 0.5 * (yty - 2.0 * jnp.sum(x * gj, axis=1) + jnp.sum(x * q, axis=1))
    obj = rnorm + 0.5 * l2v * jnp.sum(x * x, axis=1) \
        + l1v * jnp.sum(jnp.abs(x), axis=1)
    return x, niters, converged, rnorm, obj
