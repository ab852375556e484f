"""SPMD distributed learning and prediction over a device mesh.

Device replacement for the reference's OpenMP shared-memory fan-out
(estimate.c:371-403).  Data layout and collectives:

* the rating matrix is row(user)-sharded over ``dp``; each device computes
  a partial Gram ``A_shardᵀ A_shard`` and a single ``psum('dp')``
  produces the full G everywhere (the only inter-device traffic of the
  learn phase);
* item columns are sharded over the flattened (dp, mp) grid; each device
  runs the batched CD kernel on its own column block -- zero communication,
  mirroring the embarrassing parallelism of the reference;
* results are reassembled by the out-sharding (an all-gather only if the
  caller asks for a replicated model).

For catalogues too large to replicate (or even materialize) G,
``distributed_learn_blockwise`` computes Gram *blocks* on the fly per
column super-block (screen psum + compact-Gram psum + sharded solves) --
G never exists anywhere, so the item-count ceiling is set by the compact
union width, not n² (SURVEY §7 hard part #1).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:  # jax >= 0.6 promotes shard_map to the top level
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from ..ops.cd_kernel import cd_solve_block
from ..types import CSR

import logging

logger = logging.getLogger("slim_tpu")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _host_fetch(x) -> np.ndarray:
    """``np.asarray`` for device arrays that may span other processes'
    devices (multi-controller meshes, e.g. a multi-host cluster or the
    2-process CI exercise): a sharded output is all-gathered through the
    runtime first; fully-addressable arrays take the plain fetch."""
    if not isinstance(x, jax.Array) or x.is_fully_addressable:
        return np.asarray(x)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def _host_fetch_all(*xs):
    """Fetch several arrays with at most ONE cross-process collective
    (process_allgather takes a pytree) instead of one per array."""
    if all(not isinstance(x, jax.Array) or x.is_fully_addressable
           for x in xs):
        return tuple(np.asarray(x) for x in xs)
    from jax.experimental import multihost_utils

    out = multihost_utils.process_allgather(tuple(xs), tiled=True)
    return tuple(np.asarray(a) for a in out)


# --------------------------------------------------------------------- #
# sharded Gram
# --------------------------------------------------------------------- #
_sharded_gram_sparse_fns: dict = {}


def _get_sharded_gram_sparse(mesh: Mesh, rb: int, npad: int):
    """Jitted SPMD sparse Gram: every device scatter-densifies its row
    blocks from padded triplets and accumulates partial Grams;
    one psum over the whole grid replicates the full G.  The dense rating
    matrix is never materialized anywhere (round-1 weakness #3)."""
    key = (mesh, rb, npad)
    fn = _sharded_gram_sparse_fns.get(key)
    if fn is None:
        def gram(lr, cols, vals):
            def body(g, xs):
                l, c, v = xs
                blk = jnp.zeros((rb, npad), jnp.float32)
                blk = blk.at[l, c].add(v, unique_indices=True, mode="drop")
                return g + jnp.dot(
                    blk.T, blk, preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST), None

            g0 = jnp.zeros((npad, npad), jnp.float32)
            g, _ = jax.lax.scan(body, g0, (lr, cols, vals))
            return jax.lax.psum(g, ("dp", "mp"))

        spec = P(("dp", "mp"), None)
        fn = jax.jit(shard_map(
            gram, mesh=mesh, in_specs=(spec, spec, spec),
            out_specs=P(None, None), check_vma=False))
        _sharded_gram_sparse_fns[key] = fn
    return fn


def sharded_gram_sparse(train: CSR, mesh: Mesh, pad_to: int,
                        row_block: int = 4096):
    """Replicated Gram over the mesh from host triplets.

    Rows are split into ndev equal row-ranges (one per device, over the
    flattened grid); each range is bucketed into fixed-size row blocks of
    padded (local_row, col, val) triplets exactly like
    ops.gram.gram_device_sparse, then the SPMD kernel psums the partial
    Grams.  Returns the replicated jax.Array.
    """
    ndev = mesh.size
    nrows = train.nrows
    per_dev = _round_up(max((nrows + ndev - 1) // ndev, 1), row_block)
    nsteps = per_dev // row_block
    rows = np.repeat(np.arange(nrows, dtype=np.int64),
                     np.diff(train.indptr).astype(np.int64))
    vals = train.values()
    # bucket by global row block of width row_block; device d owns blocks
    # [d*nsteps, (d+1)*nsteps)
    total_steps = ndev * nsteps
    starts = train.indptr[np.minimum(
        np.arange(total_steps + 1, dtype=np.int64) * row_block,
        nrows)].astype(np.int64)
    bnnz = np.diff(starts)
    Pw = 1
    while Pw < max(int(bnnz.max()) if total_steps else 1, 1):
        Pw *= 2
    lr = np.full((total_steps, Pw), row_block, dtype=np.int32)  # OOB pad
    cc = np.zeros((total_steps, Pw), dtype=np.int32)
    vv = np.zeros((total_steps, Pw), dtype=np.float32)
    for k in range(total_steps):
        s, e = starts[k], starts[k + 1]
        lr[k, :e - s] = (rows[s:e] - k * row_block).astype(np.int32)
        cc[k, :e - s] = train.indices[s:e]
        vv[k, :e - s] = vals[s:e]
    fn = _get_sharded_gram_sparse(mesh, row_block, pad_to)
    spec = NamedSharding(mesh, P(("dp", "mp"), None))
    return fn(jax.device_put(lr, spec), jax.device_put(cc, spec),
              jax.device_put(vv, spec))


# --------------------------------------------------------------------- #
# one fused learn step (used by __graft_entry__.dryrun_multichip)
# --------------------------------------------------------------------- #
def sharded_learn_step(mesh: Mesh, l1r=1.0, l2r=1.0, optTol=1e-7,
                       shuffle=True):
    """A single SPMD training step: psum-Gram + column-block CD solve.

    This is the full multi-chip compute graph of one learn round in one
    compiled program (gram collective + independent solves), suitable for
    compile-validation on a virtual mesh.
    """

    def step(a_blk, j_ids, caps, seed):
        g_part = jnp.dot(a_blk.T, a_blk, preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.HIGHEST)
        g = jax.lax.psum(g_part, "dp")                  # collective 1: psum
        n = g.shape[0]
        diag = jnp.diagonal(g)
        gj = jnp.take(g, j_ids, axis=1).T
        cols = jnp.arange(n, dtype=j_ids.dtype)
        active = (gj > l1r) & (cols[None, :] != j_ids[:, None])
        yty = jnp.take(diag, j_ids)
        x0 = jnp.zeros_like(gj)
        x, niters, rstatus, rnorm, obj = cd_solve_block(
            g, gj, diag, active, x0, caps, yty, l1r, l2r, optTol,
            seed, shuffle=shuffle)
        # collective 2: every device sees the whole solved super-block
        x_all = jax.lax.all_gather(x, ("dp", "mp"), tiled=True)
        return x_all, jnp.sum(rnorm), jnp.sum(obj)

    fn = shard_map(
        step, mesh=mesh,
        in_specs=(P("dp", None), P(("dp", "mp")), P(("dp", "mp")), P()),
        out_specs=(P(None, None), P(), P()),
        check_vma=False)
    return jax.jit(fn)


# --------------------------------------------------------------------- #
# host-level distributed learn
# --------------------------------------------------------------------- #
def distributed_learn(train: CSR, cfg, mesh: Mesh, imodel: CSR | None = None):
    """Learn a model across all devices of ``mesh``.

    Round-2 design (replaces the dense-A prototype): the rating matrix
    ships as sparse triplets row-sharded over the whole grid; partial
    Grams psum into a replicated G (the only collective of the learn);
    then the SAME single-device driver -- union compaction, block
    solves, packed harvests -- runs with column blocks dispatched
    round-robin across the per-device G replicas
    (``estimate_model_cd(g_replicas=...)``).  Each device solves its own
    blocks concurrently (async dispatch keeps every queue full): the
    device form of the reference's OpenMP column fan-out
    (estimate.c:371-403), with no dense rating matrix anywhere.

    Matches the single-device result (same screening, caps, coordinate
    order per block), validated by tests/test_dist.py.  ``imodel``
    warm-starts the solves (estimate.c:453-471).
    """
    from ..solvers.cd import bucket_npad, estimate_model_cd

    train = train.infer_ncols()
    npad = bucket_npad(train.ncols)

    g = sharded_gram_sparse(train, mesh, pad_to=npad)
    # per-device full copies (G is replicated: every addressable shard is
    # the whole array, zero-copy views)
    replicas = [s.data for s in g.addressable_shards]
    model, stats = estimate_model_cd(train, cfg, imodel=imodel,
                                     g_replicas=replicas)
    stats["ndevices"] = mesh.size
    return model, stats


# --------------------------------------------------------------------- #
# blockwise distributed learn: G never materialized (>100k items)
# --------------------------------------------------------------------- #
_blockwise_fns: dict = {}
_screen_flags_fns: dict = {}

# per-device byte budget for the screen's (npad, chunk) ATY intermediate;
# bounds the superblock screen at very large catalogues (a full
# (npad, Bsup) ATY is 32GB replicated at the 2M-item north star)
import os as _os

def _screen_bytes() -> int:
    """SLIM_SCREEN_BYTES, read at call time (repo convention for A/B
    env knobs: an in-process flip must take effect, see
    predict._topk_chunk_env)."""
    return int(_os.environ.get("SLIM_SCREEN_BYTES", 1 << 31))


def _get_screen_flags(mesh: Mesh, rb: int, npad: int, chunk: int,
                      l1r: float, fslim_nnbrs: int = 0,
                      simtype: str = "cos"):
    """Jitted SPMD screen for one chunk of target columns, returning ONLY
    the union active flags (npad,).  The solve never needs the screen's
    ATY values: target columns are members of the compact set S, so their
    Gram rows come out of the psum'd compact Gram G[S, S] instead (and the
    FSLIM solve recomputes its top-k mask in the compact space, which is
    exact -- every target's global top-nnbrs is inside the union).  That
    makes the (npad, chunk) scatter intermediate the only screen memory,
    and ``chunk`` bounds it (SLIM_SCREEN_BYTES) independently of the
    superblock width -- for FSLIM too, which previously required a
    full-width (npad, Bsup) ATY."""
    key = (mesh, rb, npad, chunk, l1r, fslim_nnbrs, simtype)
    fn = _screen_flags_fns.get(key)
    if fn is None:
        from ..ops.cd_kernel import fslim_active_mask

        ndev = mesh.size
        mp_size = mesh.shape["mp"]
        # FSLIM's per-target top-k needs the full candidate axis on one
        # device, so its flags come from the psum'd (npad, chunk) buffer
        scatter_rows = fslim_nnbrs == 0 and npad % ndev == 0

        def screen_f(lr, cc, vv, jarr, diag_full):
            jl = jnp.full((npad,), chunk, jnp.int32).at[jarr].set(
                jnp.arange(chunk, dtype=jnp.int32))

            def body(aty, xs):
                l, c, v = xs
                ypos = jl[c]
                yblk = jnp.zeros((rb, chunk), jnp.float32)
                yblk = yblk.at[l, ypos].add(v, mode="drop")
                contrib = v[:, None] * yblk[jnp.clip(l, 0, rb - 1)]
                return aty.at[c].add(
                    jnp.where((l[:, None] >= 0) & (l[:, None] < rb),
                              contrib, 0.0), mode="drop"), None

            aty0 = jnp.zeros((npad, chunk), jnp.float32)
            aty, _ = jax.lax.scan(body, aty0, (lr, cc, vv))
            if fslim_nnbrs > 0:
                aty = jax.lax.psum(aty, ("dp", "mp"))
                active = fslim_active_mask(
                    aty.T, diag_full, jarr, npad, fslim_nnbrs, simtype).T
                return jnp.any(active, axis=1)
            if scatter_rows:
                # reduce-scatter over item rows + local threshold: ring
                # traffic ~(N-1)/N of the buffer and no (npad, chunk)
                # replica materialized per device (the psum form writes
                # ndev full copies); the (npad,) bool flags reassemble
                # through the sharded out_spec below
                aty = jax.lax.psum_scatter(aty, ("dp", "mp"),
                                           scatter_dimension=0, tiled=True)
                fidx = (jax.lax.axis_index("dp") * mp_size
                        + jax.lax.axis_index("mp"))
                rows = (fidx * (npad // ndev)
                        + jnp.arange(npad // ndev, dtype=jnp.int32))
                active = (aty > l1r) & (rows[:, None] != jarr[None, :])
                return jnp.any(active, axis=1)
            aty = jax.lax.psum(aty, ("dp", "mp"))
            rows = jnp.arange(npad, dtype=jnp.int32)
            active = (aty > l1r) & (rows[:, None] != jarr[None, :])
            return jnp.any(active, axis=1)

        spec = P(("dp", "mp"), None)
        fn = jax.jit(shard_map(
            screen_f, mesh=mesh,
            in_specs=(spec, spec, spec, P(None), P(None)),
            out_specs=P(("dp", "mp")) if scatter_rows else P(None),
            check_vma=False))
        _screen_flags_fns[key] = fn
    return fn


def _get_blockwise_fns(mesh: Mesh, rb: int, npad: int, Bsup: int, K: int,
                       l1r: float, l2r: float, optTol: float, shuffle: bool,
                       fslim_nnbrs: int, simtype: str):
    """Jitted SPMD programs for one super-block, cached per shape.

    screen(lr, cc, vv, jarr)  -> (aty (npad, Bsup) repl, flags (npad,) repl)
        ATY = AᵀA[:, jarr] accumulated from the row-sharded triplets by
        scatter (cost O(nnz·Bsup), the reference's own screening
        asymptotics, estimate.c:411-421) and psum'd; flags = union active
        mask over the block (screen G[:,j] > l1r, self excluded -- or the
        FSLIM top-k sets).
    gramc(lr, cc, vv, S)      -> Gs (K, K) replicated
        compact Gram G[S, S] = (A[:, S])ᵀ A[:, S]: per row block the
        S-restricted slice is scatter-densified via an S-position lookup
        and accumulated; psum replicates.
    solve(Gs, gjs, js, caps, x0s, diag_full, seed) -> per-column results
        columns sharded over the flattened grid; every device runs the
        batched CD core against the replicated compact Gram.
    """
    from ..ops.cd_kernel import (_cd_core, check_sweep_domain,
                                 fslim_active_mask, sweep_impl)

    impl, precision = sweep_impl()
    key = (mesh, rb, npad, Bsup, K, l1r, l2r, optTol, shuffle,
           fslim_nnbrs, simtype, impl)
    fns = _blockwise_fns.get(key)
    if fns is not None:
        return fns

    def screen(lr, cc, vv, jarr, diag_full):
        jl = jnp.full((npad,), Bsup, jnp.int32).at[jarr].set(
            jnp.arange(Bsup, dtype=jnp.int32))

        def body(aty, xs):
            l, c, v = xs
            ypos = jl[c]                                  # (Pw,)
            yblk = jnp.zeros((rb, Bsup), jnp.float32)
            yblk = yblk.at[l, ypos].add(v, mode="drop")   # A[:, jarr] rows
            contrib = v[:, None] * yblk[jnp.clip(l, 0, rb - 1)]
            return aty.at[c].add(
                jnp.where((l[:, None] >= 0) & (l[:, None] < rb), contrib,
                          0.0), mode="drop"), None

        aty0 = jnp.zeros((npad, Bsup), jnp.float32)
        aty, _ = jax.lax.scan(body, aty0, (lr, cc, vv))
        aty = jax.lax.psum(aty, ("dp", "mp"))
        rows = jnp.arange(npad, dtype=jnp.int32)
        if fslim_nnbrs > 0:
            active = fslim_active_mask(
                aty.T, diag_full, jarr, npad, fslim_nnbrs, simtype).T
        else:
            active = (aty > l1r) & (rows[:, None] != jarr[None, :])
        flags = jnp.any(active, axis=1)
        return aty, flags

    spec = P(("dp", "mp"), None)
    screen_fn = jax.jit(shard_map(
        screen, mesh=mesh, in_specs=(spec, spec, spec, P(None), P(None)),
        out_specs=(P(None, None), P(None)), check_vma=False))

    def gramc(lr, cc, vv, S):
        lookup = jnp.full((npad,), K, jnp.int32).at[S].set(
            jnp.arange(K, dtype=jnp.int32))

        def body(g, xs):
            l, c, v = xs
            cpos = lookup[c]
            blk = jnp.zeros((rb, K), jnp.float32)
            blk = blk.at[l, cpos].add(v, unique_indices=True, mode="drop")
            return g + jnp.dot(blk.T, blk,
                               preferred_element_type=jnp.float32,
                               precision=jax.lax.Precision.HIGHEST), None

        g0 = jnp.zeros((K, K), jnp.float32)
        g, _ = jax.lax.scan(body, g0, (lr, cc, vv))
        return jax.lax.psum(g, ("dp", "mp"))

    gramc_fn = jax.jit(shard_map(
        gramc, mesh=mesh, in_specs=(spec, spec, spec, P(None)),
        out_specs=P(None, None), check_vma=False))

    def diag_part(lr, cc, vv):
        d = jnp.zeros((npad,), jnp.float32).at[cc.reshape(-1)].add(
            jnp.where(lr.reshape(-1) < rb, vv.reshape(-1) ** 2, 0.0),
            mode="drop")
        return jax.lax.psum(d, ("dp", "mp"))

    diag_fn = jax.jit(shard_map(
        diag_part, mesh=mesh, in_specs=(spec, spec, spec),
        out_specs=P(None), check_vma=False))

    def solve(Gs, gjs, js, caps, x0s, S, yty, seed):
        # each device solves its Bsup/ndev columns of the superblock
        check_sweep_domain(impl, *gjs.shape)
        diag_s = jnp.diagonal(Gs)
        pad_mask = S != (npad - 1)
        if fslim_nnbrs > 0:
            active_s = fslim_active_mask(
                gjs, diag_s, js, npad, fslim_nnbrs, simtype,
                col_ids=S, self_norms=jnp.sqrt(yty)) & pad_mask[None, :]
        else:
            active_s = (gjs > l1r) & (S[None, :] != js[:, None]) \
                & pad_mask[None, :]
        seed_local = seed + jax.lax.axis_index("dp") * 131071 \
            + jax.lax.axis_index("mp") * 8191
        return _cd_core(Gs, gjs, diag_s, active_s, x0s, caps, yty,
                        l1r, l2r, optTol, seed_local, shuffle, impl,
                        precision)

    cols = P(("dp", "mp"))
    cols2 = P(("dp", "mp"), None)
    solve_fn = jax.jit(shard_map(
        solve, mesh=mesh,
        in_specs=(P(None, None), cols2, cols, cols, cols2, P(None), cols,
                  P()),
        out_specs=(cols2, cols, cols, cols, cols), check_vma=False))

    fns = (screen_fn, gramc_fn, diag_fn, solve_fn)
    _blockwise_fns[key] = fns
    return fns


def _rank_triplets(train: CSR, mesh: Mesh, row_block: int, npad: int,
                   posmap):
    """Row-sharded padded (local_row, col, val) triplets in RANK space,
    device_put once over the flattened grid."""
    ndev = mesh.size
    nrows = train.nrows
    per_dev = _round_up(max((nrows + ndev - 1) // ndev, 1), row_block)
    total_steps = ndev * (per_dev // row_block)
    starts = train.indptr[np.minimum(
        np.arange(total_steps + 1, dtype=np.int64) * row_block,
        nrows)].astype(np.int64)
    bnnz = np.diff(starts)
    Pw = 1
    while Pw < max(int(bnnz.max()) if total_steps else 1, 1):
        Pw *= 2
    rows = np.repeat(np.arange(nrows, dtype=np.int64),
                     np.diff(train.indptr).astype(np.int64))
    vals = train.values()
    lr = np.full((total_steps, Pw), row_block, dtype=np.int32)
    cc = np.full((total_steps, Pw), npad - 1, dtype=np.int32)
    vv = np.zeros((total_steps, Pw), dtype=np.float32)
    for k in range(total_steps):
        s, e = starts[k], starts[k + 1]
        lr[k, :e - s] = (rows[s:e] - k * row_block).astype(np.int32)
        cc[k, :e - s] = posmap[train.indices[s:e]]
        vv[k, :e - s] = vals[s:e]
    spec = NamedSharding(mesh, P(("dp", "mp"), None))
    return (jax.device_put(lr, spec), jax.device_put(cc, spec),
            jax.device_put(vv, spec))


def _superblocks_solve(train, cfg, mesh, n, npad, Bsup, p, posmap, caps_p,
                       n_eff, diag_dev, flags_cb, gs_cb, imodel,
                       fslim_nnbrs):
    """Shared superblock driver for the G-free and sharded-G distributed
    modes: build the target block, screen (``flags_cb``), compact to S,
    obtain the compact Gram + solver (``gs_cb``), warm-start, solve the
    columns sharded over the grid, harvest.  Exact single-device
    semantics (same screening, caps, coordinate order per block)."""
    from ..solvers.cd import EPSILON, bucket_npad

    ndev = mesh.size
    cols_spec = NamedSharding(mesh, P(("dp", "mp")))
    cols2_spec = NamedSharding(mesh, P(("dp", "mp"), None))
    repl = NamedSharding(mesh, P(None))

    use_warm = imodel is not None and cfg.mtype in ("slim", "oslim")
    imodel_csc = imodel.transpose() if use_warm else None

    # failure recovery at cluster scale: per-superblock checkpoint/resume,
    # same signature-keyed store as the single-device driver (solves are
    # idempotent; restart = re-solve missing superblocks only).  In
    # multi-controller runs checkpoint_dir must be a SHARED filesystem --
    # every process must make the same skip decisions or the collectives
    # deadlock.
    ckpt = None
    if getattr(cfg, "checkpoint_dir", ""):
        from ..solvers.cd import _Checkpoint

        ckpt = _Checkpoint(cfg, train, n, imodel if use_warm else None,
                           extra=f"dist:{Bsup}".encode())

    total_err = total_obj = 0.0
    total_niters = 0
    coord_ids, target_ids, out_vals = [], [], []

    import time as _time

    nsup = (n_eff + Bsup - 1) // Bsup

    def dispatch(s0, blk):
        """Screen + compact + solve dispatch for one superblock; returns
        the pending record whose device outputs are fetched later."""
        _t0 = _time.perf_counter()
        nJ = min(Bsup, n_eff - s0)
        jarr = np.full(Bsup, npad - 1, dtype=np.int32)
        jarr[:nJ] = np.arange(s0, s0 + nJ, dtype=np.int32)
        caps = np.zeros(Bsup, dtype=np.int32)
        caps[:nJ] = caps_p[s0:s0 + nJ]

        flags_h, aty = flags_cb(jarr, nJ)
        _t_screen = _time.perf_counter()
        ids = np.nonzero(flags_h)[0]
        # S must contain the targets (the solve reads gj at the target's
        # compact position); the self column stays inactive via the mask
        ids = np.union1d(ids, jarr[:nJ]).astype(np.int64)
        K = min(bucket_npad(max(ids.size, 1)), npad)
        S = np.full(K, npad - 1, dtype=np.int32)
        S[:min(ids.size, K)] = ids[:K].astype(np.int32)
        S_dev = jax.device_put(S, repl)

        Gs, solve_fn = gs_cb(S, S_dev, K)

        x0_host = np.zeros((Bsup, K), np.float32)
        if use_warm:
            lookup = np.full(npad, -1, np.int64)
            lookup[S] = np.arange(K)
            for b in range(nJ):
                j = p[s0 + b]
                lo, hi = int(imodel_csc.indptr[j]), \
                    int(imodel_csc.indptr[j + 1])
                pos = lookup[posmap[imodel_csc.indices[lo:hi]]]
                ok = pos >= 0
                x0_host[b, pos[ok]] = imodel_csc.values()[lo:hi][ok]

        if aty is not None:
            # gjs = ATY[S, :].T for this block's columns
            gjs = jnp.take(aty, S_dev, axis=0).T          # (Bsup, K)
        else:
            # targets are members of S, so their Gram rows are columns of
            # the compact Gram: gjs[b] = G[S, j_b] = Gs[:, pos(j_b in S)]
            posj = np.minimum(np.searchsorted(S, jarr), K - 1)
            gjs = jnp.take(Gs, jnp.asarray(posj.astype(np.int32)),
                           axis=1).T                      # (Bsup, K)
        yty = jnp.take(diag_dev, jax.device_put(jarr, repl))
        # gjs/yty live replicated on device; device_put re-shards them
        # over the column grid without a host round trip
        x, niters, rstatus, rnorm, obj = solve_fn(
            Gs, jax.device_put(gjs, cols2_spec),
            jax.device_put(jarr, cols_spec),
            jax.device_put(caps, cols_spec),
            jax.device_put(x0_host, cols2_spec), S_dev,
            jax.device_put(yty, cols_spec),
            int(cfg.seed) + blk)
        logger.info("superblock %d/%d: K=%d screen %.2fs dispatched",
                    blk + 1, nsup, K, _t_screen - _t0)
        return (s0, blk, nJ, S, x, niters, rnorm, obj)

    def harvest(rec):
        """Fetch one pending superblock's outputs and assemble (overlaps
        the device executing the NEXT superblock's screen/gram/solve)."""
        s0, blk, nJ, S, x, niters, rnorm, obj = rec
        nonlocal total_err, total_obj, total_niters
        _t0 = _time.perf_counter()
        x_h, rnorm_h, obj_h, niters_h = _host_fetch_all(x, rnorm, obj,
                                                        niters)
        x_h = x_h[:nJ]
        st = np.stack([rnorm_h, obj_h,
                       niters_h.astype(np.float64)], axis=1)[:nJ]
        rows_b, cols_b = np.nonzero(np.abs(x_h) > EPSILON)
        vals_b = x_h[rows_b, cols_b].astype(np.float32)
        coords_perm = S[cols_b]
        keep = coords_perm < n
        blk_coord = p[coords_perm[keep]]
        blk_target = p[s0 + rows_b[keep]]
        blk_vals = vals_b[keep]
        blk_err = float(st[:, 0].sum())
        blk_obj = float(st[:, 1].sum())
        blk_nit = int(st[:, 2].sum())
        coord_ids.append(blk_coord)
        target_ids.append(blk_target)
        out_vals.append(blk_vals)
        total_err += blk_err
        total_obj += blk_obj
        total_niters += blk_nit
        if ckpt is not None:
            ckpt.save(blk, blk_coord, blk_target, blk_vals, blk_err,
                      blk_obj, blk_nit)
        logger.info("superblock %d/%d: fetch+harvest %.2fs", blk + 1, nsup,
                    _time.perf_counter() - _t0)

    # one-superblock lookahead: the device runs superblock k+1's
    # screen/gram/solve while the host fetches and assembles k's results
    # (the solve dispatch is async).  In multi-controller runs every
    # process executes the identical dispatch/harvest order, so the
    # collectives stay aligned.
    pending = None
    for s0 in range(0, n_eff, Bsup):
        blk = s0 // Bsup
        if ckpt is not None:
            hit = ckpt.load(blk)
            if hit is not None:
                if pending is not None:
                    harvest(pending)
                    pending = None
                coord, target, vals, err, obj_, nit = hit
                coord_ids.append(coord)
                target_ids.append(target)
                out_vals.append(vals)
                total_err += err
                total_obj += obj_
                total_niters += nit
                logger.info("superblock %d: resumed from checkpoint", blk + 1)
                continue
        rec = dispatch(s0, blk)
        if pending is not None:
            harvest(pending)
        pending = rec
    if pending is not None:
        harvest(pending)

    model = CSR.from_ijv(
        np.concatenate(coord_ids) if coord_ids else np.zeros(0, np.int32),
        np.concatenate(target_ids) if target_ids else np.zeros(0, np.int32),
        np.concatenate(out_vals) if out_vals else np.zeros(0, np.float32),
        nrows=n, ncols=n, no_duplicates=True)
    stats = {"loss": total_obj, "fit": total_err, "nnz": model.nnz,
             "niters": total_niters, "ndevices": ndev}
    return model, stats


def distributed_learn_blockwise(train: CSR, cfg, mesh: Mesh,
                                imodel: CSR | None = None,
                                row_block: int = 512):
    """Distributed CD learn for catalogues where G cannot be materialized.

    Per super-block of ndev·block_size item columns (frequency-rank
    order): a memory-bounded screen pass produces the union active set
    (flags only, accumulated over column chunks of at most SCREEN_BYTES;
    the targets' Gram rows come out of the compact Gram, so the screen
    ATY is never materialized at super-block width), one psum'd
    compact-Gram pass produces G[S, S], and the columns solve sharded
    over the grid -- exact SLIM/FSLIM semantics with per-block O(K²)
    memory instead of O(n²) anywhere (SURVEY §7 hard part #1).  FSLIM
    screens through the same memory-bounded chunks (per-chunk top-k is
    the global top-k; the solve re-derives each target's neighbour set
    inside the compact union), so FSLIM also runs at the 2M-item scale.
    Collective traffic per super-block: (npad, chunk)·nchunks + (K, K);
    peak per-device memory at the 2M-item north star is the
    (npad, chunk) screen buffer (~2GB) + G[S, S].
    """
    from ..solvers.cd import bucket_npad

    train = train.infer_ncols()
    n = train.ncols
    npad = bucket_npad(n)
    ndev = mesh.size
    Bsup = ndev * int(cfg.block_size)
    fslim_nnbrs = cfg.nnbrs if cfg.mtype in ("fslim", "ofslim") else 0

    nnz_col = train.col_nnz()
    col_caps = np.minimum(50 * nnz_col, cfg.maxniters).astype(np.int32)
    p = np.argsort(-nnz_col, kind="stable").astype(np.int32)
    posmap = np.empty(n, dtype=np.int32)
    posmap[p] = np.arange(n, dtype=np.int32)
    caps_p = col_caps[p]

    lr_d, cc_d, vv_d = _rank_triplets(train, mesh, row_block, npad, posmap)
    repl = NamedSharding(mesh, P(None))

    _, _, diag_fn, _ = _get_blockwise_fns(
        mesh, row_block, npad, Bsup, 1, float(cfg.l1r), float(cfg.l2r),
        float(cfg.optTol), cfg.shuffle, int(fslim_nnbrs), cfg.simtype)
    diag_dev = diag_fn(lr_d, cc_d, vv_d)
    screen_chunk = max(128, min(Bsup,
                                (_screen_bytes() // (npad * 4)) // 128 * 128))
    screen_flags_fn = _get_screen_flags(mesh, row_block, npad, screen_chunk,
                                        float(cfg.l1r), int(fslim_nnbrs),
                                        cfg.simtype)

    def flags_cb(jarr, nJ):
        # memory-bounded screen: union flags only, in column chunks of
        # (npad, chunk) -- ATY is never materialized at superblock width
        # (32GB at the 2M-item north star).  FSLIM takes the same chunked
        # path (its per-chunk top-k is exact; the solve re-derives each
        # target's top-nnbrs inside the compact union, see
        # fslim_active_mask's docstring) so its gjs also comes from the
        # compact Gram.
        flags_h = np.zeros(npad, bool)
        for c0 in range(0, nJ, screen_chunk):
            m = min(screen_chunk, nJ - c0)
            jc = np.full(screen_chunk, npad - 1, np.int32)
            jc[:m] = jarr[c0:c0 + m]
            fl = screen_flags_fn(lr_d, cc_d, vv_d, jax.device_put(jc, repl),
                                 diag_dev)
            flags_h |= _host_fetch(fl)
        return flags_h, None

    def gs_cb(S, S_dev, K):
        _, gramc_fn, _, solve_fn = _get_blockwise_fns(
            mesh, row_block, npad, Bsup, K, float(cfg.l1r), float(cfg.l2r),
            float(cfg.optTol), cfg.shuffle, int(fslim_nnbrs), cfg.simtype)
        return gramc_fn(lr_d, cc_d, vv_d, S_dev), solve_fn

    model, stats = _superblocks_solve(
        train, cfg, mesh, n, npad, Bsup, p, posmap, caps_p,
        int((nnz_col > 0).sum()), diag_dev, flags_cb, gs_cb, imodel,
        fslim_nnbrs)
    stats["mode"] = "blockwise"
    return model, stats


# --------------------------------------------------------------------- #
# resident column-sharded G mode (100k-500k items on many devices)
# --------------------------------------------------------------------- #
_gram_colblock_fns: dict = {}
_g_screen_fns: dict = {}
_g_gather_fns: dict = {}


def _get_gram_colblock(mesh: Mesh, rb: int, W_tot: int, width: int):
    """Jitted SPMD fn(lr, cc, vv, c0) -> G[:, c0:c0+width] row-sharded.
    Every device scatter-densifies its row blocks at full width and
    multiplies against the dynamic column slice; a
    reduce-scatter over item rows completes the column block, leaving
    tile G[rows_d, c0:c0+width] on device d (ring traffic ~(N-1)/N of
    one buffer, nothing replicated).  Called once per device column
    block at setup (total FLOPs = one full Gram, split over the grid);
    the caller reassembles COLUMN shards from the tiles by symmetry."""
    key = (mesh, rb, W_tot, width)
    fn = _gram_colblock_fns.get(key)
    if fn is None:
        def gramb(lr, cc, vv, c0):
            def body(g, xs):
                l, c, v = xs
                blk = jnp.zeros((rb, W_tot), jnp.float32)
                blk = blk.at[l, c].add(v, unique_indices=True, mode="drop")
                bc = jax.lax.dynamic_slice(blk, (0, c0), (rb, width))
                return g + jnp.dot(
                    blk.T, bc, preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST), None

            g0 = jnp.zeros((W_tot, width), jnp.float32)
            g, _ = jax.lax.scan(body, g0, (lr, cc, vv))
            return jax.lax.psum_scatter(g, ("dp", "mp"),
                                        scatter_dimension=0, tiled=True)

        spec = P(("dp", "mp"), None)
        fn = jax.jit(shard_map(
            gramb, mesh=mesh, in_specs=(spec, spec, spec, P()),
            out_specs=P(("dp", "mp"), None), check_vma=False))
        _gram_colblock_fns[key] = fn
    return fn


def _flat_index(mesh: Mesh):
    mp_size = mesh.shape["mp"]
    return lambda: (jax.lax.axis_index("dp") * mp_size
                    + jax.lax.axis_index("mp"))


def _get_g_screen(mesh: Mesh, W_tot: int, width: int, chunk: int,
                  l1r: float):
    """Union active flags for a chunk of target columns read straight out
    of the resident column-sharded G: the owner of each target column
    tests G[:, j] > l1r locally; an integer psum ORs the per-device
    flags."""
    key = (mesh, W_tot, width, chunk, l1r)
    fn = _g_screen_fns.get(key)
    if fn is None:
        fidx = _flat_index(mesh)

        def screen_g(gl, jc):
            c0 = fidx() * width
            pos = jc - c0
            valid = (pos >= 0) & (pos < width)
            cols = jnp.clip(pos, 0, width - 1)
            sub = jnp.take(gl, cols, axis=1)              # (W_tot, chunk)
            rows = jnp.arange(W_tot, dtype=jnp.int32)
            act = (sub > l1r) & valid[None, :] & \
                (rows[:, None] != jc[None, :])
            loc = jnp.any(act, axis=1).astype(jnp.int32)
            return jax.lax.psum(loc, ("dp", "mp")) > 0

        fn = jax.jit(shard_map(
            screen_g, mesh=mesh,
            in_specs=(P(None, ("dp", "mp")), P(None)),
            out_specs=P(None), check_vma=False))
        _g_screen_fns[key] = fn
    return fn


def _get_g_gather(mesh: Mesh, W_tot: int, width: int, K: int):
    """Compact Gram G[S, S] gathered from the resident column-sharded G:
    each device contributes the columns of S it owns (rows gathered
    first, so the peak intermediate is (K, width)); the psum assembles
    the replicated (K, K)."""
    key = (mesh, W_tot, width, K)
    fn = _g_gather_fns.get(key)
    if fn is None:
        fidx = _flat_index(mesh)

        def gather_g(gl, S):
            c0 = fidx() * width
            grows = jnp.take(gl, S, axis=0)               # (K, width)
            pos = S - c0
            valid = (pos >= 0) & (pos < width)
            cols = jnp.clip(pos, 0, width - 1)
            sub = jnp.take(grows, cols, axis=1)           # (K, K)
            return jax.lax.psum(
                jnp.where(valid[None, :], sub, 0.0), ("dp", "mp"))

        fn = jax.jit(shard_map(
            gather_g, mesh=mesh,
            in_specs=(P(None, ("dp", "mp")), P(None)),
            out_specs=P(None, None), check_vma=False))
        _g_gather_fns[key] = fn
    return fn


def distributed_learn_sharded_g(train: CSR, cfg, mesh: Mesh,
                                imodel: CSR | None = None,
                                row_block: int = 512):
    """Distributed CD learn with a RESIDENT column-sharded Gram.

    The middle regime between `distributed_learn` (replicated G, fine to
    ~100k items) and `distributed_learn_blockwise` (G never exists, no
    ceiling, but every superblock re-derives its Gram from the raw triplets):
    G is computed once, column-sharded over the grid (per-device memory =
    npad²·4/ndev -- ~5GB at 500k items on 64 devices), and every
    superblock's screen flags and compact Gram G[S, S] are *gathered*
    from it with one small psum each (ROADMAP #2's "column-shard G with
    explicit row exchange").  Solves and
    harvests share `_superblocks_solve` with the blockwise mode, so the
    result is exactly the single-device model.  FSLIM delegates to the
    blockwise path (its top-k screen needs ATY values, not flags).
    """
    from ..solvers.cd import bucket_npad

    if cfg.mtype in ("fslim", "ofslim"):
        return distributed_learn_blockwise(train, cfg, mesh, imodel,
                                           row_block)

    train = train.infer_ncols()
    n = train.ncols
    npad = bucket_npad(n)
    ndev = mesh.size
    Bsup = ndev * int(cfg.block_size)

    nnz_col = train.col_nnz()
    col_caps = np.minimum(50 * nnz_col, cfg.maxniters).astype(np.int32)
    p = np.argsort(-nnz_col, kind="stable").astype(np.int32)
    posmap = np.empty(n, dtype=np.int32)
    posmap[p] = np.arange(n, dtype=np.int32)
    caps_p = col_caps[p]

    lr_d, cc_d, vv_d = _rank_triplets(train, mesh, row_block, npad, posmap)
    repl = NamedSharding(mesh, P(None))

    _, _, diag_fn, _ = _get_blockwise_fns(
        mesh, row_block, npad, Bsup, 1, float(cfg.l1r), float(cfg.l2r),
        float(cfg.optTol), cfg.shuffle, 0, cfg.simtype)
    diag_dev = diag_fn(lr_d, cc_d, vv_d)

    # build the resident sharded G, one column block per device: call e
    # leaves tile G[rows_d, block_e] on device d (reduce-scatter over
    # rows); device d's COLUMN shard G[:, block_d] is the stack of its
    # tiles transposed -- G is symmetric, so G[block_e, block_d] =
    # G[block_d, block_e]^T (bitwise: both entries are the same
    # fixed-order contraction).  Nothing is ever replicated.
    W_tot = _round_up(npad, ndev)
    width = W_tot // ndev
    gramb_fn = _get_gram_colblock(mesh, row_block, W_tot, width)
    devs = list(mesh.devices.flat)
    tiles = [[None] * ndev for _ in range(ndev)]      # tiles[d][e]
    dev_pos = {d: i for i, d in enumerate(devs)}
    for e in range(ndev):
        ge = gramb_fn(lr_d, cc_d, vv_d, np.int32(e * width))
        for s in ge.addressable_shards:
            # row block d lives on flat-mesh device d by construction
            # (out_specs P(('dp','mp'), None)); derive the tile index
            # from the shard's device, not s.index -- jax reports a
            # replicated-looking index (start=None) in some
            # multi-platform environments
            tiles[dev_pos[s.device]][e] = s.data
    # each process assembles only the column shards of ITS devices (tile
    # d lives on device d, which this process fills for every e); on a
    # multi-controller mesh the remote tiles are simply not addressable
    my_proc = jax.process_index()
    shards = [jnp.concatenate([t.T for t in tiles[d]], axis=0)
              for d in range(ndev) if devs[d].process_index == my_proc]
    G_sh = jax.make_array_from_single_device_arrays(
        (W_tot, W_tot), NamedSharding(mesh, P(None, ("dp", "mp"))), shards)

    screen_chunk = max(128, min(Bsup,
                                (_screen_bytes() // (W_tot * 4)) // 128 * 128))
    screen_fn = _get_g_screen(mesh, W_tot, width, screen_chunk,
                              float(cfg.l1r))

    def flags_cb(jarr, nJ):
        flags_h = np.zeros(npad, bool)
        for c0 in range(0, nJ, screen_chunk):
            m = min(screen_chunk, nJ - c0)
            jc = np.full(screen_chunk, npad - 1, np.int32)
            jc[:m] = jarr[c0:c0 + m]
            fl = screen_fn(G_sh, jax.device_put(jc, repl))
            flags_h |= _host_fetch(fl)[:npad]
        return flags_h, None

    def gs_cb(S, S_dev, K):
        Gs = _get_g_gather(mesh, W_tot, width, K)(G_sh, S_dev)
        _, _, _, solve_fn = _get_blockwise_fns(
            mesh, row_block, npad, Bsup, K, float(cfg.l1r), float(cfg.l2r),
            float(cfg.optTol), cfg.shuffle, 0, cfg.simtype)
        return Gs, solve_fn

    model, stats = _superblocks_solve(
        train, cfg, mesh, n, npad, Bsup, p, posmap, caps_p,
        int((nnz_col > 0).sum()), diag_dev, flags_cb, gs_cb, imodel, 0)
    stats["mode"] = "sharded_g"
    return model, stats


# --------------------------------------------------------------------- #
# sharded predict
# --------------------------------------------------------------------- #
def make_sharded_predict(mesh: Mesh, nrcmds: int):
    """Users sharded over the flattened grid, W replicated; per-shard
    score + top-k (predict.c semantics, see slim_tpu.predict)."""

    def score(w, hidx, hval):
        # dense-history scatter + matrix product: no (U, H, npad) gather
        # intermediate (one power user's H would size the whole block)
        from ..predict import _hist_dense

        npad = w.shape[0]
        hd, mask = _hist_dense(npad, hidx, hval)
        scores = jnp.dot(hd, w, preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.HIGHEST)
        scores = jnp.where(mask, -jnp.inf, scores)
        ncand = jnp.sum(scores > 0, axis=1)
        top_sc, top_id = jax.lax.top_k(scores, nrcmds)
        counts = jnp.minimum(ncand, nrcmds).astype(jnp.int32)
        valid = jnp.arange(nrcmds)[None, :] < counts[:, None]
        return (jnp.where(valid, top_id, -1).astype(jnp.int32),
                jnp.where(valid, top_sc, 0.0), counts)

    fn = shard_map(
        score, mesh=mesh,
        in_specs=(P(None, None), P(("dp", "mp"), None), P(("dp", "mp"), None)),
        out_specs=(P(("dp", "mp"), None), P(("dp", "mp"), None),
                   P(("dp", "mp"))),
        check_vma=False)
    return jax.jit(fn)


def make_sharded_predict_coo(mesh: Mesh, nrcmds: int, npad: int, n: int):
    """Users sharded over the grid against a replicated padded-row sparse
    model: the COO segment-top-k block (predict._coo_topn_from_hist) runs
    purely locally per shard -- 2M-item catalogues servable on a mesh with
    nnz·8 model bytes per device and no npad-wide score rows."""
    from ..predict import _coo_topn_from_hist

    def score(wi, wv, hidx, hval):
        return _coo_topn_from_hist(wi, wv, hidx, hval, nrcmds, npad, n)

    fn = shard_map(
        score, mesh=mesh,
        in_specs=(P(None, None), P(None, None), P(("dp", "mp"), None),
                  P(("dp", "mp"), None)),
        out_specs=P(("dp", "mp"), None),
        check_vma=False)
    return jax.jit(fn)


def sharded_predict(model: CSR, hist: CSR, mesh: Mesh, nrcmds: int = 10):
    from ..predict import (COO_PREDICT_NPAD, _bucket, dense_predict_max_npad,
                           densify_model, sparsify_model_device)

    n = max(model.nrows, model.ncols, hist.ncols)
    ndev = mesh.size
    nusers = hist.nrows
    # dense replicated W is untenable above the sparse threshold; the COO
    # kernel serves everything beyond it (SLIM_PREDICT_COO_NPAD can lower
    # the cutover for testing; 0 disables the override, not the path --
    # there is no npad-wide sparse sharded alternative)
    coo = int(_os.environ.get("SLIM_PREDICT_COO_NPAD", COO_PREDICT_NPAD))
    dense_max = dense_predict_max_npad()
    cutover = min(dense_max, coo) if coo > 0 else dense_max
    use_coo = _bucket(n) > cutover
    npad = _bucket(n) if use_coo else _round_up(n + 1, 128)
    upad = _round_up(max(nusers, ndev), ndev)
    H = max(int(hist.row_nnz().max()) if nusers else 1, 1)
    hidx = np.full((upad, H), -1, np.int32)
    hval = np.zeros((upad, H), np.float32)
    hi, hv = hist.padded_rows(width=H)
    hidx[:nusers] = np.where(hi >= n, -1, hi)
    hval[:nusers] = hv if hist.data is not None else (hidx[:nusers] >= 0)

    spec = NamedSharding(mesh, P(("dp", "mp"), None))
    if use_coo:
        from ..predict import _coo_user_block

        Wi, Wv = sparsify_model_device(model, npad)
        repl2 = NamedSharding(mesh, P(None, None))
        Wi = jax.device_put(Wi, repl2)
        Wv = jax.device_put(Wv, repl2)
        fn = make_sharded_predict_coo(mesh, nrcmds, npad, n)
        # per-shard block bounded by the int32 sort key (ub·npad < 2^31)
        step = ndev * _coo_user_block(1024, npad)
        packs = []
        for u0 in range(0, upad, step):
            bi = np.full((step, H), -1, np.int32)
            bv = np.zeros((step, H), np.float32)
            u1 = min(u0 + step, upad)
            bi[:u1 - u0] = hidx[u0:u1]
            bv[:u1 - u0] = hval[u0:u1]
            packs.append(fn(Wi, Wv, jax.device_put(bi, spec),
                            jax.device_put(bv, spec)))
        from ..predict import _unpack_topn

        packed = np.concatenate([_host_fetch(o) for o in packs])[:nusers]
        return _unpack_topn(packed, nrcmds)
    W = densify_model(model, npad)
    fn = make_sharded_predict(mesh, nrcmds)
    ids, scores, counts = fn(W, jax.device_put(hidx, spec),
                             jax.device_put(hval, spec))
    return (_host_fetch(ids)[:nusers], _host_fetch(scores)[:nusers],
            _host_fetch(counts)[:nusers])
