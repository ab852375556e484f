"""Coordinate-descent model estimation (the default SLIM solver).

Device driver replacing src/libslim/estimate.c:328-558: instead of one
OpenMP thread per item column, item columns are processed in fixed-size
blocks; each block is solved by the batched CD solver against the shared
Gram matrix.  Columns are ordered by training nnz so blocks carry columns
with similar sweep caps (the batched analogue of ``schedule(dynamic,32)``
load balancing, estimate.c:402).

Covers: active-set screening (estimate.c:411-421), FSLIM neighbour
restriction (estimate.c:424-431 / neighbors.c), warm starting
(estimate.c:453-471), the adaptive per-column iteration cap
(estimate.c:448-449), residual/objective accounting (estimate.c:477-489),
and model assembly with the |x| > 1e-7 threshold (estimate.c:492-505,
EPSILON in def.h:14).
"""

from __future__ import annotations

import logging
import os

import numpy as np

from ..config import (SlimConfig, SLIM_DBG_INFO, SLIM_DBG_PROGRESS,
                      SLIM_DBG_TIME, dbg)
from ..ops.cd_kernel import (MAX_BLOCK, block_union_flags, block_union_mask,
                             block_union_masks_batched, cd_solve_block_compact,
                             cd_solve_block_ids, check_sweep_domain,
                             group_union_flags, sweep_impl)
from ..ops.cd_triton import BB
from ..ops.gram import compute_gram
from ..types import CSR

logger = logging.getLogger("slim_tpu")

EPSILON = 1e-7  # model nonzero threshold (reference def.h:14)


def bucket_npad(n: int) -> int:
    """Pad the coordinate dimension to a bucketed size ({256, 384, 512,
    768, 1024, ...}: powers of two plus 1.5x intermediates) so different
    datasets share compiled programs.

    Above 16384 the buckets step by 4096 instead: sweep cost grows with
    npad² so pow2 padding wastes up to 75% more FLOPs there (27278 items
    would pad to 32768 instead of 28672), while the per-dataset compile
    count stays small.  4096 is a multiple of CHUNK (128)."""
    m = 256
    while m + m // 2 < 16384:
        if n + 1 <= m:
            return m
        if n + 1 <= m + m // 2:
            return m + m // 2
        m *= 2
    if n + 1 <= 16384:
        return 16384
    return ((n + 1 + 4095) // 4096) * 4096


def _union_K(cnt: int, npad: int) -> int:
    """Compact width a block with a ``cnt``-wide union solves at."""
    K = min(bucket_npad(max(int(cnt), 1)), npad)
    # near-full unions solve full-width: the compact path gathers a
    # (K, npad) row slice + (K, K) sub-Gram INSIDE the launch (~5-6
    # GB of workspace at K=24576/npad=28672) for a sweep-cost saving
    # of only 1-(K/npad)^2 -- above the fraction the saving cannot
    # pay for the copies, and a grid point whose screen yields
    # several such blocks runs a small device out of memory
    # (observed: ML-20M mselect at l1r=4, unions 20480:1 24576:4
    # 28672:22)
    frac = float(os.environ.get("SLIM_COMPACT_FRAC", "0.75"))
    return npad if K > frac * npad else K


# Per-column sweep cost of a block twice as large at the same union width:
# on an H100 the Triton sweep took 106.03 ms per sweep at (1024, 28672)
# against 65.76 ms at (512, 28672), 0.81x per column.
_BLOCK_GAIN = 0.81


def _compact_block_size(g_dev, n, npad, B, bmax, l1r, step=1):
    """Block size of the compact screening path, chosen from the union
    widths.  Candidates: B/2, B and 2B (multiples of ``step``, at most
    ``bmax``).  A block of nJ columns at union width K costs about
    nJ·K² per sweep, and a block twice as large runs each column at
    ``_BLOCK_GAIN`` of the cost; the choice is the candidate with the
    least modelled cost, ties going to the larger block.  Unions that do
    not grow with the block (every union full width, as at ML-20M) take
    the largest candidate; unions that grow (a long catalogue tail) a
    smaller one.  On an H100 the 50k x 10k log learned in 4.6 / 5.7 /
    8.4 s at B = 256 / 512 / 1024 (Σ nJ·K²: 1 : 1.31 : 1.95), while
    ML-20M learned in 20.6 s at 1024 against 24.9 s at 512.

    Returns (B, union flags (nblocks, npad) on device)."""
    import jax.numpy as jnp

    Bc = min(B, bmax)
    cands = [c for c in ((Bc // 2,) if Bc % 2 == 0 else ()) + (Bc, 2 * Bc)
             if c <= bmax and c % step == 0]
    b0 = cands[0]
    u0 = block_union_flags(g_dev, (n + b0 - 1) // b0, b0, l1r)
    flags = {c: group_union_flags(u0, c // b0) for c in cands}
    counts = np.asarray(jnp.concatenate([flags[c][1] for c in cands]))
    work, off = {}, 0
    for c in cands:
        nb = (n + c - 1) // c
        nJ = np.minimum(c, n - c * np.arange(nb))
        K = np.array([_union_K(k, npad) for k in counts[off:off + nb]],
                     np.float64)
        work[c] = float(np.sum(nJ * K * K))
        off += nb
    best = min(cands, key=lambda c: (
        work[c] * _BLOCK_GAIN ** np.log2(c / b0), -c))
    return best, flags[best][0]


def estimate_grid_cd(train: CSR, cfg: SlimConfig, points):
    """Solve a whole (l1r, l2r) grid in one packed pass.

    Every (grid point, item column) pair becomes one batched column solve
    against the shared Gram -- the per-column regularisation support in
    the kernels makes the full hyper-parameter grid embarrassingly
    parallel (the reference can only walk points sequentially).  No warm starting (points solve
    independently): on a single chip the warm-started sequential walk in
    mselect.py is usually cheaper, but the packed form saturates large
    meshes/batches.

    Returns a list of (model, stats) aligned with ``points``.
    """
    import jax.numpy as jnp

    train = train.infer_ncols()
    n = train.ncols
    npad = bucket_npad(n)
    B = int(cfg.block_size)

    nnz_col = train.col_nnz()
    col_caps = np.minimum(50 * nnz_col, cfg.maxniters).astype(np.int32)
    p = np.argsort(-nnz_col, kind="stable").astype(np.int32)
    posmap = np.empty(n, dtype=np.int32)
    posmap[p] = np.arange(n, dtype=np.int32)

    train_p = CSR.from_arrays(train.nrows, n, train.indptr,
                              posmap[train.indices], train.data)
    g_dev = compute_gram(train_p, cfg.gram, pad_to=npad)
    caps_p = col_caps[p]

    impl, precision = sweep_impl(cfg.kernel)
    if impl == "triton":
        B = -(-B // BB) * BB
    check_sweep_domain(impl, B, npad)

    P = len(points)
    l1s = np.asarray([pt[0] for pt in points], dtype=np.float32)
    l2s = np.asarray([pt[1] for pt in points], dtype=np.float32)
    total = P * n  # virtual column v: point v // n, rank v % n

    fslim_nnbrs = cfg.nnbrs if cfg.mtype in ("fslim", "ofslim") else 0
    zeros_x0 = jnp.zeros((B, npad), dtype=jnp.float32)

    # incremental harvest with bounded in-flight blocks: holding every
    # (B, npad) solution on device and concatenating would materialize
    # P*n*npad*4 bytes (~26GB for a 16-point ML-20M-class grid); instead
    # each block's nonzeros are extracted as soon as
    # its solve completes, with one block of dispatch lookahead so the
    # device stays busy while the host harvests.
    tri = [([], [], []) for _ in range(P)]   # (coord, target, val) lists
    st_acc = np.zeros((P, 3), np.float64)    # (err, obj, niters) per point

    def harvest(v0, nv, out):
        x_h = np.asarray(out[0])[:nv, :n]
        st = np.stack([np.asarray(out[3]), np.asarray(out[4]),
                       np.asarray(out[1]).astype(np.float64)], axis=1)[:nv]
        vids = np.arange(v0, v0 + nv)
        ranks = (vids % n).astype(np.int64)
        pts = (vids // n).astype(np.int64)
        rr, cc = np.nonzero(np.abs(x_h) > EPSILON)
        for pt in np.unique(pts[rr]) if rr.size else []:
            sel = pts[rr] == pt
            tri[pt][0].append(p[cc[sel]])
            tri[pt][1].append(p[ranks[rr[sel]]])
            tri[pt][2].append(x_h[rr[sel], cc[sel]].astype(np.float32))
        np.add.at(st_acc, pts, st)

    pending = []
    for v0 in range(0, total, B):
        nv = min(B, total - v0)
        vids = np.arange(v0, v0 + nv)
        ranks = (vids % n).astype(np.int32)
        pts = (vids // n).astype(np.int32)
        Jpad = np.full(B, npad - 1, dtype=np.int32)
        Jpad[:nv] = ranks
        caps = np.zeros(B, dtype=np.int32)
        caps[:nv] = caps_p[ranks]
        l1b = np.zeros(B, dtype=np.float32)
        l2b = np.full(B, 1.0, dtype=np.float32)
        l1b[:nv] = l1s[pts]
        l2b[:nv] = l2s[pts]
        out = cd_solve_block_ids(
            g_dev, jnp.asarray(Jpad), jnp.asarray(caps), zeros_x0, n,
            jnp.asarray(l1b), jnp.asarray(l2b), float(cfg.optTol),
            int(cfg.seed) + v0, shuffle=cfg.shuffle,
            fslim_nnbrs=int(fslim_nnbrs), simtype=cfg.simtype, impl=impl,
            precision=precision)
        pending.append((v0, nv, out))
        if len(pending) > 2:
            harvest(*pending.pop(0))
    while pending:
        harvest(*pending.pop(0))

    results = []
    for pt in range(P):
        model = CSR.from_ijv(
            np.concatenate(tri[pt][0]) if tri[pt][0] else
            np.zeros(0, np.int32),
            np.concatenate(tri[pt][1]) if tri[pt][1] else
            np.zeros(0, np.int32),
            np.concatenate(tri[pt][2]) if tri[pt][2] else
            np.zeros(0, np.float32),
            nrows=n, ncols=n, no_duplicates=True)
        results.append((model, {
            "loss": float(st_acc[pt, 1]), "fit": float(st_acc[pt, 0]),
            "nnz": model.nnz, "niters": int(st_acc[pt, 2])}))
    return results


class _Checkpoint:
    """Per-block-group solve checkpointing (resume = skip solved blocks).

    Files are keyed by a signature over everything that affects a block's
    result (data identity + hyper-parameters + kernel order seed) so stale
    checkpoints from other runs can never be mixed in.
    """

    def __init__(self, cfg: SlimConfig, train: CSR, n: int,
                 imodel: CSR | None = None, extra: bytes = b""):
        import hashlib
        import os

        h = hashlib.sha256()
        # mode discriminator (e.g. distributed superblock width): the same
        # (data, cfg) under a different block decomposition must not share
        # checkpoint files
        h.update(extra)
        h.update(np.asarray([train.nrows, n, train.nnz]).tobytes())
        # hash the FULL arrays: sampling left >99.99% of a 34M-nnz matrix
        # unsampled, so a lightly edited dataset could silently resume
        # from stale blocks.  sha256 runs ~1GB/s -- a one-time ~0.2s at
        # ML-20M, negligible next to the solve it protects.
        h.update(np.ascontiguousarray(train.indptr).tobytes())
        h.update(np.ascontiguousarray(train.indices).tobytes())
        if train.data is not None:
            h.update(np.ascontiguousarray(train.data).tobytes())
        h.update(np.asarray([cfg.l1r, cfg.l2r, cfg.optTol]).tobytes())
        h.update(np.asarray([cfg.maxniters, cfg.nnbrs, cfg.ordered,
                             cfg.seed, cfg.block_size,
                             int(cfg.shuffle)]).tobytes())
        h.update(cfg.simtype.encode())
        # warm-start identity: a different -ipmdlfile changes every block's
        # result whenever columns stop at the sweep cap
        if imodel is None:
            h.update(b"none")
        else:
            h.update(np.asarray([imodel.nrows, imodel.ncols,
                                 imodel.nnz]).tobytes())
            h.update(np.ascontiguousarray(imodel.indices).tobytes())
            if imodel.data is not None:
                h.update(np.ascontiguousarray(imodel.data).tobytes())
        self.sig = h.hexdigest()[:16]
        self.dir = cfg.checkpoint_dir
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, blk: int) -> str:
        import os

        return os.path.join(self.dir, f"cdblk_{self.sig}_{blk}.npz")

    def load(self, blk: int):
        import os

        path = self._path(blk)
        if not os.path.exists(path):
            return None
        try:
            with np.load(path) as z:
                return (z["coord"], z["target"], z["vals"],
                        float(z["err"]), float(z["obj"]), int(z["nit"]))
        except Exception:
            return None

    def save(self, blk, coord, target, vals, err, obj, nit):
        path = self._path(blk)
        np.savez(path + ".tmp.npz", coord=coord, target=target, vals=vals,
                 err=err, obj=obj, nit=nit)
        import os

        os.replace(path + ".tmp.npz", path)


class _DeviceModelAccum:
    """Device-resident model retention (keep_device_model): keep the
    solver's flat harvest packs in device memory instead of a dense W.

    The packs are ~6 bytes/nnz (~0.2 GB at ML-20M), already exist on
    device (harvest builds them for the device-to-host fetch), and are
    target-rank-major -- exactly the layout
    :class:`slim_tpu.predict.DeviceModelPack` densifies lazily at predict
    time, when the learn working set (the Gram, the block workspace) is
    gone.  A dense (npad, npad) W held through the learn would sit next
    to the Gram for its whole duration.

    Coordinates are kept in RANK space (compact ids inflated through S
    on device); ``finalize`` concatenates the flat pieces (nnz-bucketed
    so mselect points share one densify executable) and computes the
    host run-start table."""

    def __init__(self, npad, n, p, posmap):
        self.npad, self.n = npad, n
        self.ok = True
        self._parts = {}     # blk -> (Tpad, c_host, fv, fi_rank)
        self._p_pad = np.concatenate(
            [p.astype(np.int64), np.arange(n, npad, dtype=np.int64)]) \
            .astype(np.uint16 if npad <= 65536 else np.int32)
        self._posmap_pad = np.concatenate(
            [posmap.astype(np.int64), np.arange(n, npad, dtype=np.int64)]) \
            .astype(np.int32)

    def add(self, blk, c, fv, fi, S_dev):
        """Retain block blk's pack: values (Tpad,), coords (Tpad,) in
        compact (S_dev not None) or rank space, c = per-target counts."""
        import jax.numpy as jnp

        if not self.ok:
            return
        try:
            rank = jnp.take(S_dev, fi).astype(fi.dtype) \
                if S_dev is not None else fi
            self._parts[blk] = (int(fv.shape[0]), c, fv, rank)
        except Exception as e:
            logger.warning("device-model retention dropped at block %d "
                           "(%s)", blk, str(e).splitlines()[0][:120])
            self.drop()

    def drop(self):
        self.ok = False
        self._parts = {}

    def finalize(self, nblocks, B):
        """Returns the lazily-densifiable DeviceModelPack, or None."""
        import jax.numpy as jnp

        from ..predict import DeviceModelPack
        from ..utils import nnz_bucket

        if not self.ok or len(self._parts) != nblocks:
            return None
        try:
            total = sum(self._parts[b][0] for b in range(nblocks))
            Tb = nnz_bucket(max(total, 1), floor=128)
            rs = np.full(self.npad, total, np.int32)
            rl = np.zeros(self.npad, np.int32)
            base = 0
            vs, ids = [], []
            for blk in range(nblocks):
                Tpad, c, fv, fi = self._parts[blk]
                r0 = blk * B
                nr = min(B, self.npad - r0)
                if nr > 0:
                    off = np.zeros(B, np.int32)
                    np.cumsum(c[:-1], out=off[1:])
                    rs[r0:r0 + nr] = base + off[:nr]
                    rl[r0:r0 + nr] = c[:nr]
                base += Tpad
                vs.append(fv)
                ids.append(fi)
            if Tb > total:
                vs.append(jnp.zeros(Tb - total, vs[0].dtype))
                ids.append(jnp.zeros(Tb - total, ids[0].dtype))
            pack = DeviceModelPack(jnp.concatenate(vs),
                                   jnp.concatenate(ids),
                                   rs, rl, self._p_pad,
                                   self._posmap_pad, self.n, self.npad)
            self._parts = {}
            return pack
        except Exception as e:
            logger.warning("device-model retention unavailable (%s); "
                           "predict will re-upload the model",
                           str(e).splitlines()[0][:120])
            self.drop()
            return None


def estimate_model_cd(train: CSR, cfg: SlimConfig, imodel: CSR | None = None,
                      gram=None, g_replicas=None, keep_device_model=False):
    """Estimate the SLIM/FSLIM model with batched coordinate descent.

    Returns ``(model, stats)`` where model is a CSR with rows = rated item,
    cols = target item (same orientation as the reference model,
    estimate.c:570-593) and stats carries loss/objective/nnz totals
    (printed by the reference at estimate.c:552-555).

    ``keep_device_model=True`` (single-device, no checkpoint restore):
    the flat harvest packs (~6 bytes/nnz of device memory) are retained
    and returned as ``stats["W_dev"]``, a lazily-densifiable
    :class:`slim_tpu.predict.DeviceModelPack` ready for
    ``predict_topn(..., W_dev=...)`` -- skipping the model re-upload an
    mselect evaluation or a train-then-serve flow otherwise pays.  Falls
    back silently (no ``W_dev`` key) when unavailable.

    ``g_replicas`` (multi-chip mode): per-device copies of the Gram in
    ORIGINAL item space (e.g. the addressable shards of a replicated
    psum-Gram).  Column blocks are dispatched round-robin across the
    replicas -- every device runs the same solver stack (union
    compaction, block solve, packed harvest) on its own blocks, which is
    the device form of the reference's ``omp for schedule(dynamic,32)``
    over columns (estimate.c:402).
    """
    import time as _time

    import jax
    import jax.numpy as jnp

    _t0 = _time.perf_counter()
    _marks = []
    # blocked-wait attribution inside the solve+harvest pipeline:
    # "solve-sync" = main thread blocked on a chunk's count fetch (device
    # still solving), "pack-fetch" = blocked on pack transfers (the
    # device-to-host copy the binding side).  Logged with the phase line
    # under DBG_TIME.
    _waits = {"solve-sync": 0.0, "pack-fetch": 0.0}

    def _mark(name):
        _marks.append((name, _time.perf_counter() - _t0))

    n = train.ncols
    npad = bucket_npad(n)
    B = int(cfg.block_size)

    if train.nnz == 0:
        # degenerate input: the model is empty and the objective zero
        # (the reference's screen finds no active columns anywhere)
        model = CSR.from_ijv(np.zeros(0, np.int32), np.zeros(0, np.int32),
                             np.zeros(0, np.float32), nrows=n, ncols=n,
                             no_duplicates=True)
        return model, {"loss": 0.0, "fit": 0.0, "ffrac": 0.0, "nnz": 0,
                       "niters": 0}

    # single-device fresh-Gram path: dispatch the Gram in ORIGINAL item
    # space immediately (upload + densify + contraction run async on
    # device) so it overlaps the host-side colcounts/relabel below; the
    # frequency permutation is then two exact device gathers (~20 ms at
    # ML-20M) instead of a host relabel on the Gram's critical path.
    g_raw = None
    if g_replicas is None and gram is None:
        g_raw = compute_gram(train, cfg.gram, pad_to=npad)

    nnz_col = train.col_nnz()
    col_caps = np.minimum(50 * nnz_col, cfg.maxniters).astype(np.int32)
    _mark("colcounts")

    # Frequency relabeling: solve in a permuted item space where rank r =
    # the r-th most-rated item.  Blocks become consecutive rank ranges
    # with homogeneous sweep caps (the batched analogue of the reference's
    # schedule(dynamic,32) load balancing), AND the active-set screen
    # (G[i,j] > l1r) concentrates in the low ranks -- popular items have
    # the largest Gram entries -- so the solver's chunk skipping removes
    # most of the padded coordinate space from every sweep.
    p = np.argsort(-nnz_col, kind="stable").astype(np.int32)  # rank -> item
    posmap = np.empty(n, dtype=np.int32)
    posmap[p] = np.arange(n, dtype=np.int32)

    g_all = None
    if g_replicas is not None:
        # multi-chip: permute each device's replica in place (two gathers
        # per device, dispatched async)
        p_pad = np.concatenate([p, np.arange(n, npad, dtype=np.int32)])
        g_all = []
        for g_r in g_replicas:
            dev = next(iter(g_r.devices()))
            p_d = jax.device_put(p_pad, dev)
            g_all.append(jnp.take(jnp.take(g_r, p_d, axis=0), p_d, axis=1))
        g_dev = g_all[0]
    elif gram is not None or g_raw is not None:
        # Gram in original item space (shared mselect Gram, or the
        # fresh async-dispatched one above): permute rows+cols on device
        # (two gathers), keeping the zero padding
        _mark("relabel")
        p_pad = np.concatenate([p, np.arange(n, npad, dtype=np.int32)])
        p_dev = jnp.asarray(p_pad)
        g_src = gram if gram is not None else g_raw
        g_dev = jnp.take(jnp.take(g_src, p_dev, axis=0), p_dev, axis=1)
        g_raw = None  # drop the unpermuted copy (frees its device memory)

    caps_p = col_caps[p]
    _mark("gram+setup")

    # warm start source: dense columns of imodel (estimate.c:453-464).
    # FSLIM ignores the warm start (the active-flag handshake in
    # estimate.c:455-463 only engages for the screening path).
    use_warm = imodel is not None and cfg.mtype in ("slim", "oslim")
    _imodel_csc = [None]

    def imodel_csc_get():
        # lazy: the CSC build (a 25-35M entry host sort at ML-20M) is
        # paid on the first warm-started block
        if _imodel_csc[0] is None and use_warm:
            _imodel_csc[0] = imodel.transpose()
        return _imodel_csc[0]

    fslim_nnbrs = cfg.nnbrs if cfg.mtype in ("fslim", "ofslim") else 0

    # Large catalogues: solve each block in its compacted union-active-set
    # space (per-sweep cost O(K²) instead of O(npad²); exact for both the
    # screening and FSLIM top-k active sets, see
    # ops/cd_kernel.block_union_mask).
    use_compact = npad > int(cfg.compact_threshold)

    impl, precision = sweep_impl(cfg.kernel)
    step = BB if impl == "triton" else 1   # whole kernel programs
    B = -(-B // step) * step
    if use_compact and fslim_nnbrs == 0:
        # screening unions: B from the union widths (larger blocks
        # amortise the per-block gathers and sweeps while the unions do
        # not grow with them); the cap per implementation is in
        # ops/cd_kernel.MAX_BLOCK
        B, u_dev = _compact_block_size(g_dev, n, npad, B, MAX_BLOCK[impl],
                                       float(cfg.l1r), step)
    elif use_compact:
        B = min(B, MAX_BLOCK[impl])

    nblocks = (n + B - 1) // B
    zeros_x0 = None if use_warm else jnp.zeros((B, npad), dtype=jnp.float32)

    # checkpoint/resume: column-block solves are idempotent, so crash
    # recovery = re-solving only the missing blocks (SURVEY.md §5: the
    # reference has no failure recovery at all; this is the natural
    # coarse-grained equivalent).  Blocks found on disk are skipped.
    ckpt = _Checkpoint(cfg, train, n, imodel if use_warm else None) \
        if cfg.checkpoint_dir else None

    def block_meta(blk):
        r0 = blk * B
        nJ = min(B, n - r0)
        Jpad = np.full(B, npad - 1, dtype=np.int32)  # pad -> zero column
        Jpad[:nJ] = np.arange(r0, r0 + nJ, dtype=np.int32)
        caps = np.zeros(B, dtype=np.int32)
        caps[:nJ] = caps_p[r0:r0 + nJ]
        return r0, nJ, Jpad, caps

    def warm_x0(r0, nJ):
        """Block x0 from the warm-start model's columns (estimate.c:453-464),
        built on the host and uploaded once per block."""
        imodel_csc = imodel_csc_get()
        x0_host = np.zeros((B, npad), dtype=np.float32)
        for b in range(nJ):
            j = p[r0 + b]  # original item of this rank
            s, e = int(imodel_csc.indptr[j]), int(imodel_csc.indptr[j + 1])
            x0_host[b, posmap[imodel_csc.indices[s:e]]] = \
                imodel_csc.values()[s:e]
        return jnp.asarray(x0_host)

    # phase 1 (compact only): union active sets for every block, counts
    # fetched in one transfer, K bucketed per block for compile reuse
    union_S = {}
    union_S_host = {}
    _s_resolver = []   # deferred compact-list fetch (see s_host_of)

    def s_host_of(blk):
        """Host copy of block ``blk``'s compact->original id map (assembly
        needs it to re-inflate coordinates).  Resolved lazily from the
        background fetch so the transfer overlaps the first solves."""
        if blk not in union_S_host and _s_resolver:
            _s_resolver.pop()()
        return union_S_host[blk]
    def union_K(cnt):
        return _union_K(cnt, npad)

    if use_compact and fslim_nnbrs > 0:
        j_all = np.stack([block_meta(blk)[2] for blk in range(nblocks)])
        S_all, counts = block_union_masks_batched(
            g_dev, jnp.asarray(j_all), float(cfg.l1r),
            fslim_nnbrs=int(fslim_nnbrs), simtype=cfg.simtype)
        counts_host = np.asarray(counts)
        # host copy: keeps the per-block S movable to any replica's device
        # and feeds the harvest's compact->rank index mapping
        S_host = np.asarray(S_all)
        for blk in range(nblocks):
            K = union_K(counts_host[blk])
            union_S[blk] = (K, jnp.asarray(S_host[blk, :K])
                            if g_all is not None else S_all[blk, :K])
            union_S_host[blk] = S_host[blk, :K]
    elif use_compact:
        # screening unions: one slice-reduce pass over G on device, then
        # the compacted per-block index lists are built ON DEVICE
        # (compact_union_ids) -- the host fetches only the (nblocks,)
        # counts (the first post-Gram sync, ~100 bytes; the round-3 path
        # fetched the whole (nblocks, npad) flag matrix, built the lists
        # on host and re-uploaded them) and slices each block's (K,) list
        # from the device-resident matrix.  The lists go to the host
        # once, in the background, only for the blocks that actually
        # solve compact (K < npad; at ML-20M every union is full-width
        # and nothing but the counts moves).
        from ..ops.cd_kernel import compact_union_ids

        s_dev, cnt_dev = compact_union_ids(u_dev)
        _mark("flags-dispatch")
        counts_h = np.asarray(cnt_dev)
        _mark("flags-fetch")
        if g_all is not None:
            # multi-chip replicated-G: the per-block S must be movable to
            # any replica's device, so route through the host as before
            s_all_h = np.asarray(s_dev)
            for blk in range(nblocks):
                K = union_K(counts_h[blk])
                union_S[blk] = (K, jnp.asarray(s_all_h[blk, :K]))
                union_S_host[blk] = s_all_h[blk, :K]
            need = []
        else:
            need = []
            for blk in range(nblocks):
                K = union_K(counts_h[blk])
                union_S[blk] = (K, s_dev[blk, :K])
                if K < npad:
                    need.append(blk)
        if need:
            # background d2h of the compact->original id maps the
            # assembly will need (overlaps the solves)
            from ..utils import submit_fetch as _sf

            Kmax = max(union_S[b][0] for b in need)
            _s_fut = _sf(jnp.take(
                s_dev, jnp.asarray(np.array(need, np.int32)), axis=0
            )[:, :Kmax])

            def _resolve_s_host(_fut=_s_fut, _need=tuple(need)):
                rows = _fut.result()[0]
                for i, b in enumerate(_need):
                    union_S_host[b] = rows[i, :union_S[b][0]]

            _s_resolver.append(_resolve_s_host)

    _mark("unions")
    if use_compact and dbg(cfg, SLIM_DBG_TIME):
        from collections import Counter

        hist = Counter(K for K, _ in union_S.values())
        logger.info("block %d, union widths: %s", B,
                    " ".join(f"{k}:{v}" for k, v in sorted(hist.items())))

    # phase 2+3: pipelined solve dispatch + harvest.  Solves are enqueued
    # one chunk of blocks ahead of the harvest, so chunk g's count fetch,
    # exact-size flat-pack transfer and host-side model assembly all
    # overlap the device solving chunk g+1 (the device work queue never
    # drains, and the harvest/assembly tail shrinks to the last chunk's).
    #
    # Harvest: exact-size device-side flat pack.  A concatenated count
    # fetch synchronizes the chunk's solves, then each block packs its
    # model entries into a (Tpad,) value + uint16/int32 coordinate pair
    # and the packs are fetched in a few concatenated transfers (grouped
    # by pow2 Tpad bucket, and by device in multi-chip mode) on a worker
    # thread.  The harvest moves exactly ~6 bytes per model nonzero -- no
    # width-K padding, no top-M overflow refetches.
    from collections import deque

    from ..ops.cd_kernel import count_over, pack_flat
    from ..utils import nnz_bucket, submit_fetch

    restored = {}
    total_err = total_obj = 0.0
    total_niters = 0
    coord_ids, target_ids, vals = [], [], []

    # device-model retention (see docstring): checkpoint-restored blocks
    # have no device copy, multi-chip blocks live on different devices --
    # both disable it
    keep_dev = bool(keep_device_model) and g_all is None and ckpt is None
    dev_acc = _DeviceModelAccum(npad, n, p, posmap) if keep_dev else None
    _sweeps = [0]   # Σ per-block max(niters): the device sweep-count proxy
    _blocks_by_dev = {}   # multi-device: solved blocks per device

    def dispatch_block(blk):
        """Enqueue one block's solve; returns (blk, nJ, out, S_host), or
        None when the block was restored from a checkpoint."""
        if ckpt is not None:
            rec = ckpt.load(blk)
            if rec is not None:
                restored[blk] = rec
                return None
        r0, nJ, Jpad, caps = block_meta(blk)
        x0 = warm_x0(r0, nJ) if use_warm else zeros_x0
        g_blk = g_all[blk % len(g_all)] if g_all is not None else g_dev

        if use_compact and union_S[blk][0] < npad:
            K, S = union_S[blk]
            x0s = jnp.take(x0, S, axis=1)

            check_sweep_domain(impl, B, K)
            out = cd_solve_block_compact(
                g_blk, S, jnp.asarray(Jpad), jnp.asarray(caps), x0s,
                float(cfg.l1r), float(cfg.l2r), float(cfg.optTol),
                int(cfg.seed) + blk, shuffle=cfg.shuffle, impl=impl,
                precision=precision, fslim_nnbrs=int(fslim_nnbrs),
                simtype=cfg.simtype)
            return (blk, nJ, out, s_host_of(blk))

        check_sweep_domain(impl, B, npad)
        out = cd_solve_block_ids(
            g_blk, jnp.asarray(Jpad), jnp.asarray(caps), x0, n,
            float(cfg.l1r), float(cfg.l2r), float(cfg.optTol),
            int(cfg.seed) + blk, shuffle=cfg.shuffle,
            fslim_nnbrs=int(fslim_nnbrs), simtype=cfg.simtype, impl=impl,
            precision=precision)
        return (blk, nJ, out, None)

    def harvest_chunk(records):
        """Synchronize a chunk's solves (count fetch), dispatch its flat
        packs and hand their transfers to the fetch worker.  Returns one
        pipeline state per device touched by the chunk."""
        states = []
        by_dev = {}
        for rec in records:
            dev = (next(iter(rec[2][0].devices()))
                   if g_all is not None else None)
            by_dev.setdefault(dev, []).append(rec)
        for dev, group in by_dev.items():
            if dev is not None:
                _blocks_by_dev[str(dev)] = \
                    _blocks_by_dev.get(str(dev), 0) + len(group)
            cnts_d = jnp.concatenate(
                [count_over(out[0], EPSILON) for _, _, out, _ in group])
            stats_d = jnp.concatenate(
                [jnp.stack([out[1].astype(jnp.float32),
                            out[2].astype(jnp.float32),
                            out[3], out[4]], axis=1)
                 for _, _, out, _ in group], axis=0)
            # every device->host transfer runs on the fetch worker thread
            _tw = _time.perf_counter()
            cnts, stats_all = submit_fetch(cnts_d, stats_d).result()
            _waits["solve-sync"] += _time.perf_counter() - _tw
            stats_all = stats_all.astype(np.float64)

            by_T = {}
            for k, (blk, nJ, out, S_h) in enumerate(group):
                c = cnts[k * B:(k + 1) * B].copy()
                c[nJ:] = 0                   # padded columns contribute 0
                off = np.zeros(B, np.int32)
                np.cumsum(c[:-1], out=off[1:])
                T = int(c.sum())
                # 1/8-octave bucket: pow2 padded the pack fetch by up to
                # 2x in d2h bytes right above a power of two
                Tpad = nnz_bucket(max(T, 1), floor=128)
                idx16 = int(out[0].shape[1]) <= 65536
                off_d = jnp.asarray(off) if dev is None \
                    else jax.device_put(off, dev)
                fv, fi = pack_flat(out[0], EPSILON, off_d, Tpad, idx16)
                if dev_acc is not None:
                    dev_acc.add(blk, c, fv, fi,
                                union_S[blk][1] if S_h is not None
                                else None)
                by_T.setdefault((Tpad, idx16), []).append(
                    (k, blk, nJ, S_h, c, T, fv, fi))

            buckets = list(by_T.items())
            conc = [(jnp.concatenate([b[6] for b in bl]),
                     jnp.concatenate([b[7] for b in bl]))
                    for _, bl in buckets]
            futs = [submit_fetch(va_d, ia_d) for (va_d, ia_d) in conc]
            states.append((futs, buckets, stats_all))
        return states

    def assemble_state(state):
        """Host-side model assembly for one fetched pipeline state."""
        futs, buckets, stats_all = state
        for fut, ((Tpad, idx16), bl) in zip(futs, buckets):
            _tw = _time.perf_counter()
            va, ia = fut.result()
            _waits["pack-fetch"] += _time.perf_counter() - _tw
            for i, (k, blk, nJ, S_h, c, T, _, _) in enumerate(bl):
                r0 = blk * B
                niters_h = stats_all[k * B:k * B + nJ, 0]
                rstatus_h = stats_all[k * B:k * B + nJ, 1]
                rnorm_h = stats_all[k * B:k * B + nJ, 2]
                obj_h = stats_all[k * B:k * B + nJ, 3]

                xvals = va[i * Tpad:i * Tpad + T]
                ix = ia[i * Tpad:i * Tpad + T].astype(np.int64)
                rows = np.repeat(np.arange(B, dtype=np.int32), c)
                coords_perm = S_h[ix] if S_h is not None else ix
                keep = coords_perm < n
                rows, coords_perm = rows[keep], coords_perm[keep]
                blk_coord = p[coords_perm]           # permuted -> original
                blk_target = p[r0 + rows]
                blk_vals = xvals[keep].astype(np.float32)
                blk_err = float(rnorm_h.sum())
                blk_obj = float(obj_h.sum())
                blk_nit = int(niters_h.sum())
                # launch sweep count ~ the slowest column's live sweeps
                _sweeps[0] += int(niters_h.max()) if nJ else 0

                if ckpt is not None:
                    ckpt.save(blk, blk_coord, blk_target, blk_vals,
                              blk_err, blk_obj, blk_nit)
                restored[blk] = (blk_coord, blk_target, blk_vals,
                                 blk_err, blk_obj, blk_nit)

                if dbg(cfg, SLIM_DBG_PROGRESS):
                    for b in range(nJ):
                        j = p[r0 + b]
                        logger.info(
                            "Col: %5d %5d rs: %d nits: %4d nnz: %4d "
                            "rsd: %.2e obj: %.2e", j, int(nnz_col[j]),
                            int(rstatus_h[b]), int(niters_h[b]),
                            int(c[b]), rnorm_h[b], obj_h[b])

    # pipeline: dispatch chunk g, harvest chunk g-1 (waits only on its
    # own solves -- chunk g is already queued behind them), assemble any
    # chunk whose transfers completed.  SLIM_HARVEST_CHUNK=0 restores the
    # unpipelined dispatch-all-then-harvest behaviour.
    hchunk = int(os.environ.get("SLIM_HARVEST_CHUNK", "8"))
    if hchunk <= 0 or g_all is not None:
        # multi-chip: blocks round-robin the replicas, so chunking by
        # dispatch order would serialize the devices; harvest everything
        # at once, split by device inside harvest_chunk
        hchunk = nblocks
    chunk_starts = range(0, nblocks, max(hchunk, 1))
    pendq = deque()      # dispatched chunks awaiting their count fetch
    inflight = deque()   # harvest states with transfers in the worker
    for c0 in chunk_starts:
        recs = [r for r in (dispatch_block(b)
                            for b in range(c0,
                                           min(c0 + hchunk, nblocks)))
                if r is not None]
        pendq.append(recs)
        if len(pendq) >= 2:
            inflight.extend(harvest_chunk(pendq.popleft()))
        while inflight and all(f.done() for f in inflight[0][0]):
            assemble_state(inflight.popleft())
    while pendq:
        inflight.extend(harvest_chunk(pendq.popleft()))
    while inflight:
        assemble_state(inflight.popleft())

    for blk in range(nblocks):
        blk_coord, blk_target, blk_vals, blk_err, blk_obj, blk_nit = \
            restored[blk]
        coord_ids.append(blk_coord)
        target_ids.append(blk_target)
        vals.append(blk_vals)
        total_err += blk_err
        total_obj += blk_obj
        total_niters += blk_nit

    _mark("solve+harvest")

    # assemble the model CSR (SaveModel, estimate.c:570-593).  The native
    # threaded counting sort builds straight from the per-block fragments
    # (no 34M-entry concatenates, no scipy coo->csr pass: ~6 s -> ~1 s at
    # the ML-20M model); harvest guarantees unique (coord, target) pairs.
    from .. import native

    built = native.csr_from_blocks(coord_ids, target_ids, vals, n) \
        if native.available() and \
        os.environ.get("SLIM_NATIVE_ASSEMBLY", "1") != "0" else None
    if built is not None:
        indptr_b, indices_b, data_b = built
        model = CSR.from_arrays(n, n, indptr_b, indices_b, data_b)
    else:
        model = CSR.from_ijv(
            np.concatenate(coord_ids) if coord_ids
            else np.zeros(0, np.int32),
            np.concatenate(target_ids) if target_ids
            else np.zeros(0, np.int32),
            np.concatenate(vals) if vals else np.zeros(0, np.float32),
            nrows=n, ncols=n, no_duplicates=True)

    stats = {
        "loss": total_obj,
        "fit": total_err,
        "ffrac": total_err / total_obj if total_obj else 0.0,
        "nnz": model.nnz,
        "niters": total_niters,
        "sweeps": _sweeps[0],
        "block_size": B,
    }
    if _blocks_by_dev:
        stats["blocks_by_device"] = _blocks_by_dev
    if dev_acc is not None:
        W_dev = dev_acc.finalize(nblocks, B)
        if W_dev is not None:
            stats["W_dev"] = W_dev
    _mark("assembly")
    if dbg(cfg, SLIM_DBG_TIME):
        prev = 0.0
        parts = []
        for name, tm in _marks:
            parts.append(f"{name} {tm - prev:.2f}s")
            prev = tm
        parts.append("[waits: " + " ".join(
            f"{k} {v:.2f}s" for k, v in _waits.items()) + "]")
        logger.info("cd phases: %s", "  ".join(parts))
    if dbg(cfg, SLIM_DBG_INFO):
        logger.info(
            "Done estimation: loss: %.5e, fit: %.5e, ffrac: %.3f,  #nzs: %d",
            stats["loss"], stats["fit"], stats["ffrac"], stats["nnz"])
    return model, stats
