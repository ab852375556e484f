"""Model selection: hyper-parameter sweeps with warm starting.

Covers both reference drivers:

* ``mselect_pairs`` -- explicit (l1,l2) pair list, the CLI behaviour
  (src/programs/slim_mselect.c:99-203);
* ``mselect_grid``  -- full nl1 × nl2 cross product with best-by-HR and
  best-by-ARHR tracking, the Python behaviour (pyapi.c:214-412; the Python
  wrapper sorts both arrays ascending first, core.py:496-497, so the warm
  start walks the regularisation path).

Wins over the reference: the Gram matrix is computed **once**
and shared by every grid point (the reference re-runs the full
O(ncols·nnz) screening per point), and prediction/eval run batched on
device.
"""

from __future__ import annotations

import logging
import time

import numpy as np

from .config import SlimConfig
from .eval import determine_head_tail, evaluate_topn
from .ops.gram import compute_gram
from .predict import densify_model, predict_topn
from .solvers.cd import estimate_model_cd
from .solvers.admm import estimate_model_admm
from .types import CSR

logger = logging.getLogger("slim_tpu")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _learn_with_gram(train, cfg, imodel, gram, g_replicas=None,
                     keep_device_model=False):
    if cfg.algo == "cd":
        return estimate_model_cd(train, cfg, imodel=imodel, gram=gram,
                                 g_replicas=g_replicas,
                                 keep_device_model=keep_device_model)
    return estimate_model_admm(train, cfg, imodel=imodel, gram=gram)


def _eval_point(model, train, test, fmarker, nrcmds, W_dev=None):
    """Returns (eval record, predict seconds, metric seconds) -- the
    per-point timing split feeds the warm-sweep attribution log.
    ``W_dev``: device-resident dense model retained by the solver
    (skips the model re-upload per point)."""
    t0 = time.perf_counter()
    ids, _, counts = predict_topn(model, train, nrcmds=nrcmds, W_dev=W_dev)
    t_pred = time.perf_counter() - t0
    t0 = time.perf_counter()
    ev = evaluate_topn(ids, counts, test, fmarker, require_test_items=True)
    return ev, t_pred, time.perf_counter() - t0


def mselect_core(train: CSR, test: CSR, cfg: SlimConfig, points,
                 keep_models: bool = False, point_callback=None,
                 mesh=None):
    """Walk ``points`` = [(l1, l2), ...] with warm starts; returns the
    per-point results plus the best-by-HR / best-by-ARHR summaries.

    ``mesh``: a jax.sharding.Mesh runs every point's solves distributed
    (the psum'd sparse Gram is computed ONCE and its per-device replicas
    are shared by the whole sweep, like the single-device Gram reuse);
    warm starting across points is preserved.  CD only -- the ADMM sweep
    is a dense single-device program."""
    train = train.infer_ncols()
    test = test.infer_ncols()
    # align column spaces (slim_mselect.c:52-54, pyapi.c:256-258)
    ncols = max(train.ncols, test.ncols)
    train = train.with_ncols(ncols)
    test = test.with_ncols(ncols)

    fmarker = determine_head_tail(train, ncols)

    from .solvers.cd import bucket_npad
    npad = bucket_npad(ncols)
    g_replicas = None
    if mesh is not None:
        if cfg.algo != "cd":
            raise ValueError("mesh-distributed mselect supports algo='cd'")
        from .parallel.dist import sharded_gram_sparse

        g = sharded_gram_sparse(train, mesh, pad_to=npad)
        g_replicas = [s.data for s in g.addressable_shards]
        gram = None
    else:
        gram = compute_gram(train, cfg.gram, pad_to=npad)

    results = []
    model = None
    best = {"bestl1HR": 0.0, "bestl2HR": 0.0, "bestHRHR": 0.0, "bestARHR": 0.0,
            "bestl1AR": 0.0, "bestl2AR": 0.0, "bestHRAR": 0.0, "bestARAR": 0.0,
            "best_model_hr": None, "best_model_ar": None}

    # device-model retention pays when the eval predicts on the device
    # dense path (mid-size catalogues): the solver keeps W in device
    # memory and the per-point model upload disappears
    from .predict import NATIVE_PREDICT_NPAD, dense_predict_max_npad
    keep_dev = (mesh is None and cfg.algo == "cd"
                and NATIVE_PREDICT_NPAD < npad <= dense_predict_max_npad())

    for (l1, l2) in points:
        pcfg = cfg.replace(l1r=float(l1), l2r=float(l2))
        t0 = time.perf_counter()
        imodel = model
        model, stats = _learn_with_gram(train, pcfg, imodel, gram,
                                        g_replicas=g_replicas,
                                        keep_device_model=keep_dev)
        t_learn = time.perf_counter() - t0

        # the retained pack serves this point's evaluation
        pack = stats.pop("W_dev", None)
        ev, t_pred, t_metric = _eval_point(model, train, test, fmarker,
                                           cfg.nrcmds, W_dev=pack)
        if pack is not None:
            pack.free()
        rec = {"l1r": float(l1), "l2r": float(l2), "nnz": model.nnz,
               "hr": ev.hr, "hr_head": ev.hr_head, "hr_tail": ev.hr_tail,
               "arhr": ev.arhr, "time": t_learn, "time_kind": "per_point",
               "time_predict": t_pred, "time_metric": t_metric,
               "nvalid": ev.nvalid, "nvalid_head": ev.nvalid_head,
               "nvalid_tail": ev.nvalid_tail}
        if keep_models:
            rec["model"] = model
        results.append(rec)
        logger.info(
            "l1r: %.2e l2r: %.2e nnz: %7d hr: %.4f hr_head: %.4f "
            "hr_tail: %.4f arhr: %.4f time: %.2f (learn %.2f + predict "
            "%.2f + metrics %.2f)",
            l1, l2, model.nnz, ev.hr, ev.hr_head, ev.hr_tail, ev.arhr,
            t_learn + t_pred + t_metric, t_learn, t_pred, t_metric)
        if point_callback is not None:
            point_callback(rec, model)

        if ev.hr > best["bestHRHR"]:
            best.update(bestHRHR=ev.hr, bestARHR=ev.arhr,
                        bestl1HR=float(l1), bestl2HR=float(l2),
                        best_model_hr=model)
        if ev.arhr > best["bestARAR"]:
            best.update(bestHRAR=ev.hr, bestARAR=ev.arhr,
                        bestl1AR=float(l1), bestl2AR=float(l2),
                        best_model_ar=model)

    best["results"] = results
    return best


def mselect_pairs(train: CSR, test: CSR, cfg: SlimConfig, pairs,
                  point_callback=None, mesh=None):
    """CLI-style sweep over an explicit pair list (slim_mselect.c:99-203)."""
    return mselect_core(train, test, cfg, pairs,
                        point_callback=point_callback, mesh=mesh)


def mselect_grid(train: CSR, test: CSR, cfg: SlimConfig, arrayl1, arrayl2,
                 parallel: bool = False, mesh=None):
    """Python-package-style full cross product (pyapi.c:286-399): the inner
    loop walks l2 for each l1, warm-starting from the previous model.

    ``parallel=True`` solves the whole grid in one packed pass (per-column
    regularisation in the kernels; every (point, column) pair is one
    batched solve).  No warm starts in that mode -- it trades extra sweeps
    for full grid parallelism, the right choice on large meshes.
    """
    points = [(l1, l2) for l1 in arrayl1 for l2 in arrayl2]
    if not parallel:
        return mselect_core(train, test, cfg, points, mesh=mesh)

    from .solvers.cd import estimate_grid_cd

    train = train.infer_ncols()
    test = test.infer_ncols()
    ncols = max(train.ncols, test.ncols)
    train = train.with_ncols(ncols)
    test = test.with_ncols(ncols)
    fmarker = determine_head_tail(train, ncols)

    t0 = time.time()
    solved = estimate_grid_cd(train, cfg, points)
    t_solve = time.time() - t0

    results = []
    best = {"bestl1HR": 0.0, "bestl2HR": 0.0, "bestHRHR": 0.0, "bestARHR": 0.0,
            "bestl1AR": 0.0, "bestl2AR": 0.0, "bestHRAR": 0.0, "bestARAR": 0.0,
            "best_model_hr": None, "best_model_ar": None}
    for (l1, l2), (model, stats) in zip(points, solved):
        ev, _, _ = _eval_point(model, train, test, fmarker, cfg.nrcmds)
        rec = {"l1r": float(l1), "l2r": float(l2), "nnz": model.nnz,
               "hr": ev.hr, "hr_head": ev.hr_head, "hr_tail": ev.hr_tail,
               # the packed pass solves every point in ONE batched program:
               # per-point time is not observable, so report the grid
               # average and say so (sequential mode reports honest
               # per-point times with time_kind="per_point")
               "arhr": ev.arhr, "time": t_solve / max(len(points), 1),
               "time_kind": "grid_average",
               "nvalid": ev.nvalid, "nvalid_head": ev.nvalid_head,
               "nvalid_tail": ev.nvalid_tail}
        results.append(rec)
        if ev.hr > best["bestHRHR"]:
            best.update(bestHRHR=ev.hr, bestARHR=ev.arhr,
                        bestl1HR=float(l1), bestl2HR=float(l2),
                        best_model_hr=model)
        if ev.arhr > best["bestARAR"]:
            best.update(bestHRAR=ev.hr, bestARAR=ev.arhr,
                        bestl1AR=float(l1), bestl2AR=float(l2),
                        best_model_ar=model)
    best["results"] = results
    best["grid_time"] = t_solve
    return best
