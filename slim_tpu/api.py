"""User-facing API: functional ``learn``/``get_topn`` plus the class-based
``SLIM``/``SLIMatrix`` interface mirroring the reference Python package
(python-package/SLIM/core.py:245-681).

The functional layer is the equivalent of the C API (include/slim.h:79-167):
``learn`` = SLIM_Learn, ``get_topn`` = SLIM_GetTopN, ``write_model`` /
``read_model`` = SLIM_WriteModel/ReadModel.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np

from .config import SlimConfig, SLIM_DBG_INFO, SLIM_DBG_TIME, dbg
from .eval import determine_head_tail, evaluate_topn
from .io.readers import read_binrow, write_binrow
from .predict import densify_model, predict_topn, predict_topn_1vsk
from .solvers.admm import estimate_model_admm
from .solvers.cd import estimate_model_cd
from .types import CSR

logger = logging.getLogger("slim_tpu")

__all__ = ["learn", "get_topn", "write_model", "read_model", "SLIM",
           "SLIMatrix"]


def setup_training_matrix(train: CSR) -> CSR:
    """Training-matrix setup (CreateTrainingMatrix, setup.c:109-135):
    infer ncols from the max column index, build the CSC view and column
    norms (both lazy on CSR)."""
    return train.infer_ncols()


def learn(train: CSR, cfg: Optional[SlimConfig] = None,
          imodel: Optional[CSR] = None, gram=None,
          keep_device_model: bool = False):
    """Estimate a SLIM model.  Returns (model CSR, stats dict).

    Equivalent of SLIM_Learn (api.c:33-96): setup + dispatch to the CD or
    ADMM solver, with wall-clock phase timers under dbglvl & TIME.

    ``keep_device_model=True`` (CD, single device): ``stats["W_dev"]``
    carries the dense device-resident model for an immediate
    ``predict_topn(..., W_dev=...)`` -- the train-then-serve flow skips
    the ~6 bytes/nnz model re-upload.
    """
    from .utils import enable_compilation_cache

    enable_compilation_cache()
    if isinstance(cfg, dict):
        cfg = SlimConfig.from_dict(cfg)
    cfg = cfg or SlimConfig()
    t_total = time.perf_counter()
    tmat = setup_training_matrix(train)
    t_setup = time.perf_counter() - t_total

    t_learn = time.perf_counter()

    def _run():
        if cfg.algo == "cd":
            return estimate_model_cd(tmat, cfg, imodel=imodel, gram=gram,
                                     keep_device_model=keep_device_model)
        if cfg.algo == "admm":
            return estimate_model_admm(tmat, cfg, imodel=imodel, gram=gram)
        raise ValueError(f"unsupported algo {cfg.algo!r}")

    if cfg.profile_dir:
        # device+host trace for xprof/tensorboard (the device-level
        # upgrade of the reference's wall-clock-only timers,
        # timing.c:27-45)
        import jax

        with jax.profiler.trace(cfg.profile_dir):
            model, stats = _run()
    else:
        model, stats = _run()
    t_learn = time.perf_counter() - t_learn
    t_total = time.perf_counter() - t_total

    stats = dict(stats)
    stats.update(setup_s=t_setup, learn_s=t_learn, total_s=t_total)
    if dbg(cfg, SLIM_DBG_TIME):
        logger.info("Timing: total %.3fs setup %.3fs learn %.3fs",
                    t_total, t_setup, t_learn)
    return model, stats


def get_topn(model: CSR, hist: CSR, nrcmds: int = 10, W_dev=None):
    """Top-N for every user row of ``hist`` (SLIM_GetTopN batched over
    users, api.c:111-141)."""
    return predict_topn(model, hist, nrcmds=nrcmds, W_dev=W_dev)


def write_model(model: CSR, path: str) -> None:
    """SLIM_WriteModel equivalent (binary row format, api.c:174-177)."""
    write_binrow(model, path)


def read_model(path: str) -> CSR:
    """SLIM_ReadModel equivalent (api.c:187-194)."""
    return read_binrow(path)


# --------------------------------------------------------------------- #
# class-based interface (python-package parity)
# --------------------------------------------------------------------- #
class SLIMatrix:
    """User-item matrix with id maps (core.py:245-385).

    Accepts a scipy csr_matrix, a slim_tpu CSR, a 2-D array / list of
    (user, item, rating) triplets, or a pandas DataFrame with the same
    columns; ``oldmat`` aligns the id maps to an existing SLIMatrix or a
    trained SLIM model (core.py:289-351).
    """

    def __init__(self, data, oldmat=None):
        try:
            import scipy.sparse as sp
            is_scipy = sp.issparse(data)
        except ImportError:
            is_scipy = False

        if isinstance(data, CSR):
            self._init_identity_maps(data)
        elif is_scipy:
            self._init_identity_maps(CSR.from_scipy(data))
            if oldmat is not None:
                n_old = (oldmat.nItems if isinstance(oldmat, SLIMatrix)
                         else len(oldmat.id2item))
                if self.nItems != n_old:
                    raise TypeError("The size of the input matrix does not "
                                    "match the size of oldmat.")
        else:
            try:
                from pandas import DataFrame
                if isinstance(data, DataFrame):
                    data = data.values
            except ImportError:
                pass
            if not isinstance(data, (list, np.ndarray)):
                raise TypeError(
                    f"Input data type {type(data).__name__} is not supported.")
            self._init_from_triplets(np.asarray(data), oldmat)

    def _init_identity_maps(self, mat: CSR):
        self.mat = mat
        self.nUsers, self.nItems = mat.shape
        self.id2item = np.arange(self.nItems)
        self.item2id = {i: i for i in range(self.nItems)}
        self.id2user = np.arange(self.nUsers)
        self.user2id = {u: u for u in range(self.nUsers)}

    def _init_from_triplets(self, data, oldmat):
        if oldmat is not None:
            if isinstance(oldmat, SLIMatrix):
                self.id2item = np.array(oldmat.id2item).copy()
                self.item2id = dict(oldmat.item2id)
                self.id2user = np.array(oldmat.id2user).copy()
                self.user2id = dict(oldmat.user2id)
            elif isinstance(oldmat, SLIM):
                self.id2item = np.array(oldmat.id2item).copy()
                self.item2id = dict(oldmat.item2id)
                self.user2id, self.id2user = {}, []
                for tri in data:
                    if tri[0] not in self.user2id:
                        self.user2id[tri[0]] = len(self.id2user)
                        self.id2user.append(tri[0])
                self.id2user = np.array(self.id2user)
            else:
                raise TypeError("oldmat must be a SLIMatrix or SLIM model")
        else:
            self.item2id, id2item = {}, []
            self.user2id, id2user = {}, []
            for tri in data:
                if tri[0] not in self.user2id:
                    self.user2id[tri[0]] = len(id2user)
                    id2user.append(tri[0])
                if tri[1] not in self.item2id:
                    self.item2id[tri[1]] = len(id2item)
                    id2item.append(tri[1])
            self.id2item = np.array(id2item)
            self.id2user = np.array(id2user)

        rows, cols, vals, miss = [], [], [], 0
        for tri in data:
            if tri[0] in self.user2id and tri[1] in self.item2id:
                rows.append(self.user2id[tri[0]])
                cols.append(self.item2id[tri[1]])
                vals.append(float(tri[2]))
            else:
                miss += 1
        if miss:
            logger.warning("%d of the events fall out of the range of oldmat. "
                           "Partial entries collected.", miss)
        self.nUsers = len(self.id2user)
        self.nItems = len(self.id2item)
        self.mat = CSR.from_ijv(np.array(rows, np.int64),
                                np.array(cols, np.int64),
                                np.array(vals, np.float32),
                                nrows=self.nUsers, ncols=self.nItems)


class SLIM:
    """Trained SLIM model with train/mselect/predict/save/load (core.py:
    388-681)."""

    def __init__(self):
        self.model: Optional[CSR] = None
        self.stats = None
        self.nItems = 0
        self.id2item = None
        self.item2id = None
        self._W_dev = None

    # ------------------------------------------------------------------ #
    def train(self, params, data: SLIMatrix):
        if not isinstance(data, SLIMatrix):
            raise TypeError("trndata must be a SLIMatrix object.")
        cfg = params if isinstance(params, SlimConfig) else \
            SlimConfig.from_dict(params)
        self.nItems = data.nItems
        start = time.time()
        train_mat = data.mat.with_ncols(max(data.mat.ncols, data.nItems))
        # retain the solved model on device when predict would serve from
        # the dense device path anyway: train-then-predict skips the
        # ~6 bytes/nnz model re-upload
        from .predict import (NATIVE_PREDICT_NPAD, _bucket,
                              dense_predict_max_npad)
        npad = _bucket(max(train_mat.ncols, train_mat.infer_ncols().ncols, 1))
        keep = (cfg.algo == "cd"
                and NATIVE_PREDICT_NPAD < npad <= dense_predict_max_npad())
        self.model, self.stats = learn(train_mat, cfg,
                                       keep_device_model=keep)
        self.id2item = np.array(data.id2item).copy()
        self.item2id = dict(data.item2id) if isinstance(data.item2id, dict) \
            else np.array(data.item2id).copy()
        self._W_dev = self.stats.pop("W_dev", None)
        logger.info("Learning takes %.3f secs.", time.time() - start)

    # ------------------------------------------------------------------ #
    def mselect(self, params, trndata: SLIMatrix, tstdata: SLIMatrix,
                arrayl1, arrayl2, nrcmds: int = 10, parallel: bool = False):
        """Grid search over the l1×l2 cross product with warm starts
        (Py_SLIM_Mselect, pyapi.c:214-412).  Trains on the best-HR config
        and keeps that model.  Returns the result dict.

        ``parallel=True`` solves every grid point in one batched pass
        (per-column regularisation in the kernels) instead of the
        warm-started walk -- an extension, see mselect_grid."""
        from .mselect import mselect_grid

        cfg = params if isinstance(params, SlimConfig) else \
            SlimConfig.from_dict(params)
        cfg = cfg.replace(nrcmds=nrcmds)
        res = mselect_grid(trndata.mat, tstdata.mat, cfg,
                           sorted(arrayl1), sorted(arrayl2),
                           parallel=parallel)
        self.model = res["best_model_hr"]
        self.stats = None
        self.nItems = trndata.nItems
        self.id2item = np.array(trndata.id2item).copy()
        self.item2id = dict(trndata.item2id) \
            if isinstance(trndata.item2id, dict) else np.array(trndata.item2id)
        self._W_dev = None
        logger.info(
            "The best HR is achieved by, l1: %.4f, l2:%.4f, HR:%.4f, AR:%.4f.",
            res["bestl1HR"], res["bestl2HR"], res["bestHRHR"], res["bestARHR"])
        logger.info(
            "The best AR is achieved by, l1: %.4f, l2:%.4f, HR:%.4f, AR:%.4f.",
            res["bestl1AR"], res["bestl2AR"], res["bestHRAR"], res["bestARAR"])
        return res

    # ------------------------------------------------------------------ #
    def predict(self, data: SLIMatrix, nrcmds: int = 10, outfile=None,
                negitems=None, nnegs: int = 0, returnscores: bool = False):
        if self.model is None:
            raise TypeError("Model not found. Please train a model.")
        if self.nItems != data.nItems:
            raise AssertionError(
                "The shape of the input matrix should match the model.")

        # cache the dense device model only while it's small; beyond the
        # threshold predict_topn switches to the padded-sparse scoring path
        # (n·R·8 bytes instead of n²·4) and manages its own device copy.
        # When the catalogue is small enough that predict_topn would route
        # to the native host kernel anyway (NATIVE_PREDICT_NPAD), skip the
        # device copy entirely so the fallback can fire.
        from .predict import (_bucket, dense_predict_max_npad,
                              native_predict_applicable)
        # same n as predict_topn's own routing (model dims + history width)
        n = max(self.model.nrows, self.model.ncols, data.mat.ncols)
        if (self._W_dev is None and negitems is None
                and native_predict_applicable(n, self.model, data.mat)):
            pass
        elif self._W_dev is None and _bucket(n) <= dense_predict_max_npad():
            self._W_dev = densify_model(self.model)
        elif self._W_dev is None:
            # above the dense threshold the serving pattern still wants a
            # RESIDENT model: cache the padded-row (Widx, Wval) tuple so
            # repeated predict calls don't re-upload/rebuild it
            from .predict import sparsify_model_device

            self._W_dev = sparsify_model_device(self.model)

        if negitems is not None:
            if nnegs < nrcmds:
                raise AssertionError(
                    "The number of negative items must be larger than the "
                    "number of items to be recommended.")
            neg = np.full((data.nUsers, nnegs), -1, dtype=np.int32)
            newitems = 0
            item2id = self.item2id
            for key, value in negitems.items():
                if len(value) != nnegs:
                    raise AssertionError(
                        "The number of negative items should match nnegs.")
                u = data.user2id[key] if isinstance(data.user2id, dict) \
                    else int(key)
                for i, it in enumerate(value):
                    try:
                        neg[u, i] = item2id[it] if isinstance(item2id, dict) \
                            else int(it)
                    except (KeyError, IndexError):
                        newitems += 1
            if newitems:
                logger.warning("%d negative items not in the training set.",
                               newitems)
            ids, scores, _ = predict_topn_1vsk(
                self.model, data.mat, neg, nrcmds=nrcmds, W_dev=self._W_dev)
        else:
            ids, scores, _ = predict_topn(
                self.model, data.mat, nrcmds=nrcmds, W_dev=self._W_dev)

        # map internal ids back to user-facing item labels (-1 slots keep -1)
        id2item = np.asarray(self.id2item)
        res = np.where(ids >= 0, id2item[np.clip(ids, 0, len(id2item) - 1)], -1)

        out, outscores = {}, {}
        if isinstance(data.user2id, dict):
            for key, value in data.user2id.items():
                out[key] = res[value, :]
                outscores[key] = scores[value, :]
        else:
            for key in data.user2id:
                out[key] = res[key, :]
                outscores[key] = scores[key, :]

        if outfile:
            with open(outfile, "w") as fh:
                for key, value in out.items():
                    fh.write(f"{key}: "
                             f"{np.array2string(value, max_line_width=np.inf)}\n")
                    if returnscores:
                        fh.write(f"{key}: "
                                 f"{np.array2string(outscores[key], max_line_width=np.inf)}\n")
        return (out, outscores) if returnscores else out

    # ------------------------------------------------------------------ #
    def save_model(self, modelfname: str, mapfname: str):
        if self.model is None:
            raise RuntimeError("Not exist a model to save.")
        from .io.readers import write_csr
        write_csr(self.model, modelfname, writevals=True, numbering=0)
        np.savetxt(mapfname, np.asarray(self.id2item), fmt="%s")

    def load_model(self, modelfname: str, mapfname: str):
        import os
        if not (os.path.isfile(modelfname) and os.path.isfile(mapfname)):
            raise RuntimeError("File does not exist or invalid filename.")
        from .io.readers import read_csr
        self.model = read_csr(modelfname, readvals=True, numbering=0)
        # model must be square over items
        n = max(self.model.nrows, self.model.ncols)
        self.model = CSR.from_arrays(self.model.nrows, n, self.model.indptr,
                                     self.model.indices, self.model.data)
        try:
            self.id2item = np.genfromtxt(mapfname, dtype=np.int64)
        except Exception:
            self.id2item = np.genfromtxt(mapfname)
        self.id2item = np.atleast_1d(self.id2item)
        self.item2id = {self.id2item[i]: i for i in range(len(self.id2item))}
        self.nItems = len(self.id2item)
        self._W_dev = None

    def to_csr(self, returnmap: bool = False):
        if self.model is None:
            raise RuntimeError("Not exist a model to export.")
        modelcsr = self.model.to_scipy()
        if returnmap:
            return modelcsr, np.asarray(self.id2item).copy()
        return modelcsr
