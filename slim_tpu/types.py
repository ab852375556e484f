"""Sparse matrix containers for slim_tpu.

The host-side container is a plain CSR triple (numpy arrays).  Device-side
views (dense blocks, padded-row form) are derived on demand by the ops layer;
nothing in here touches JAX so that IO and CLI tools stay importable without
initialising a device backend.

Reference parity: mirrors the capabilities of the reference's ``gk_csr_t``
(see /root/reference/src/libslim/setup.c:109-135 for the training-matrix
setup semantics: column index, column 2-norms, sorted indices) without
copying its layout; we keep a single canonical CSR and build the CSC view
lazily.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["CSR"]


@dataclasses.dataclass
class CSR:
    """A compressed-sparse-row matrix.

    ``data is None`` means an implicit all-ones matrix (the reference models
    binarized/implicit feedback by freeing ``rowval``; we model it the same
    way so downstream code can skip multiplies).

    ``indptr`` is int64 (the reference uses ``ssize_t`` rowptr, slim.h:108)
    so nnz > 2^31 works; ``indices`` is int32; ``data`` float32.
    """

    nrows: int
    ncols: int
    indptr: np.ndarray  # int64, shape (nrows+1,)
    indices: np.ndarray  # int32, shape (nnz,)
    data: Optional[np.ndarray]  # float32, shape (nnz,) or None (implicit 1.0)

    # lazily-built CSC view + column norms (cached)
    _csc: Optional["CSR"] = dataclasses.field(default=None, repr=False)
    _cnorms: Optional[np.ndarray] = dataclasses.field(default=None, repr=False)
    # cached device uploads (see dev_put)
    _dev: dict = dataclasses.field(default_factory=dict, repr=False)

    # ------------------------------------------------------------------ #
    # constructors
    # ------------------------------------------------------------------ #
    @staticmethod
    def from_arrays(nrows, ncols, indptr, indices, data=None) -> "CSR":
        indptr = np.ascontiguousarray(indptr, dtype=np.int64)
        indices = np.ascontiguousarray(indices, dtype=np.int32)
        if data is not None:
            data = np.ascontiguousarray(data, dtype=np.float32)
        return CSR(int(nrows), int(ncols), indptr, indices, data)

    @staticmethod
    def from_scipy(mat) -> "CSR":
        m = mat.tocsr()
        return CSR.from_arrays(m.shape[0], m.shape[1], m.indptr, m.indices, m.data)

    @staticmethod
    def from_ijv(rows, cols, vals, nrows=None, ncols=None,
                 no_duplicates: bool = False) -> "CSR":
        """Build from COO triplets (duplicates summed, like scipy).

        Summing keeps the Gram-based solvers consistent with the
        scatter-based ones: duplicated (row, col) entries otherwise give
        G[i,j] = Σ a_i a_j a different weight than the reference's
        per-entry scatter loops.  ``no_duplicates=True`` (a caller
        guarantee, e.g. the model harvest where every (coord, target)
        appears exactly once) skips the f64 up-convert and the
        sum_duplicates pass -- roughly 4x faster at the 34M-triplet
        scale of an ML-20M model assembly.
        """
        import scipy.sparse as sp

        rows = np.ascontiguousarray(rows)
        cols = np.ascontiguousarray(cols)
        vals = np.ascontiguousarray(vals, dtype=np.float32)
        rmax = int(rows.max()) + 1 if rows.size else 0
        cmax = int(cols.max()) + 1 if cols.size else 0
        if nrows is None:
            nrows = rmax
        if ncols is None:
            ncols = cmax
        if rows.size == 0:
            return CSR.empty(nrows, ncols)
        # scipy's C coo->csr counting sort is ~10x numpy sort-based builds
        # at the 34M-triplet scale of an ML-20M model harvest; duplicates
        # are summed in f64 so the Gram and scatter solver paths agree.
        # shape sized by the actual max indices (callers may declare a
        # smaller ncols and call infer_ncols() later); the declared dims
        # are kept on the returned CSR.  int32 indices throughout: the
        # int64 asarray conversions alone cost more than the C kernels.
        shape = (max(nrows, rmax), max(ncols, cmax))
        data = vals if no_duplicates else vals.astype(np.float64)
        m = sp.coo_matrix(
            (data, (rows.astype(np.int32, copy=False),
                    cols.astype(np.int32, copy=False))),
            shape=shape, copy=False).tocsr()
        if not no_duplicates:
            m.sum_duplicates()
        m.sort_indices()
        return CSR.from_arrays(nrows, ncols, m.indptr.astype(np.int64),
                               m.indices.astype(np.int32, copy=False),
                               m.data.astype(np.float32, copy=False))

    @staticmethod
    def empty(nrows: int, ncols: int) -> "CSR":
        return CSR.from_arrays(
            nrows, ncols, np.zeros(nrows + 1, np.int64), np.zeros(0, np.int32),
            np.zeros(0, np.float32))

    # ------------------------------------------------------------------ #
    # basic properties
    # ------------------------------------------------------------------ #
    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    @property
    def shape(self):
        return (self.nrows, self.ncols)

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.indptr)

    def col_nnz(self) -> np.ndarray:
        """Per-column nonzero counts without materialising the CSC view
        (a bincount; the full tocsc costs ~2x more at ML-20M scale and
        the solvers only need these counts)."""
        return np.bincount(self.indices, minlength=self.ncols) \
            .astype(np.int64)

    def values(self) -> np.ndarray:
        """Materialised values (ones if implicit)."""
        if self.data is not None:
            return self.data
        return np.ones(self.nnz, dtype=np.float32)

    def dev_put(self, key, build):
        """Cached host->device upload keyed by ``key`` (``build()`` makes
        the device array on first use).

        Repeated learns/predicts over the same resident matrix -- bench
        repeats, mselect grid points, a serving loop -- otherwise re-ship
        ~2-6 bytes/nnz (≈40 MB at ML-20M) to the device on every call.  Safe because CSR is immutable by contract: every
        transform (binarize/with_ncols/sort_indices/...) returns a new
        object, so a cached upload can never go stale.
        """
        v = self._dev.get(key)
        if v is None:
            v = self._dev[key] = build()
        return v

    # ------------------------------------------------------------------ #
    # transforms
    # ------------------------------------------------------------------ #
    def binarize(self) -> "CSR":
        """Drop ratings (reference: frees rowval, slim_learn.c:47-48)."""
        return CSR.from_arrays(self.nrows, self.ncols, self.indptr, self.indices, None)

    def with_ncols(self, ncols: int) -> "CSR":
        """Widen the column dimension (mselect aligns trn/tst ncols)."""
        if ncols == self.ncols:
            return self
        out = CSR.from_arrays(self.nrows, ncols, self.indptr, self.indices, self.data)
        return out

    def infer_ncols(self) -> "CSR":
        """ncols = max(col index)+1 (reference setup.c:117)."""
        ncols = int(self.indices.max()) + 1 if self.indices.size else 0
        return self.with_ncols(max(ncols, self.ncols))

    def sort_indices(self) -> "CSR":
        """Sort column indices within each row (reference setup.c:19-94)."""
        m = self.to_scipy()
        m.sort_indices()
        return CSR.from_arrays(self.nrows, self.ncols, m.indptr, m.indices,
                               None if self.data is None else m.data)

    def sum_duplicate_entries(self) -> "CSR":
        """Canonicalize: sum duplicate (row, col) entries in place of
        keeping both.  The reference's scalar += loops accumulate
        duplicates naturally; the device scatter kernels assume unique
        coordinates per row, so file-read matrices are canonicalized at
        the boundary.  Returns self unchanged when already canonical."""
        rows = np.repeat(np.arange(self.nrows, dtype=np.int64),
                         np.diff(self.indptr).astype(np.int64))
        order = np.lexsort((self.indices, rows))
        r_s, c_s = rows[order], self.indices[order]
        dup = (r_s[1:] == r_s[:-1]) & (c_s[1:] == c_s[:-1])
        if not dup.any():
            return self
        m = self.to_scipy()
        m.sum_duplicates()
        # keep the summed values even for implicit input: a duplicated id
        # counts twice in the reference's += loops, so the canonical form
        # carries the multiplicity as an explicit value
        return CSR.from_arrays(self.nrows, self.ncols,
                               m.indptr.astype(np.int64), m.indices, m.data)

    def transpose(self) -> "CSR":
        """CSC view as a CSR of the transpose (cached).

        Equivalent of ``gk_csr_CreateIndex(mat, GK_CSR_COL)`` +
        ``slim_csr_SortIndices`` (setup.c:128-132): within each column the
        row indices come out sorted ascending.
        """
        if self._csc is None:
            import scipy.sparse as sp

            # scipy's C csr->csc counting sort (O(nnz), canonical row
            # order within columns) -- ~5x the numpy stable-argsort build
            # at ML-20M nnz counts
            dat = self.data if self.data is not None \
                else np.empty(self.nnz, np.float32)
            m = sp.csr_matrix((dat, self.indices, self.indptr),
                              shape=(self.nrows, self.ncols)).tocsc()
            tdat = None if self.data is None \
                else m.data.astype(np.float32, copy=False)
            self._csc = CSR.from_arrays(self.ncols, self.nrows,
                                        m.indptr.astype(np.int64),
                                        m.indices.astype(np.int32), tdat)
            self._csc._csc = self  # transpose of transpose
        return self._csc

    def column_norms(self) -> np.ndarray:
        """Column 2-norms (reference ``gk_csr_ComputeNorms(mat, GK_CSR_COL)``,
        setup.c:130; used as ``cnorms`` with ``aTa*aTa`` = squared norm in
        cd.c:119-127)."""
        if self._cnorms is None:
            sq = np.square(self.values(), dtype=np.float64)
            sums = np.zeros(self.ncols, dtype=np.float64)
            np.add.at(sums, self.indices, sq)
            self._cnorms = np.sqrt(sums).astype(np.float32)
        return self._cnorms

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix(
            (self.values(), self.indices, self.indptr), shape=(self.nrows, self.ncols))

    def to_dense(self, dtype=np.float32) -> np.ndarray:
        out = np.zeros((self.nrows, self.ncols), dtype=dtype)
        rows = np.repeat(np.arange(self.nrows), self.row_nnz().astype(np.int64))
        out[rows, self.indices] = self.values()
        return out

    # ------------------------------------------------------------------ #
    # padded-row (ELL-ish) device form
    # ------------------------------------------------------------------ #
    def padded_rows(self, width: Optional[int] = None, pad_index: int = -1):
        """Return (indices, values) as dense (nrows, width) arrays padded with
        ``pad_index`` / 0.0.  Used to feed user histories to device kernels
        with static shapes."""
        nnz_per_row = self.row_nnz().astype(np.int64)
        w = int(width if width is not None else (nnz_per_row.max() if self.nrows else 0))
        idx = np.full((self.nrows, w), pad_index, dtype=np.int32)
        val = np.zeros((self.nrows, w), dtype=np.float32)
        if self.nnz:
            rows = np.repeat(np.arange(self.nrows, dtype=np.int64), nnz_per_row)
            pos = np.arange(self.nnz, dtype=np.int64) - self.indptr[rows]
            keep = pos < w
            idx[rows[keep], pos[keep]] = self.indices[keep]
            val[rows[keep], pos[keep]] = self.values()[keep]
        return idx, val

    def __eq__(self, other):
        if not isinstance(other, CSR):
            return NotImplemented
        return (self.shape == other.shape
                and np.array_equal(self.indptr, other.indptr)
                and np.array_equal(self.indices, other.indices)
                and np.allclose(self.values(), other.values()))
