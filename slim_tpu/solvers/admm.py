"""ADMM model estimation (dense all-columns-at-once solver).

Device equivalent of src/libslim/estimate.c:38-304.  The reference needs
MKL for this path (sparse spmmd + LAPACK Cholesky + 30 dgemm iterations)
and is compiled out otherwise; here the whole algorithm is a chain of
dense matrix products, so it works everywhere (no MKL gate).

Algorithm parity (constants hardcoded exactly like the reference,
estimate.c:48-49 -- optTol/maxniters are ignored by design):

    rho = 10000, MAXITERS = 30
    T = RᵀR                                  (estimate.c:124-125)
    P = inv(T + (l2r+rho) I)   (Cholesky)    (estimate.c:140-164)
    A = P T                                  (estimate.c:167-168)
    iterate 30x:
        T := P (rho W - C) + A               (estimate.c:171-183)
        gamma_i = T_ii / P_ii ; B = T - P diag(gamma)   (zero-diagonal
                                              correction, estimate.c:185-196)
        W = max(soft_threshold(B + C/rho, l1r/rho), 0)  (estimate.c:199-204)
        C += rho (B - W)                     (estimate.c:207-213)
    model = sparsify(W > 0)                  (estimate.c:216-269)
"""

from __future__ import annotations

import logging

import numpy as np

from ..config import SlimConfig, SLIM_DBG_INFO, dbg
from ..ops.gram import compute_gram
from ..types import CSR

logger = logging.getLogger("slim_tpu")

RHO = 10000.0
MAXITERS = 30


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def admm_solve(T, l1r, l2r, n_valid):
    """Run the ADMM iterations on a (padded) dense Gram matrix.

    ``T`` is (npad, npad) f32 with zeros outside the leading n_valid block.
    Returns the dense W.  jitted; every matrix product runs at
    Precision.HIGHEST (full f32: no TF32 rounding of the operands on the
    GPU).
    """
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(T):
        npad = T.shape[0]
        eye = jnp.eye(npad, dtype=T.dtype)
        # pad diagonal gets the same shift so the Cholesky stays SPD.
        # Explicit inverse via the Cholesky factor (potrf+potri-style,
        # estimate.c:152-164): the iteration needs P itself (elementwise
        # uses of diag(P) and P·diag(gamma)), and chol-solve against I is
        # the numerically sound way to form it for an ill-conditioned Gram
        M = T + (l2r + RHO) * eye
        c, low = jax.scipy.linalg.cho_factor(M)
        P = jax.scipy.linalg.cho_solve((c, low), eye)
        P = 0.5 * (P + P.T)          # symmetrize (estimate.c:161-164)
        A = jnp.dot(P, T, preferred_element_type=T.dtype,
                    precision=jax.lax.Precision.HIGHEST)
        Pdiag = jnp.diagonal(P)

        # the dual is maintained in scaled form Cs = C/rho (values stay O(1)
        # instead of O(rho), the friendlier range for f32); the
        # iteration is algebraically identical to estimate.c:171-214.
        def body(_, carry):
            W, Cs = carry
            V = W - Cs                                   # (rho W - C)/rho
            Tm = RHO * jnp.dot(P, V, preferred_element_type=T.dtype,
                               precision=jax.lax.Precision.HIGHEST) + A
            gamma = jnp.diagonal(Tm) / Pdiag
            Bm = Tm - P * gamma[None, :]
            alpha = Bm + Cs
            kappa = l1r / RHO
            soft = jnp.maximum(alpha - kappa, 0.0) - jnp.maximum(-alpha - kappa, 0.0)
            Wn = jnp.maximum(soft, 0.0)
            Csn = Cs + (Bm - Wn)                         # C += rho(B - W)
            return Wn, Csn

        W0 = jnp.zeros_like(T)
        C0 = jnp.zeros_like(T)
        W, Cs = jax.lax.fori_loop(0, MAXITERS, body, (W0, C0))

        # residual/objective from the Gram identity (one extra matmul):
        # ||R - RW||_F² = tr(G) - 2 tr(GW) + tr(Wᵀ G W)
        GW = jnp.dot(T, W, preferred_element_type=T.dtype,
                     precision=jax.lax.Precision.HIGHEST)
        err = 0.5 * (jnp.trace(T) - 2.0 * jnp.sum(T * W.T)
                     + jnp.sum(W * GW))
        obj = err + 0.5 * l2r * jnp.sum(W * W) + l1r * jnp.sum(jnp.abs(W))
        return W, err, obj

    return run(T)


def admm_solve_f64(T, l1r, l2r, n_valid):
    """Float64 numpy reference of :func:`admm_solve` (CPU) -- the parity
    oracle for the f32 device path; mirrors the reference's double-precision
    MKL pipeline (estimate.c:38-304) step for step."""
    import scipy.linalg as sla

    T = np.asarray(T, dtype=np.float64)
    npad = T.shape[0]
    M = T + (l2r + RHO) * np.eye(npad)
    c, low = sla.cho_factor(M)
    P = sla.cho_solve((c, low), np.eye(npad))
    P = 0.5 * (P + P.T)
    A = P @ T
    Pdiag = np.diagonal(P)
    W = np.zeros_like(T)
    Cs = np.zeros_like(T)
    kappa = l1r / RHO
    for _ in range(MAXITERS):
        V = W - Cs
        Tm = RHO * (P @ V) + A
        gamma = np.diagonal(Tm) / Pdiag
        Bm = Tm - P * gamma[None, :]
        alpha = Bm + Cs
        soft = np.maximum(alpha - kappa, 0.0) - np.maximum(-alpha - kappa, 0.0)
        W = np.maximum(soft, 0.0)
        Cs = Cs + (Bm - W)
    return W


def estimate_model_admm(train: CSR, cfg: SlimConfig, imodel: CSR | None = None,
                        gram=None):
    """Estimate a SLIM model with ADMM.  ``imodel`` is accepted for API
    parity but unused (the reference ignores it too, estimate.c:38)."""
    import jax.numpy as jnp

    n = train.ncols
    npad = _round_up(n + 1, 128)
    if train.nnz == 0:
        model = CSR.from_ijv(np.zeros(0, np.int32), np.zeros(0, np.int32),
                             np.zeros(0, np.float32), nrows=n, ncols=n,
                             no_duplicates=True)
        return model, {"loss": 0.0, "fit": 0.0, "ffrac": 0.0, "nnz": 0,
                       "density": 0.0}
    T = gram if gram is not None else compute_gram(train, cfg.gram, pad_to=npad)

    W, err, obj = admm_solve(T, float(cfg.l1r), float(cfg.l2r), n)
    W_host = np.asarray(W[:n, :n])

    # sparsify W > 0 (strict, estimate.c:241) into the model CSR
    rows, cols = np.nonzero(W_host > 0.0)
    vals = W_host[rows, cols].astype(np.float32)
    model = CSR.from_ijv(rows.astype(np.int32), cols.astype(np.int32), vals,
                         nrows=n, ncols=n, no_duplicates=True)
    err = float(err)
    obj = float(obj)
    stats = {"loss": obj, "fit": err,
             "ffrac": err / obj if obj else 0.0,
             "nnz": model.nnz, "density": model.nnz / max(n * n, 1)}
    if dbg(cfg, SLIM_DBG_INFO):
        logger.info("ADMM done: loss %.5e fit %.5e nnz %d density %.4f",
                    obj, err, model.nnz, stats["density"])
    return model, stats
