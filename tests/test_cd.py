"""CD solver correctness vs an independent float64 numpy oracle.

The SLIM per-column problem (SURVEY.md §0; estimate.c:477-489 objective)

    min_{x >= 0, x_j = 0}  1/2||y - Ax||² + l2r/2||x||² + l1r||x||_1
    restricted to the active set {i != j : aᵢᵀy > l1r}

is strongly convex for l2r > 0, so any converged solver must agree on x.
The oracle below works directly on the dense matrix in f64 with the
classic residual-maintenance form -- deliberately a different formulation
from the production Gram-based kernel.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from conftest import random_csr
from slim_tpu.config import SlimConfig
from slim_tpu.solvers.cd import estimate_model_cd
from slim_tpu.types import CSR


def oracle_column(A, j, l1r, l2r, optTol=1e-10, maxniters=10000,
                  active_override=None):
    """f64 cyclic CD on the dense matrix; returns the exact solution."""
    n = A.shape[1]
    y = A[:, j].astype(np.float64)
    aty = A.T.astype(np.float64) @ y
    if active_override is None:
        active = [i for i in range(n) if aty[i] > l1r and i != j]
    else:
        active = [i for i in active_override if i != j]
    x = np.zeros(n)
    yhat = np.zeros_like(y)
    nnzj = int(np.count_nonzero(y))
    cap = min(50 * nnzj, maxniters)
    for _ in range(cap):
        dltx = 0.0
        for i in active:
            a = A[:, i].astype(np.float64)
            yhat -= x[i] * a
            num = aty[i] - a @ yhat
            newx = (num - l1r) / (a @ a + l2r) if num > l1r else 0.0
            yhat += newx * a
            dltx += (newx - x[i]) ** 2
            x[i] = newx
        if dltx < optTol:
            break
    return x


def oracle_objective(A, x, j, l1r, l2r):
    y = A[:, j].astype(np.float64)
    r = y - A.astype(np.float64) @ x
    return (0.5 * r @ r + 0.5 * l2r * x @ x + l1r * np.abs(x).sum())


@pytest.mark.parametrize("l1r,l2r", [(0.5, 0.5), (1.0, 1.0), (0.1, 2.0)])
def test_cd_matches_oracle_small(l1r, l2r):
    rng = np.random.default_rng(42)
    A_dense = (rng.random((30, 12)) < 0.4).astype(np.float32) * \
        rng.integers(1, 4, (30, 12)).astype(np.float32)
    mat = CSR.from_scipy(sp.csr_matrix(A_dense))
    cfg = SlimConfig(l1r=l1r, l2r=l2r, optTol=1e-12, block_size=4,
                     shuffle=False)
    model, stats = estimate_model_cd(mat, cfg)
    W = model.to_scipy().toarray()

    for j in range(12):
        x_ref = oracle_column(A_dense, j, l1r, l2r)
        np.testing.assert_allclose(W[:, j], x_ref, atol=2e-4,
                                   err_msg=f"column {j}")
        # objective agreement (stronger than pointwise x)
        obj_ours = oracle_objective(A_dense, W[:, j].astype(np.float64), j,
                                    l1r, l2r)
        obj_ref = oracle_objective(A_dense, x_ref, j, l1r, l2r)
        assert obj_ours <= obj_ref * (1 + 1e-4) + 1e-6


def test_cd_shuffled_same_optimum():
    """Shuffled and cyclic coordinate order converge to the same optimum."""
    rng = np.random.default_rng(7)
    mat = random_csr(rng, 40, 16, density=0.35)
    cfg = SlimConfig(l1r=0.5, l2r=0.5, optTol=1e-12, block_size=8)
    m_shuf, _ = estimate_model_cd(mat, cfg.replace(shuffle=True))
    m_cyc, _ = estimate_model_cd(mat, cfg.replace(shuffle=False))
    np.testing.assert_allclose(m_shuf.to_scipy().toarray(),
                               m_cyc.to_scipy().toarray(), atol=5e-4)


def test_cd_zero_diagonal_and_nonneg():
    rng = np.random.default_rng(3)
    mat = random_csr(rng, 50, 20, density=0.3)
    model, _ = estimate_model_cd(mat, SlimConfig(l1r=0.2, l2r=0.5))
    W = model.to_scipy().toarray()
    assert np.all(np.diag(W) == 0), "zero-diagonal constraint violated"
    assert np.all(W >= 0), "nonnegativity violated"
    assert model.nnz > 0


def test_cd_implicit_data():
    """Implicit (values=None) matrices behave like all-ones values."""
    rng = np.random.default_rng(11)
    mat = random_csr(rng, 40, 15, density=0.3, implicit=True)
    ones = CSR.from_arrays(mat.nrows, mat.ncols, mat.indptr, mat.indices,
                           np.ones(mat.nnz, np.float32))
    cfg = SlimConfig(l1r=0.5, l2r=0.5, optTol=1e-12, shuffle=False)
    m_imp, _ = estimate_model_cd(mat, cfg)
    m_one, _ = estimate_model_cd(ones, cfg)
    np.testing.assert_allclose(m_imp.to_scipy().toarray(),
                               m_one.to_scipy().toarray(), atol=1e-5)


def test_cd_warm_start_same_optimum_fewer_iters():
    rng = np.random.default_rng(5)
    mat = random_csr(rng, 60, 24, density=0.3)
    cfg = SlimConfig(l1r=0.4, l2r=0.6, optTol=1e-12, shuffle=False)
    cold, stats_cold = estimate_model_cd(mat, cfg)
    warm, stats_warm = estimate_model_cd(mat, cfg, imodel=cold)
    np.testing.assert_allclose(cold.to_scipy().toarray(),
                               warm.to_scipy().toarray(), atol=5e-4)
    assert stats_warm["niters"] <= stats_cold["niters"]


def test_cd_large_l1_empty_model():
    rng = np.random.default_rng(9)
    mat = random_csr(rng, 30, 10, density=0.3)
    model, stats = estimate_model_cd(mat, SlimConfig(l1r=1e9, l2r=1.0))
    assert model.nnz == 0
    # all residual, no fit: loss == fit == sum of 1/2||y_j||²
    cn = mat.column_norms().astype(np.float64)
    np.testing.assert_allclose(stats["fit"], 0.5 * np.sum(cn ** 2), rtol=1e-5)


def test_fslim_restricts_support():
    rng = np.random.default_rng(13)
    mat = random_csr(rng, 50, 20, density=0.4)
    nnbrs = 3
    cfg = SlimConfig(l1r=0.1, l2r=0.5, nnbrs=nnbrs, simtype="cos",
                     optTol=1e-12, shuffle=False)
    assert cfg.mtype == "fslim"
    model, _ = estimate_model_cd(mat, cfg)
    W = model.to_scipy().toarray()
    assert np.all((W > 0).sum(axis=0) <= nnbrs)

    # verify the neighbour selection matches the reference formula:
    # cos sim = a_k . a_j / ||a_k|| over co-rated candidates
    A = mat.to_dense().astype(np.float64)
    G = A.T @ A
    cn = np.sqrt(np.diag(G))
    for j in range(20):
        support = np.nonzero(W[:, j])[0]
        if len(support) == 0:
            continue
        sim = np.where((G[:, j] > 0) & (cn > 0), G[:, j] / np.maximum(cn, 1e-30),
                       -np.inf)
        sim[j] = -np.inf
        top = set(np.argsort(-sim)[:nnbrs])
        assert set(support) <= top, f"col {j}: support {support} not in top {top}"

    # and the solution on that support matches the restricted oracle
    for j in range(20):
        sim = np.where(G[:, j] > 0, G[:, j] / np.maximum(cn, 1e-30), -np.inf)
        sim[j] = -np.inf
        order = np.argsort(-sim)
        top = [i for i in order[:nnbrs] if np.isfinite(sim[i])]
        x_ref = oracle_column(mat.to_dense(), j, 0.1, 0.5,
                              active_override=top)
        np.testing.assert_allclose(W[:, j], x_ref, atol=5e-4)


def test_cd_deterministic_across_runs():
    """Same seed => bitwise-identical model (the reference is
    nondeterministic via shared-state rand(); we claim reproducibility)."""
    rng = np.random.default_rng(23)
    mat = random_csr(rng, 40, 18, density=0.3, seed=23)
    cfg = SlimConfig(l1r=0.4, l2r=0.6, seed=7)
    m1, s1 = estimate_model_cd(mat, cfg)
    m2, s2 = estimate_model_cd(mat, cfg)
    np.testing.assert_array_equal(m1.to_scipy().toarray(),
                                  m2.to_scipy().toarray())
    assert s1["loss"] == s2["loss"]


def test_empty_training_matrix():
    """Degenerate input: zero nnz must yield an empty model with zero
    objective (not a crash in the device Gram), for both solvers."""
    from slim_tpu.api import get_topn, learn
    from slim_tpu.types import CSR

    empty = CSR.from_ijv(np.zeros(0, int), np.zeros(0, int),
                         np.zeros(0, np.float32), 5, 7)
    for algo in ("cd", "admm"):
        model, stats = learn(empty, SlimConfig(algo=algo))
        assert stats["nnz"] == 0 and stats["loss"] == 0.0
        assert model.nrows == model.ncols == 7
    ids, _, counts = get_topn(model, empty, nrcmds=3)
    assert counts.sum() == 0 and (ids == -1).all()


def test_fslim_active_mask_wide_two_stage():
    """At width >= 2^18 fslim_active_mask switches to the two-stage exact
    top-k; the selected neighbour sets must equal the single-pass form."""
    import jax.numpy as jnp

    from slim_tpu.ops.cd_kernel import fslim_active_mask

    width, B, k = 1 << 18, 4, 7
    rng = np.random.default_rng(11)
    gj = np.zeros((B, width), np.float32)
    # sparse co-rating pattern with distinct similarities (no ties)
    for b in range(B):
        cols = rng.choice(width, 300, replace=False)
        gj[b, cols] = rng.permutation(300).astype(np.float32) + 1.0
    diag = (rng.random(width).astype(np.float32) + 0.5) ** 2
    self_ids = np.arange(B, dtype=np.int32) * 1000
    got = np.asarray(fslim_active_mask(
        jnp.asarray(gj), jnp.asarray(diag), jnp.asarray(self_ids),
        width, k, "cos"))
    # reference: plain numpy top-k on the same similarity
    sim = gj / np.sqrt(diag)[None, :]
    for b in range(B):
        cand = (gj[b] > 0) & (np.arange(width) != self_ids[b])
        s = np.where(cand, sim[b], -np.inf)
        expect = np.argsort(-s)[:k]
        expect = expect[np.isfinite(s[expect])]
        assert set(np.nonzero(got[b])[0]) == set(expect)


def test_keep_device_model_matches_assembled_csr():
    """keep_device_model retains the flat harvest packs on device and
    densifies lazily at predict; the densified W must equal densify of
    the assembled CSR exactly (same EPSILON threshold, same mapping back
    to item space, rank-padding coordinates dropped)."""
    import numpy as np

    from slim_tpu.predict import DeviceModelPack, densify_model

    train = random_csr(None, 60, 37, density=0.25, seed=5)
    cfg = SlimConfig(l1r=0.3, l2r=0.5, optTol=1e-9, block_size=16)
    model, stats = estimate_model_cd(train.infer_ncols(), cfg,
                                     keep_device_model=True)
    pack = stats.get("W_dev")
    assert isinstance(pack, DeviceModelPack)
    ref = np.asarray(densify_model(model, npad=pack.npad))
    np.testing.assert_allclose(np.asarray(pack.densify()), ref,
                               rtol=0, atol=1e-6)


def test_keep_device_model_compact_space():
    """Retention through the compact-union dispatch path (K < npad)."""
    import numpy as np

    from slim_tpu.predict import DeviceModelPack, densify_model

    train = random_csr(None, 200, 300, density=0.05, seed=11)
    cfg = SlimConfig(l1r=1.0, l2r=1.0, optTol=1e-9, block_size=32,
                     compact_threshold=64)
    model, stats = estimate_model_cd(train.infer_ncols(), cfg,
                                     keep_device_model=True)
    pack = stats.get("W_dev")
    assert isinstance(pack, DeviceModelPack)
    ref = np.asarray(densify_model(model, npad=pack.npad))
    np.testing.assert_allclose(np.asarray(pack.densify()), ref,
                               rtol=0, atol=1e-6)


def _sweep_problem(n, npad, nrows, B, ncols_real, seed):
    """Random rating matrix, its padded Gram and a block of target ids
    (padded targets point at the zero column npad-1 with cap 0)."""
    rng = np.random.default_rng(seed)
    A = (rng.random((nrows, n)) < 0.3).astype(np.float32) * \
        rng.integers(1, 4, (nrows, n)).astype(np.float32)
    G = np.zeros((npad, npad), np.float32)
    G[:n, :n] = A.T @ A
    j_ids = np.full(B, npad - 1, np.int32)
    j_ids[:ncols_real] = rng.choice(n, ncols_real, replace=False)
    nnz = (A != 0).sum(axis=0)
    caps = np.zeros(B, np.int32)
    caps[:ncols_real] = np.minimum(50 * nnz[j_ids[:ncols_real]], 10000)
    return A, G, j_ids, caps


def _fslim_top(A, j, nnbrs):
    G = A.T.astype(np.float64) @ A
    cn = np.sqrt(np.diag(G))
    sim = np.where(G[:, j] > 0, G[:, j] / np.maximum(cn, 1e-30), -np.inf)
    sim[j] = -np.inf
    return [i for i in np.argsort(-sim)[:nnbrs] if np.isfinite(sim[i])]


# (name, n, npad, B, real columns, shuffle, warm, per-column reg, fslim)
SWEEP_CASES = [
    ("cyclic", 40, 128, 8, 8, False, False, False, 0),
    ("shuffled", 60, 256, 16, 16, True, False, False, 0),
    ("warm_x0", 50, 128, 8, 8, True, True, False, 0),
    ("per_column_reg", 48, 128, 16, 16, True, False, True, 0),
    ("fslim", 40, 128, 8, 8, False, False, False, 4),
    ("inactive_chunks_padded_cols", 100, 384, 16, 11, True, False, False, 0),
]


@pytest.mark.parametrize("case", SWEEP_CASES, ids=[c[0] for c in SWEEP_CASES])
def test_triton_sweep_matches_oracle(case, monkeypatch):
    """The chunk-list sweep with the Pallas Triton Gauss-Seidel kernel (in
    interpret mode here) solves every column to the float64 oracle's
    optimum, and agrees with the plain XLA sweep."""
    import functools

    import jax
    import jax.numpy as jnp

    from slim_tpu.ops import cd_kernel
    from slim_tpu.ops.cd_triton import gs_chunk

    name, n, npad, B, nreal, shuffle, warm, per_col, nnbrs = case
    monkeypatch.setattr(cd_kernel, "gs_chunk",
                        functools.partial(gs_chunk, interpret=True))
    jax.clear_caches()
    A, G, j_ids, caps = _sweep_problem(n, npad, 90, B, nreal, seed=len(name))
    rng = np.random.default_rng(3)
    if per_col:
        l1 = rng.uniform(0.2, 2.0, B).astype(np.float32)
        l2 = rng.uniform(0.3, 2.0, B).astype(np.float32)
    else:
        l1 = np.full(B, 0.5, np.float32)
        l2 = np.full(B, 1.0, np.float32)
    oracle = np.zeros((B, n))
    for b in range(nreal):
        j = int(j_ids[b])
        top = _fslim_top(A, j, nnbrs) if nnbrs else None
        oracle[b] = oracle_column(A, j, float(l1[b]), float(l2[b]),
                                  active_override=top)
    x0 = np.zeros((B, npad), np.float32)
    if warm:
        x0[:, :n] = oracle * rng.uniform(0.5, 1.5, oracle.shape)
    args = (jnp.asarray(G), jnp.asarray(j_ids), jnp.asarray(caps),
            jnp.asarray(x0), n, jnp.asarray(l1), jnp.asarray(l2), 1e-12, 7)
    kw = dict(shuffle=shuffle, fslim_nnbrs=nnbrs, simtype="cos")
    xk, nk, rk, _, objk = cd_kernel.cd_solve_block_ids(*args, impl="triton",
                                                       **kw)
    xx, _, _, _, objx = cd_kernel.cd_solve_block_ids(*args, impl="xla", **kw)
    xk = np.asarray(xk)
    np.testing.assert_allclose(xk[:, :n], oracle, atol=2e-4)
    assert np.all(xk[:, n:] == 0) and np.all(xk[nreal:] == 0)
    assert np.asarray(rk)[:nreal].all()           # converged within caps
    assert np.all(np.asarray(nk)[nreal:] == 0)    # padded columns never run
    np.testing.assert_allclose(xk, np.asarray(xx), atol=1e-5)
    np.testing.assert_allclose(np.asarray(objk), np.asarray(objx),
                               rtol=1e-5, atol=1e-6)


def test_gs_chunk_kernel_matches_reference():
    """One chunk: the Triton kernel (interpret mode) against the XLA chunk
    step, with inactive coordinates (+inf thresholds), a finished
    column (all +inf, nonzero x kept) and a random visit order."""
    import jax
    import jax.numpy as jnp

    from slim_tpu.ops.cd_kernel import gs_chunk_xla
    from slim_tpu.ops.cd_triton import CHUNK, gs_chunk

    rng = np.random.default_rng(0)
    B = 16
    A = (rng.random((200, CHUNK)) < 0.2).astype(np.float32)
    G = A.T @ A
    r = (rng.random((B, CHUNK)) * 5).astype(np.float32)
    x = np.where(rng.random((B, CHUNK)) < 0.3, rng.random((B, CHUNK)),
                 0).astype(np.float32)
    t = np.where(rng.random((B, CHUNK)) < 0.5, 1.0, np.inf).astype(np.float32)
    t[3] = np.inf
    x[t == np.inf] = 0
    x[3] = rng.random(CHUNK)
    l2 = rng.uniform(0.5, 2, B).astype(np.float32)
    d = np.diag(G).copy()
    perm = rng.permutation(CHUNK).astype(np.int32)
    args = [jnp.asarray(a) for a in (r, x, t, l2, d, G, perm)]
    got = np.asarray(gs_chunk(*args, interpret=True))
    ref = np.asarray(jax.jit(gs_chunk_xla)(*args))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[3], x[3])     # finished column kept
    assert np.any(got != x)


@pytest.mark.parametrize("backend,impl,x3", [
    ("gpu", "triton", True), ("gpu", "xla", False), ("cpu", "triton", False),
])
def test_sweep_precision_by_backend(backend, impl, x3):
    """TF32x3 products only for the Triton sweep on the GPU; the XLA step
    and the CPU (no TF32 algorithms) keep Precision.HIGHEST."""
    import jax

    from slim_tpu.ops import cd_kernel

    want = (jax.lax.DotAlgorithmPreset.TF32_TF32_F32_X3 if x3
            else jax.lax.Precision.HIGHEST)
    assert cd_kernel.sweep_impl(impl, backend) == (impl, want)


@pytest.mark.parametrize("platform,want", [("gpu", "triton"), ("cpu", "xla")])
def test_sweep_impl_by_platform(platform, want, monkeypatch):
    """The block solve is chosen in one place, by platform; with no
    argument it reads the default device's platform."""
    import jax

    from slim_tpu.ops.cd_kernel import sweep_impl

    assert sweep_impl(platform=platform).impl == want

    class Dev:
        pass

    dev = Dev()
    dev.platform = platform
    monkeypatch.setattr(jax, "devices", lambda: [dev])
    assert sweep_impl() == sweep_impl(platform=platform)


@pytest.mark.parametrize("impl,B,width,ok", [
    ("triton", 16, 256, True), ("triton", 12, 256, False),
    ("triton", 4, 128, False), ("triton", 16, 200, False),
    ("xla", 12, 256, True), ("xla", 4, 200, False), ("pallas", 16, 256, False),
])
def test_check_sweep_domain(impl, B, width, ok):
    """Shapes outside an implementation's domain are rejected before
    dispatch (no silent fallback to another kernel)."""
    from slim_tpu.ops.cd_kernel import check_sweep_domain

    if ok:
        check_sweep_domain(impl, B, width)
    else:
        with pytest.raises(ValueError):
            check_sweep_domain(impl, B, width)


@pytest.mark.gpu
def test_gs_chunk_compiled_matches_reference_on_gpu():
    """The kernel as compiled for the card (no interpret mode) against its
    plain-JAX reference at a real block width."""
    import jax
    import jax.numpy as jnp

    from slim_tpu.ops.cd_kernel import gs_chunk_xla
    from slim_tpu.ops.cd_triton import CHUNK, gs_chunk

    rng = np.random.default_rng(1)
    B = 1024
    A = (rng.random((400, CHUNK)) < 0.2).astype(np.float32)
    G = A.T @ A
    r = (rng.random((B, CHUNK)) * 5).astype(np.float32)
    t = np.where(rng.random((B, CHUNK)) < 0.5, 1.0, np.inf) \
        .astype(np.float32)
    args = [jnp.asarray(a) for a in (
        r, np.zeros((B, CHUNK), np.float32), t,
        np.ones(B, np.float32), np.diag(G).copy(), G,
        rng.permutation(CHUNK).astype(np.int32))]
    got = np.asarray(gs_chunk(*args))
    ref = np.asarray(jax.jit(gs_chunk_xla)(*args))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
