"""Native C++ runtime (slimrt) tests: build, correctness vs the JAX solver
and the f64 oracle."""

import numpy as np
import pytest

from conftest import random_csr
from slim_tpu import native
from slim_tpu.config import SlimConfig
from slim_tpu.solvers.cd import estimate_model_cd

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C++ toolchain")


def test_native_cd_matches_jax(rng):
    mat = random_csr(rng, 50, 20, density=0.3, seed=55)
    cfg = SlimConfig(l1r=0.5, l2r=0.5, optTol=1e-12, shuffle=False)
    jax_model, jax_stats = estimate_model_cd(mat, cfg)
    nat_model, nat_err, nat_obj = native.cd_learn(
        mat, l1r=0.5, l2r=0.5, optTol=1e-12, shuffle=False)
    np.testing.assert_allclose(nat_model.to_scipy().toarray(),
                               jax_model.to_scipy().toarray(), atol=5e-4)
    np.testing.assert_allclose(nat_obj, jax_stats["loss"], rtol=1e-4)
    np.testing.assert_allclose(nat_err, jax_stats["fit"], rtol=1e-4)


def test_native_cd_implicit(rng):
    mat = random_csr(rng, 40, 15, density=0.3, implicit=True, seed=66)
    nat_model, _, _ = native.cd_learn(mat, l1r=0.3, l2r=0.5, optTol=1e-12,
                                      shuffle=False)
    cfg = SlimConfig(l1r=0.3, l2r=0.5, optTol=1e-12, shuffle=False)
    jax_model, _ = estimate_model_cd(mat, cfg)
    np.testing.assert_allclose(nat_model.to_scipy().toarray(),
                               jax_model.to_scipy().toarray(), atol=5e-4)


def test_native_cd_multithreaded_same_result(rng):
    mat = random_csr(rng, 60, 25, density=0.25, seed=77)
    m1, e1, o1 = native.cd_learn(mat, l1r=0.5, l2r=1.0, optTol=1e-12,
                                 shuffle=False, nthreads=1)
    m4, e4, o4 = native.cd_learn(mat, l1r=0.5, l2r=1.0, optTol=1e-12,
                                 shuffle=False, nthreads=4)
    np.testing.assert_allclose(m1.to_scipy().toarray(),
                               m4.to_scipy().toarray(), atol=1e-6)
    np.testing.assert_allclose(o1, o4, rtol=1e-10)


def test_native_gram(rng):
    mat = random_csr(rng, 30, 12, density=0.4, seed=88)
    g = native.gram_dense(mat, pad_to=16)
    A = mat.to_dense().astype(np.float64)
    expect = A.T @ A
    np.testing.assert_allclose(g[:12, :12], expect, rtol=1e-5)
    assert np.all(g[12:, :] == 0) and np.all(g[:, 12:] == 0)


def test_native_predict_matches_device_path(rng):
    from conftest import random_csr
    from slim_tpu import native
    from slim_tpu.predict import predict_topn

    if not native.available():
        import pytest
        pytest.skip("no native toolchain")
    model = random_csr(rng, 60, 60, density=0.15, seed=300)
    hist = random_csr(rng, 30, 60, density=0.2, seed=301)
    di, dsc, dc = predict_topn(model, hist, nrcmds=8)
    ni, nsc, nc = native.predict_topn(model, hist, nrcmds=8)
    np.testing.assert_array_equal(dc, nc)
    W = model.to_scipy().toarray()
    Hm = hist.to_scipy().toarray()
    for u in range(hist.nrows):
        k = dc[u]
        np.testing.assert_allclose(np.sort(dsc[u][:k]), np.sort(nsc[u][:k]),
                                   rtol=1e-5, atol=1e-6)
        # id sets may differ only at score ties on the N-th place
        s = Hm[u] @ W
        cut = min(nsc[u][:k], default=0.0) if k else 0.0
        for extra in set(di[u][:k]) ^ set(ni[u][:k]):
            np.testing.assert_allclose(s[extra], cut, rtol=1e-5)


def test_native_predict_implicit_history(rng):
    from conftest import random_csr
    from slim_tpu import native
    from slim_tpu.predict import predict_topn

    if not native.available():
        import pytest
        pytest.skip("no native toolchain")
    model = random_csr(rng, 40, 40, density=0.2, seed=310)
    hist = random_csr(rng, 15, 40, density=0.3, implicit=True, seed=311)
    di, dsc, dc = predict_topn(model, hist, nrcmds=5)
    ni, nsc, nc = native.predict_topn(model, hist, nrcmds=5)
    np.testing.assert_array_equal(dc, nc)
    for u in range(hist.nrows):
        k = dc[u]
        np.testing.assert_allclose(np.sort(dsc[u][:k]), np.sort(nsc[u][:k]),
                                   rtol=1e-5, atol=1e-6)


def test_native_fallback_dispatch(rng, monkeypatch):
    """Unpinned small-catalogue predict_topn calls route to the native host
    kernel (the regime where the whole job is below the device's dispatch
    overhead); any explicit
    path choice keeps the call on device, and both agree."""
    import pytest

    from conftest import random_csr
    from slim_tpu import native
    from slim_tpu import predict as P

    if not native.available():
        pytest.skip("no native toolchain")
    monkeypatch.setenv("SLIM_PREDICT_NATIVE_NPAD", "4096")

    calls = []
    orig = native.predict_topn

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(native, "predict_topn", spy)
    model = random_csr(rng, 50, 50, density=0.2, seed=320)
    hist = random_csr(rng, 20, 50, density=0.25, seed=321)

    assert P.native_predict_applicable(50)
    ni, nsc, nc = P.predict_topn(model, hist, nrcmds=6)
    assert calls, "unpinned call should have routed to the native kernel"

    calls.clear()
    di, dsc, dc = P.predict_topn(model, hist, nrcmds=6, sparse=False)
    assert not calls, "pinned (sparse=False) call must stay on device"

    np.testing.assert_array_equal(nc, dc)
    for u in range(hist.nrows):
        k = int(dc[u])
        np.testing.assert_allclose(np.sort(nsc[u][:k]), np.sort(dsc[u][:k]),
                                   rtol=1e-5, atol=1e-6)

    # threshold off => no fallback even for unpinned calls
    monkeypatch.setenv("SLIM_PREDICT_NATIVE_NPAD", "0")
    calls.clear()
    P.predict_topn(model, hist, nrcmds=6)
    assert not calls


def test_native_work_based_dispatch(rng, monkeypatch):
    """Above the small-npad threshold the router decides by estimated
    per-user work (round-3 hardware fit: native wins while
    mean-history-nnz * mean-model-row-nnz < alpha*npad)."""
    import pytest

    from conftest import random_csr
    from slim_tpu import native
    from slim_tpu import predict as P

    if not native.available():
        pytest.skip("no native toolchain")
    monkeypatch.setenv("SLIM_PREDICT_NATIVE_NPAD", "64")
    n = 300  # npad 512 > threshold: the npad rule alone says device

    # without stats the pure-npad rule applies
    assert not P.native_predict_applicable(n)

    sparse_model = random_csr(rng, n, n, density=0.02, seed=322)  # r~6
    dense_model = random_csr(rng, n, n, density=0.9, seed=323)    # r~270
    hist = random_csr(rng, 16, n, density=0.05, seed=324)         # h~15
    # h*r ~ 90 << 4*512            -> native
    assert P.native_predict_applicable(n, sparse_model, hist)
    # h*r ~ 4000 > 4*512 = 2048    -> device
    assert not P.native_predict_applicable(n, dense_model, hist)
    # alpha override flips the sparse case to device
    monkeypatch.setenv("SLIM_PREDICT_NATIVE_ALPHA", "0.01")
    assert not P.native_predict_applicable(n, sparse_model, hist)
    monkeypatch.delenv("SLIM_PREDICT_NATIVE_ALPHA")

    # the routed native call and the pinned device call agree
    calls = []
    orig = native.predict_topn

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(native, "predict_topn", spy)
    ni, nsc, nc = P.predict_topn(sparse_model, hist, nrcmds=5)
    assert calls, "sparse large-n unpinned call should route native"
    di, dsc, dc = P.predict_topn(sparse_model, hist, nrcmds=5, sparse=False)
    np.testing.assert_array_equal(nc, dc)
    for u in range(hist.nrows):
        k = int(dc[u])
        np.testing.assert_allclose(np.sort(nsc[u][:k]), np.sort(dsc[u][:k]),
                                   rtol=1e-5, atol=1e-6)


def test_native_csr_from_blocks(rng):
    """Threaded fragment assembly == from_ijv on concatenated fragments
    (unsorted in-row columns, empty fragments, empty rows, empty input)."""
    from slim_tpu import native
    from slim_tpu.types import CSR

    if not native.available():
        import pytest
        pytest.skip("native lib unavailable")

    n = 57
    frags = []
    taken = set()
    for f in range(5):
        m = [0, 13, 1, 40, 9][f]
        rows, cols = [], []
        while len(rows) < m:
            r, c = int(rng.integers(0, n)), int(rng.integers(0, n))
            if (r, c) in taken:
                continue
            taken.add((r, c))
            rows.append(r)
            cols.append(c)
        frags.append((np.array(rows, np.int32), np.array(cols, np.int32),
                      rng.random(m).astype(np.float32)))
    built = native.csr_from_blocks([f[0] for f in frags],
                                   [f[1] for f in frags],
                                   [f[2] for f in frags], n)
    assert built is not None
    got = CSR.from_arrays(n, n, *built)
    want = CSR.from_ijv(np.concatenate([f[0] for f in frags]),
                        np.concatenate([f[1] for f in frags]),
                        np.concatenate([f[2] for f in frags]),
                        nrows=n, ncols=n, no_duplicates=True)
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.values(), want.values())

    empty = native.csr_from_blocks([], [], [], 4)
    assert empty is not None and empty[0][-1] == 0 and empty[1].size == 0
