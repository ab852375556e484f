import numpy as np
import pytest

from conftest import random_csr
from slim_tpu.predict import predict_topn, predict_topn_1vsk
from slim_tpu.types import CSR


def reference_scores(model_dense, hist_idx, hist_val):
    """Scalar re-statement of GetRecommendations scoring (predict.c:40-58)."""
    n = model_dense.shape[1]
    scores = np.zeros(n)
    for i, v in zip(hist_idx, hist_val):
        scores += v * model_dense[i]
    return scores


def test_predict_matches_reference_scoring(rng):
    n = 12
    W = (rng.random((n, n)) < 0.3) * rng.random((n, n)).astype(np.float32)
    np.fill_diagonal(W, 0)
    rows, cols = np.nonzero(W)
    model = CSR.from_ijv(rows, cols, W[rows, cols], nrows=n, ncols=n)

    hist = random_csr(rng, 6, n, density=0.3)
    ids, scores, counts = predict_topn(model, hist, nrcmds=5)

    for u in range(6):
        hidx = hist.indices[hist.indptr[u]:hist.indptr[u + 1]]
        hval = hist.values()[hist.indptr[u]:hist.indptr[u + 1]]
        ref = reference_scores(W, hidx, hval)
        ref[hidx] = -np.inf  # history exclusion
        ncand = int(np.sum(ref > 0))
        expect_k = min(ncand, 5)
        assert counts[u] == expect_k
        order = np.argsort(-ref)
        for r in range(expect_k):
            # ids match modulo ties; verify by score
            np.testing.assert_allclose(scores[u, r], ref[order[r]], rtol=1e-5)
        assert np.all(ids[u, expect_k:] == -1)


def test_predict_excludes_history(rng):
    n = 8
    W = np.ones((n, n), dtype=np.float32)
    np.fill_diagonal(W, 0)
    rows, cols = np.nonzero(W)
    model = CSR.from_ijv(rows, cols, W[rows, cols], nrows=n, ncols=n)
    hist = CSR.from_ijv([0, 0, 0], [1, 2, 3], [1.0, 1.0, 1.0], nrows=1, ncols=n)
    ids, scores, counts = predict_topn(model, hist, nrcmds=n)
    got = set(ids[0, :counts[0]].tolist())
    assert got.isdisjoint({1, 2, 3})


def test_predict_implicit_history(rng):
    n = 10
    W = rng.random((n, n)).astype(np.float32)
    np.fill_diagonal(W, 0)
    rows, cols = np.nonzero(W)
    model = CSR.from_ijv(rows, cols, W[rows, cols], nrows=n, ncols=n)
    hist_e = random_csr(rng, 4, n, density=0.4)
    ones = CSR.from_arrays(4, n, hist_e.indptr, hist_e.indices,
                           np.ones(hist_e.nnz, np.float32))
    imp = hist_e.binarize()
    ids_a, sc_a, _ = predict_topn(model, ones, nrcmds=4)
    ids_b, sc_b, _ = predict_topn(model, imp, nrcmds=4)
    np.testing.assert_allclose(sc_a, sc_b, rtol=1e-6)


def test_predict_1vsk(rng):
    n = 15
    W = (rng.random((n, n)) < 0.5) * rng.random((n, n)).astype(np.float32)
    np.fill_diagonal(W, 0)
    rows, cols = np.nonzero(W)
    model = CSR.from_ijv(rows, cols, W[rows, cols], nrows=n, ncols=n)
    hist = random_csr(rng, 3, n, density=0.4)

    neg = np.array([[1, 5, 9, 13], [0, 2, 4, 6], [3, 7, 11, 14]],
                   dtype=np.int32)
    ids, scores, counts = predict_topn_1vsk(model, hist, neg, nrcmds=3)
    for u in range(3):
        hidx = hist.indices[hist.indptr[u]:hist.indptr[u + 1]]
        hval = hist.values()[hist.indptr[u]:hist.indptr[u + 1]]
        full = reference_scores(W, hidx, hval)
        cand_scores = {int(c): full[c] for c in neg[u]}
        best = sorted(cand_scores.items(), key=lambda kv: -kv[1])[:3]
        got = [(int(i), float(s)) for i, s in zip(ids[u], scores[u])]
        # candidates only; scores descending and matching
        assert all(int(i) in set(neg[u].tolist()) for i, _ in got)
        np.testing.assert_allclose(sorted([s for _, s in got], reverse=True),
                                   [s for _, s in best], rtol=1e-5)


def test_predict_1vsk_history_not_excluded(rng):
    """GetRec_1vsk scores candidate items even when they are in the user's
    history (predict.c:93-121: marker only shields non-candidates)."""
    n = 6
    W = np.ones((n, n), dtype=np.float32)
    np.fill_diagonal(W, 0)
    rows, cols = np.nonzero(W)
    model = CSR.from_ijv(rows, cols, W[rows, cols], nrows=n, ncols=n)
    hist = CSR.from_ijv([0, 0], [1, 2], [1.0, 1.0], nrows=1, ncols=n)
    neg = np.array([[1, 4]], dtype=np.int32)  # item 1 is in history
    ids, scores, counts = predict_topn_1vsk(model, hist, neg, nrcmds=2)
    got = dict(zip(ids[0].tolist(), scores[0].tolist()))
    assert 1 in got  # history item still a candidate
    np.testing.assert_allclose(got[1], 1.0)  # only item2 contributes W[2,1]=1
    np.testing.assert_allclose(got[4], 2.0)


def test_predict_sparse_path_matches_dense(rng):
    """Large-N scoring path (padded-sparse model rows + scatter-add) must
    reproduce the dense gather+einsum path bit-for-bit in ids/counts and
    to f32 rounding in scores."""
    model = random_csr(rng, 64, 64, density=0.15, seed=200)
    hist = random_csr(rng, 37, 64, density=0.2, seed=201)
    di, dsc, dc = predict_topn(model, hist, nrcmds=7, sparse=False)
    si, ssc, sc = predict_topn(model, hist, nrcmds=7, sparse=True,
                               user_block=8)
    np.testing.assert_array_equal(dc, sc)
    # ties may order differently between the two reductions; compare the
    # recommended sets and the score multisets per user
    for u in range(hist.nrows):
        k = dc[u]
        assert set(di[u][:k]) == set(si[u][:k]), u
        np.testing.assert_allclose(np.sort(dsc[u][:k]), np.sort(ssc[u][:k]),
                                   rtol=1e-5, atol=1e-6)


def test_predict_sparse_implicit_history(rng):
    model = random_csr(rng, 40, 40, density=0.2, seed=210)
    hist = random_csr(rng, 20, 40, density=0.25, implicit=True, seed=211)
    di, dsc, dc = predict_topn(model, hist, nrcmds=5, sparse=False)
    si, ssc, sc = predict_topn(model, hist, nrcmds=5, sparse=True)
    np.testing.assert_array_equal(dc, sc)
    for u in range(hist.nrows):
        assert set(di[u][:dc[u]]) == set(si[u][:sc[u]])


def test_predict_1vsk_sparse_matches_dense(rng):
    model = random_csr(rng, 50, 50, density=0.2, seed=220)
    hist = random_csr(rng, 25, 50, density=0.2, seed=221)
    neg = rng.integers(0, 50, size=(25, 12)).astype(np.int32)
    di, dsc, _ = predict_topn_1vsk(model, hist, neg, nrcmds=6, sparse=False)
    si, ssc, _ = predict_topn_1vsk(model, hist, neg, nrcmds=6, sparse=True,
                                   user_block=8)
    np.testing.assert_allclose(np.sort(dsc, axis=1), np.sort(ssc, axis=1),
                               rtol=1e-5, atol=1e-6)
    for u in range(25):
        assert set(di[u]) == set(si[u]), u


def test_predict_scan_matches_block(rng):
    """The one-dispatch scan path must reproduce the per-block dense path
    (same kernel math, different orchestration), for explicit and implicit
    histories and for a user count that is not a block multiple."""
    model = random_csr(rng, 60, 60, density=0.2, seed=230)
    for implicit, seed in ((False, 231), (True, 232)):
        hist = random_csr(rng, 53, 60, density=0.2, implicit=implicit,
                          seed=seed)
        bi, bsc, bc = predict_topn(model, hist, nrcmds=7, sparse=False,
                                   scan=False)
        si, ssc, sc = predict_topn(model, hist, nrcmds=7, sparse=False,
                                   scan=True, user_block=16)
        np.testing.assert_array_equal(bc, sc)
        for u in range(hist.nrows):
            k = bc[u]
            assert set(bi[u][:k]) == set(si[u][:k]), u
            np.testing.assert_allclose(np.sort(bsc[u][:k]),
                                       np.sort(ssc[u][:k]),
                                       rtol=1e-5, atol=1e-6)


def test_predict_sparse_200k_item_catalogue():
    """North-star regime smoke (BASELINE configs[4] shape, scaled): a
    200k-item catalogue is only servable through the padded-sparse path
    (a dense W would be 160GB); checks top-N against a scipy oracle.

    Reference semantics anchor: predict.c:40-66 (score = sum over history
    of the items' model rows; history excluded; count = #positive)."""
    import scipy.sparse as sp

    n = 200_000
    nusers = 64
    rng = np.random.default_rng(400)
    # model: ~12 nnz per item row, nonnegative values
    nnz_m = 12 * n
    mr = rng.integers(0, n, nnz_m)
    mc = rng.integers(0, n, nnz_m)
    mv = rng.random(nnz_m, dtype=np.float32) + 0.01
    model = CSR.from_ijv(mr, mc, mv, nrows=n, ncols=n)
    hr = np.repeat(np.arange(nusers), 20)
    hc = rng.integers(0, n, hr.size)
    hv = np.ones(hr.size, np.float32)
    hist = CSR.from_ijv(hr, hc, hv, nrows=nusers, ncols=n)

    ids, scores, counts = predict_topn(model, hist, nrcmds=10, sparse=True,
                                       user_block=16)
    # one-dispatch scan path (+ the two-stage wide top-k it engages at
    # this npad) must agree with the per-block path checked below
    si, ssc, sc = predict_topn(model, hist, nrcmds=10, sparse=True,
                               user_block=16, scan=True)
    np.testing.assert_array_equal(counts, sc)
    for u in range(nusers):
        k = int(counts[u])
        assert set(ids[u][:k]) == set(si[u][:k]), u
        np.testing.assert_allclose(np.sort(scores[u][:k]),
                                   np.sort(ssc[u][:k]), rtol=1e-5,
                                   atol=1e-6)

    W = sp.csr_matrix((model.values(), model.indices, model.indptr),
                      shape=(n, n))
    H = sp.csr_matrix((hist.values(), hist.indices, hist.indptr),
                      shape=(nusers, n))
    S = np.asarray((H @ W).todense())
    for u in range(nusers):
        s = S[u].copy()
        s[hist.indices[hist.indptr[u]:hist.indptr[u + 1]]] = -np.inf
        k = int(counts[u])
        assert k == min(10, int((s > 0).sum()))
        top_ref = np.sort(s)[::-1][:k]
        np.testing.assert_allclose(np.sort(scores[u][:k])[::-1], top_ref,
                                   rtol=1e-4, atol=1e-4)


def test_predict_sparse_scan_matches_block(rng):
    """The one-dispatch sparse scan path must reproduce the per-block
    sparse path (same gather/scatter-add math, different orchestration),
    for explicit and implicit histories, a non-multiple user count, and a
    resident (Widx, Wval) model passed through W_dev."""
    from slim_tpu.predict import sparsify_model_device

    model = random_csr(rng, 60, 60, density=0.2, seed=240)
    Wsp = sparsify_model_device(model)
    for implicit, seed in ((False, 241), (True, 242)):
        hist = random_csr(rng, 53, 60, density=0.2, implicit=implicit,
                          seed=seed)
        bi, bsc, bc = predict_topn(model, hist, nrcmds=7, sparse=True,
                                   scan=False)
        si, ssc, sc = predict_topn(model, hist, nrcmds=7, W_dev=Wsp,
                                   scan=True, user_block=16)
        np.testing.assert_array_equal(bc, sc)
        for u in range(hist.nrows):
            k = bc[u]
            assert set(bi[u][:k]) == set(si[u][:k]), u
            np.testing.assert_allclose(np.sort(bsc[u][:k]),
                                       np.sort(ssc[u][:k]),
                                       rtol=1e-5, atol=1e-6)


def test_predict_power_user_skewed_history(rng):
    """One power user whose history covers most of the catalogue (the
    round-1 OOM shape: max row nnz sets H for everyone) must not distort
    anyone's results, on every orchestration path."""
    import scipy.sparse as sp

    n, nusers = 300, 40
    model = random_csr(rng, n, n, density=0.05, seed=260)
    hr = [0] * (n - 10) + list(np.repeat(np.arange(1, nusers), 5))
    hc = list(range(n - 10)) + list(rng.integers(0, n, 5 * (nusers - 1)))
    hist = CSR.from_ijv(np.asarray(hr), np.asarray(hc),
                        np.ones(len(hr), np.float32), nusers, n).binarize()

    W = sp.csr_matrix((model.values(), model.indices, model.indptr),
                      shape=(n, n))
    H = sp.csr_matrix((hist.values(), hist.indices, hist.indptr),
                      shape=(nusers, n))
    S = np.asarray((H @ W).todense())

    for kw in (dict(sparse=False, scan=False), dict(sparse=False, scan=True),
               dict(sparse=True, scan=False), dict(sparse=True, scan=True)):
        ids, scores, counts = predict_topn(model, hist, nrcmds=10,
                                           user_block=16, **kw)
        for u in range(nusers):
            s = S[u].copy()
            s[hist.indices[hist.indptr[u]:hist.indptr[u + 1]]] = -np.inf
            k = int(counts[u])
            assert k == min(10, int((s > 0).sum())), (kw, u)
            np.testing.assert_allclose(
                np.sort(scores[u][:k])[::-1], np.sort(s)[::-1][:k],
                rtol=1e-5, atol=1e-5, err_msg=str((kw, u)))


def test_predict_coo_scan_matches_block(rng, monkeypatch):
    """The COO segment-top-k scan (no npad-wide score rows) must match the
    per-block sparse path on ids/counts and scores, including history
    exclusion, implicit histories, empty-history users and score ties."""
    from slim_tpu.predict import sparsify_model_device

    model = random_csr(rng, 70, 70, density=0.15, seed=270)
    Wsp = sparsify_model_device(model)
    for implicit, seed in ((False, 271), (True, 272)):
        hist = random_csr(rng, 45, 70, density=0.15, implicit=implicit,
                          seed=seed)
        monkeypatch.setenv("SLIM_PREDICT_COO_NPAD", "0")  # dense-row ref
        bi, bsc, bc = predict_topn(model, hist, nrcmds=7, sparse=True,
                                   scan=False)
        monkeypatch.setenv("SLIM_PREDICT_COO_NPAD", "1")  # force COO
        si, ssc, sc = predict_topn(model, hist, nrcmds=7, W_dev=Wsp,
                                   scan=True, user_block=16)
        # the per-block path also routes to the COO kernel above the
        # threshold; check it against the same dense-row reference
        ci, csc_, cc = predict_topn(model, hist, nrcmds=7, W_dev=Wsp,
                                    scan=False, user_block=16)
        np.testing.assert_array_equal(bc, cc)
        for u in range(hist.nrows):
            k = bc[u]
            assert set(bi[u][:k]) == set(ci[u][:k]), (implicit, u)
        np.testing.assert_array_equal(bc, sc)
        for u in range(hist.nrows):
            k = bc[u]
            assert set(bi[u][:k]) == set(si[u][:k]), (implicit, u)
            np.testing.assert_allclose(np.sort(bsc[u][:k]),
                                       np.sort(ssc[u][:k]),
                                       rtol=1e-5, atol=1e-6)


def test_predict_coo_scan_200k_oracle(monkeypatch):
    """COO path at a large catalogue vs the scipy oracle (same workload as
    test_predict_sparse_200k_item_catalogue)."""
    import scipy.sparse as sp

    monkeypatch.setenv("SLIM_PREDICT_COO_NPAD", "1")
    n, nusers = 200_000, 64
    rng = np.random.default_rng(400)
    nnz_m = 12 * n
    mr = rng.integers(0, n, nnz_m)
    mc = rng.integers(0, n, nnz_m)
    mv = rng.random(nnz_m, dtype=np.float32) + 0.01
    model = CSR.from_ijv(mr, mc, mv, nrows=n, ncols=n)
    hr = np.repeat(np.arange(nusers), 20)
    hc = rng.integers(0, n, hr.size)
    hist = CSR.from_ijv(hr, hc, np.ones(hr.size, np.float32),
                        nrows=nusers, ncols=n)

    ids, scores, counts = predict_topn(model, hist, nrcmds=10, sparse=True,
                                       user_block=16, scan=True)

    W = sp.csr_matrix((model.values(), model.indices, model.indptr),
                      shape=(n, n))
    H = sp.csr_matrix((hist.values(), hist.indices, hist.indptr),
                      shape=(nusers, n))
    S = np.asarray((H @ W).todense())
    for u in range(nusers):
        s = S[u].copy()
        s[hist.indices[hist.indptr[u]:hist.indptr[u + 1]]] = -np.inf
        k = int(counts[u])
        assert k == min(10, int((s > 0).sum())), u
        np.testing.assert_allclose(np.sort(scores[u][:k])[::-1],
                                   np.sort(s)[::-1][:k],
                                   rtol=1e-4, atol=1e-4)


def test_predict_coo_candidate_paths_match_dense(rng, monkeypatch):
    """COO searchsorted-join candidate scoring (neg-file + 1vsk) must
    match the dense paths: history exclusion + scored counts for
    predict_candidate_scores, history-kept raw scores for 1vsk."""
    from slim_tpu.predict import predict_candidate_scores

    model = random_csr(rng, 60, 60, density=0.2, seed=280)
    hist = random_csr(rng, 30, 60, density=0.2, seed=281)
    cand = rng.integers(-1, 60, size=(30, 9)).astype(np.int32)
    # plant history items among candidates to exercise the exclusion
    cand[0, 0] = hist.indices[hist.indptr[0]] if hist.row_nnz()[0] else 0

    dcs, dns = predict_candidate_scores(model, hist, cand, sparse=False)
    monkeypatch.setenv("SLIM_PREDICT_COO_NPAD", "1")
    ccs, cns = predict_candidate_scores(model, hist, cand, sparse=True,
                                        user_block=8)
    np.testing.assert_array_equal(dns, cns)
    np.testing.assert_allclose(dcs, ccs, rtol=1e-5, atol=1e-6)

    neg = rng.integers(0, 60, size=(30, 8)).astype(np.int32)
    di, dsc, _ = predict_topn_1vsk(model, hist, neg, nrcmds=5, sparse=False)
    si, ssc, _ = predict_topn_1vsk(model, hist, neg, nrcmds=5, sparse=True,
                                   user_block=8)
    np.testing.assert_allclose(np.sort(dsc, axis=1), np.sort(ssc, axis=1),
                               rtol=1e-5, atol=1e-6)
    for u in range(30):
        assert set(di[u]) == set(si[u]), u


def test_pack_topn_ids_exact_beyond_f32_integers():
    """Packed top-N blocks bitcast ids through the f32 lanes, so item ids
    beyond 2^24 (e.g. a 100M-item catalogue) survive exactly."""
    import jax.numpy as jnp

    from slim_tpu.predict import _pack_topn, _unpack_topn

    ids = jnp.asarray([[2 ** 24 + 1, 2 ** 30 - 3, -1]], jnp.int32)
    sc = jnp.asarray([[0.5, 0.25, 0.0]], jnp.float32)
    counts = jnp.asarray([2], jnp.int32)
    out_i, out_s, out_c = _unpack_topn(np.asarray(
        _pack_topn(ids, sc, counts, 3)), 3)
    np.testing.assert_array_equal(out_i, [[2 ** 24 + 1, 2 ** 30 - 3, -1]])
    np.testing.assert_allclose(out_s, [[0.5, 0.25, 0.0]])
    np.testing.assert_array_equal(out_c, [2])


def test_topk_wide_matches_single_pass_at_bucketed_npads():
    """Two-stage top-k must engage and be exact at 4096-multiple bucketed
    widths that are NOT 32768-multiples (e.g. bucket_npad(200000)=200704)."""
    import jax.numpy as jnp
    import jax

    from slim_tpu.predict import _topk_wide

    rng = np.random.default_rng(5)
    scores = jnp.asarray(rng.standard_normal((4, 200704)), jnp.float32)
    ts, ti = _topk_wide(scores, 10)
    rs, ri = jax.lax.top_k(scores, 10)
    np.testing.assert_allclose(np.asarray(ts), np.asarray(rs))
    # ids may differ on exact ties only; values above rule that out here
    np.testing.assert_array_equal(np.asarray(ti), np.asarray(ri))


def test_sparse_model_bf16_values(rng, monkeypatch):
    """SLIM_PREDICT_WVAL_BF16=1 stores the resident sparse model's values
    as bfloat16 (half the value memory/bandwidth); scores still accumulate
    in f32, so results match the f32 model to bf16 rounding."""
    from conftest import random_csr
    from slim_tpu.predict import predict_topn, sparsify_model_device

    model = random_csr(rng, 80, 80, density=0.15, seed=501)
    hist = random_csr(rng, 25, 80, density=0.2, seed=502)

    Wf = sparsify_model_device(model)
    assert str(Wf[1].dtype) == "float32"
    fi, fsc, fc = predict_topn(model, hist, nrcmds=6, W_dev=Wf, sparse=True)

    monkeypatch.setenv("SLIM_PREDICT_WVAL_BF16", "1")
    Wb = sparsify_model_device(model)
    assert str(Wb[1].dtype) == "bfloat16"
    bi, bsc, bc = predict_topn(model, hist, nrcmds=6, W_dev=Wb, sparse=True)

    np.testing.assert_array_equal(fc, bc)
    np.testing.assert_allclose(bsc, fsc, rtol=2e-2, atol=1e-3)
    # ranked ids may only swap at bf16-rounding-scale score gaps
    for u in range(hist.nrows):
        k = int(fc[u])
        same = set(fi[u][:k]) & set(bi[u][:k])
        assert len(same) >= k - 1


def _host_topn(W, hist, n, k):
    """numpy oracle of the dense scoring (predict.c:40-66): history-masked
    scores, candidates = positive scores, top-k by descending score."""
    H = hist.to_scipy().toarray().astype(np.float64)[:, :n]
    S = H @ W[:n, :n].astype(np.float64)
    S[H != 0] = -np.inf
    ids = np.argsort(-S, axis=1, kind="stable")[:, :k]
    sc = np.take_along_axis(S, ids, axis=1)
    cnt = np.minimum((S > 0).sum(axis=1), k)
    return ids, sc, cnt


def _check_scan_against_host(train, k, implicit):
    import jax

    from slim_tpu.config import SlimConfig
    from slim_tpu.predict import _bucket, _predict_topn_scan, densify_model
    from slim_tpu.solvers.cd import estimate_model_cd

    n = train.ncols
    model, _ = estimate_model_cd(train, SlimConfig(l1r=0.2, l2r=0.5))
    npad = _bucket(n)
    W = densify_model(model, npad)
    ids, sc, cnt = _predict_topn_scan(train, k, 256, W, n, npad,
                                      jax.lax.Precision.HIGHEST)
    eids, esc, ecnt = _host_topn(np.asarray(W), train, n, k)
    np.testing.assert_array_equal(cnt, ecnt)
    for u in range(train.nrows):
        c = int(cnt[u])
        np.testing.assert_allclose(sc[u, :c], esc[u, :c], rtol=1e-5,
                                   atol=1e-6)
        # distinct random scores => identical rankings
        np.testing.assert_array_equal(ids[u, :c], eids[u, :c])
        assert (ids[u, c:] == -1).all()


def test_predict_densify_scan_parity(rng):
    """The dense serving scan (history scatter-densified per user block on
    device, one product against W) reproduces the host oracle on weighted
    histories, across several scan blocks."""
    train = random_csr(rng, 600, 90, density=0.08, implicit=False)
    _check_scan_against_host(train, 10, implicit=False)


def test_predict_densify_scan_parity_binary(rng):
    train = random_csr(rng, 500, 70, density=0.1, implicit=True)
    _check_scan_against_host(train, 5, implicit=True)


def test_pack_densify_scatter_parity(rng):
    """DeviceModelPack's scatter densify maps rank-space runs back to item
    space exactly: long runs, empty runs and rank-padding runs (dropped)
    included."""
    import jax.numpy as jnp

    import slim_tpu.predict as P

    npad, n = 256, 250
    rs = np.zeros(npad, np.int32)
    rl = np.zeros(npad, np.int32)
    lens = rng.integers(0, 12, npad)
    lens[3] = 100          # one long run
    lens[n:] = rng.integers(0, 4, npad - n)  # rank-padding runs
    ids, vals = [], []
    pos = 0
    for r in range(npad):
        rs[r], rl[r] = pos, lens[r]
        c = rng.choice(npad, size=lens[r], replace=False).astype(np.int64)
        ids.append(c)
        vals.append(rng.normal(size=lens[r]).astype(np.float32))
        pos += lens[r]
    total = pos
    Tb = total + 7          # unaligned tail like the nnz bucket pad
    idx = np.zeros(Tb, np.uint16)
    val = np.zeros(Tb, np.float32)
    idx[:total] = np.concatenate(ids).astype(np.uint16)
    val[:total] = np.concatenate(vals)
    p = rng.permutation(n).astype(np.int64)
    p_pad = np.concatenate([p, np.arange(n, npad)]).astype(np.uint16)
    posmap_pad = np.empty(npad, np.int32)
    posmap_pad[p_pad.astype(np.int64)] = np.arange(npad, dtype=np.int32)

    pack = P.DeviceModelPack(jnp.asarray(val), jnp.asarray(idx),
                             rs, rl, p_pad, posmap_pad, n, npad)
    got = np.asarray(pack.densify())
    # oracle: run r (target rank r -> item p_pad[r]) holds rank coords
    # ids[r] -> item rows p_pad[ids[r]]; coords >= n are dropped
    ref = np.zeros((npad, npad), np.float32)
    for r in range(npad):
        keep = ids[r] < n
        np.add.at(ref, (p_pad[ids[r][keep]].astype(np.int64),
                        int(p_pad[r])), vals[r][keep])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert np.abs(ref).sum() > 0


def test_pack_topn_lanes_are_normal_floats():
    """Fusions may flush DENORMAL f32 lanes to zero (raw-bitcast ids would
    come back all-0 through the lax.scan output stacking while
    normal-range scores survive).  The pack must therefore encode ids so
    every lane is a normal float; this pins the property on CPU where no
    flush would catch a regression."""
    import jax.numpy as jnp

    from slim_tpu.predict import _pack_topn, _unpack_topn

    ids = jnp.asarray(np.array([[0, 1, 2], [27000, 1 << 24, -1]], np.int32))
    sc = jnp.asarray(np.array([[.5, .4, .3], [9., 8., 7.]], np.float32))
    counts = jnp.asarray(np.array([3, 2], np.int32))
    packed = np.asarray(_pack_topn(ids, sc, counts, 3))
    lanes = np.abs(packed[:, :3])
    # normal f32 range, no denormals / NaN / inf anywhere in the id lanes
    assert np.isfinite(lanes).all()
    assert (lanes >= np.finfo(np.float32).tiny).all()
    out_ids, out_sc, out_cnt = _unpack_topn(packed, 3)
    np.testing.assert_array_equal(out_ids,
                                  [[0, 1, 2], [27000, 1 << 24, -1]])
    np.testing.assert_array_equal(out_cnt, [3, 2])
    np.testing.assert_allclose(out_sc, [[.5, .4, .3], [9., 8., 0.]])


def test_densify_model_device_parity(rng):
    """The model-upload densify (CSR rows scattered on device) equals the
    host densify, duplicate (row, col) entries accumulating."""
    import jax.numpy as jnp

    from slim_tpu.predict import densify_model_device
    from slim_tpu.types import CSR

    n, npad = 300, 384
    rows = rng.integers(0, n, 4000)
    cols = rng.integers(0, n, 4000)
    vals = rng.random(4000).astype(np.float32)
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr)
    order = np.argsort(rows, kind="stable")
    model = CSR.from_arrays(n, n, indptr, cols[order].astype(np.int32),
                            vals[order])
    W_host = np.zeros((npad, npad), np.float32)
    np.add.at(W_host, (rows, cols), vals)
    got = np.asarray(densify_model_device(model, npad))
    np.testing.assert_allclose(got, W_host, rtol=1e-6, atol=1e-5)


GIB = 1 << 30


@pytest.mark.parametrize("stats,want", [
    (None, "host"),
    ({"bytes_limit": 4 * 1000 ** 2 + GIB}, 1000),
    ({"bytes_limit": 4 * 1000 ** 2 + GIB, "bytes_in_use": 8 * GIB}, 1000),
    ({"bytes_limit": GIB // 2}, 0),
])
def test_dense_predict_max_npad_from_limit(stats, want, monkeypatch):
    """Dense serving's limit comes from the device's bytes_limit alone (W
    plus a 1 GiB scan block), whatever is allocated when it is asked."""
    import jax

    import slim_tpu.predict as P

    class Dev:
        def memory_stats(self):
            return stats

    monkeypatch.setattr(jax, "local_devices", lambda: [Dev()])
    if want == "host":
        want = P.HOST_DENSE_PREDICT_NPAD
    assert P.dense_predict_max_npad() == want
