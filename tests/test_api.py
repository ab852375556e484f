"""End-to-end tests of the class API + the reference Automotive config
(BASELINE.json configs[0]): AutomotiveTrain.ijv -> CD l1r=l2r=1.0 ->
top-10 on AutomotiveTest.ijv."""

import numpy as np
import pytest

from conftest import (REFERENCE_TEST_DIR, random_csr,
                      reference_data_available)
from slim_tpu.api import SLIM, SLIMatrix
from slim_tpu.config import SlimConfig
from slim_tpu.eval import determine_head_tail, evaluate_topn
from slim_tpu.io.readers import read_matrix
from slim_tpu.predict import predict_topn
from slim_tpu.api import learn


def test_from_dict_niters_default_is_50():
    """The reference python package defaults niters to 50 in the dict API
    (core.py:87,165) -- not the C CLI's 10000."""
    assert SlimConfig.from_dict({}).maxniters == 50
    assert SlimConfig.from_dict({"niters": 7}).maxniters == 7
    assert SlimConfig.from_dict({"maxniters": 123}).maxniters == 123
    # constructing the dataclass directly keeps the C default
    assert SlimConfig().maxniters == 10000


def test_slimatrix_triplets():
    data = [[10, 100, 5.0], [10, 101, 3.0], [20, 100, 2.0], [30, 102, 4.0]]
    m = SLIMatrix(data)
    assert m.nUsers == 3 and m.nItems == 3
    assert m.mat.nnz == 4
    # id maps round-trip
    assert m.user2id[10] == 0 and m.item2id[102] == 2


def test_slimatrix_align_to_oldmat():
    base = SLIMatrix([[1, 7, 1.0], [2, 8, 1.0]])
    aligned = SLIMatrix([[1, 7, 2.0], [3, 9, 1.0]], oldmat=base)
    # user 3 / item 9 fall outside the old map -> dropped
    assert aligned.mat.nnz == 1


def test_train_predict_roundtrip(tmp_path, rng):
    mat = random_csr(rng, 50, 20, density=0.3, seed=21)
    trn = SLIMatrix(mat.to_scipy())
    model = SLIM()
    model.train({"l1r": 0.5, "l2r": 0.5}, trn)
    out = model.predict(trn, nrcmds=5)
    assert len(out) == 50
    assert all(len(v) == 5 for v in out.values())

    # save / load round-trip preserves predictions
    mfile, mapfile = str(tmp_path / "m.csr"), str(tmp_path / "m.map")
    model.save_model(mfile, mapfile)
    m2 = SLIM()
    m2.load_model(mfile, mapfile)
    out2 = m2.predict(trn, nrcmds=5)
    for k in out:
        np.testing.assert_array_equal(out[k], out2[k])

    # scipy export
    csr, imap = model.to_csr(returnmap=True)
    assert csr.shape == (20, 20)
    assert len(imap) == 20


def test_mselect_api(rng):
    mat = random_csr(rng, 60, 25, density=0.25, seed=33)
    tst = random_csr(rng, 60, 25, density=0.05, seed=34)
    trn = SLIMatrix(mat.to_scipy())
    tstm = SLIMatrix(tst.to_scipy())
    model = SLIM()
    res = model.mselect({"optTol": 1e-7}, trn, tstm, [0.1, 1.0], [0.5],
                        nrcmds=5)
    assert len(res["results"]) == 2
    assert res["best_model_hr"] is not None
    assert model.model is not None


@pytest.mark.skipif(not reference_data_available(),
                    reason="reference test data not mounted")
def test_automotive_end_to_end():
    """BASELINE.json configs[0]: the v0 'minimum slice' acceptance test.

    The reference publishes no numbers (BASELINE.md), so the oracle is
    plausibility: measured popularity-ranking baseline on this split is
    HR@10=0.047 / ARHR=0.018; SLIM with default regularisation lands
    ~0.106 / 0.053 (2.3x / 2.9x lift).  Assert we stay clearly above the
    popularity baseline."""
    trn = read_matrix(f"{REFERENCE_TEST_DIR}/AutomotiveTrain.ijv", fmt="ijv")
    tst = read_matrix(f"{REFERENCE_TEST_DIR}/AutomotiveTest.ijv", fmt="ijv")

    cfg = SlimConfig(l1r=1.0, l2r=1.0, block_size=512)
    model, stats = learn(trn, cfg)
    assert model.nnz > 0

    ncols = max(trn.infer_ncols().ncols, tst.infer_ncols().ncols)
    trn_w = trn.infer_ncols().with_ncols(ncols)
    tst_rows = tst.infer_ncols().with_ncols(ncols)
    # align row counts (ijv test file may reference fewer users)
    if tst_rows.nrows < trn_w.nrows:
        import numpy as _np
        indptr = _np.concatenate([
            tst_rows.indptr,
            _np.full(trn_w.nrows - tst_rows.nrows, tst_rows.indptr[-1])])
        from slim_tpu.types import CSR
        tst_rows = CSR.from_arrays(trn_w.nrows, ncols, indptr,
                                   tst_rows.indices, tst_rows.data)

    ids, scores, counts = predict_topn(model, trn_w, nrcmds=10)
    fmarker = determine_head_tail(trn_w, ncols)
    res = evaluate_topn(ids, counts, tst_rows, fmarker)
    print(f"Automotive: {res}")
    assert res.hr > 0.08, f"implausibly low HR@10: {res.hr}"
    assert res.arhr > 0.035
    assert stats["fit"] < stats["loss"]


def test_predict_caches_resident_sparse_model(rng, monkeypatch):
    """Above the dense threshold SLIM.predict must cache the padded-row
    (Widx, Wval) tuple so repeated serving calls don't rebuild/re-upload
    the model; results must match the dense path."""
    import slim_tpu.predict as P

    monkeypatch.setattr(P, "dense_predict_max_npad", lambda: 64)
    mat = random_csr(rng, 60, 100, density=0.15, seed=610)
    trn = SLIMatrix(mat.to_scipy())
    s = SLIM()
    s.train({"l1r": 1.0, "l2r": 1.0, "niters": 100}, trn)

    out = s.predict(trn, nrcmds=5)
    assert isinstance(s._W_dev, tuple)          # resident sparse model
    first = s._W_dev
    out2 = s.predict(trn, nrcmds=5)
    assert s._W_dev is first                    # reused, not rebuilt
    for k in out:
        np.testing.assert_array_equal(out[k], out2[k])

    # parity with the dense-W path on the same model
    di, dsc, dc = predict_topn(s.model, mat, nrcmds=5, sparse=False)
    si, ssc, sc = predict_topn(s.model, mat, nrcmds=5, W_dev=first)
    np.testing.assert_array_equal(dc, sc)
    np.testing.assert_allclose(dsc, ssc, rtol=1e-5, atol=1e-6)
