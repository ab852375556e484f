"""Union-active-set compacted solves (the large-catalogue regime) must be
exactly equivalent to the full-width path."""

import numpy as np
import pytest

from conftest import random_csr
from slim_tpu.config import SlimConfig
from slim_tpu.solvers.cd import estimate_model_cd


def test_compact_matches_full(rng):
    mat = random_csr(rng, 80, 50, density=0.2, seed=140)
    base = SlimConfig(l1r=0.4, l2r=0.7, optTol=1e-12, block_size=16,
                      shuffle=False)
    full, sf = estimate_model_cd(mat, base.replace(compact_threshold=10**9))
    comp, sc = estimate_model_cd(mat, base.replace(compact_threshold=128))
    np.testing.assert_allclose(comp.to_scipy().toarray(),
                               full.to_scipy().toarray(), atol=5e-4)
    np.testing.assert_allclose(sc["loss"], sf["loss"], rtol=1e-4)
    np.testing.assert_allclose(sc["fit"], sf["fit"], rtol=1e-4)


def test_compact_with_warm_start(rng):
    mat = random_csr(rng, 60, 40, density=0.25, seed=141)
    cfg = SlimConfig(l1r=0.3, l2r=0.5, optTol=1e-12, block_size=16,
                     shuffle=False, compact_threshold=128)
    cold, s_cold = estimate_model_cd(mat, cfg)
    warm, s_warm = estimate_model_cd(mat, cfg, imodel=cold)
    np.testing.assert_allclose(cold.to_scipy().toarray(),
                               warm.to_scipy().toarray(), atol=5e-4)
    assert s_warm["niters"] <= s_cold["niters"]


def test_compact_high_l1_small_unions(rng):
    """With strong l1 the unions collapse to tiny K buckets and the model
    empties -- the compact path must handle near-empty active sets."""
    mat = random_csr(rng, 50, 40, density=0.2, seed=142)
    cfg = SlimConfig(l1r=1e9, l2r=1.0, compact_threshold=128, block_size=16)
    model, stats = estimate_model_cd(mat, cfg)
    assert model.nnz == 0


def test_compact_fslim_matches_full(rng):
    mat = random_csr(rng, 60, 45, density=0.25, seed=150)
    base = SlimConfig(l1r=0.2, l2r=0.5, nnbrs=4, simtype="cos",
                      optTol=1e-12, block_size=16, shuffle=False)
    full, sf = estimate_model_cd(mat, base.replace(compact_threshold=10**9))
    comp, sc = estimate_model_cd(mat, base.replace(compact_threshold=128))
    np.testing.assert_allclose(comp.to_scipy().toarray(),
                               full.to_scipy().toarray(), atol=5e-4)
    np.testing.assert_allclose(sc["loss"], sf["loss"], rtol=1e-4)


def test_pack_flat_exact(rng):
    """The exact-size flat harvest pack must enumerate precisely the
    entries > eps, grouped by column at the host-computed offsets, in
    ascending coordinate order -- for both index dtypes."""
    import jax.numpy as jnp

    from slim_tpu.ops.cd_kernel import count_over, pack_flat

    eps = 1e-7
    x = rng.random((13, 96)).astype(np.float32)
    x[x < 0.6] = 0.0
    x[3] = 0.0                       # empty column
    cnt = np.asarray(count_over(jnp.asarray(x), eps))
    np.testing.assert_array_equal(cnt, (x > eps).sum(axis=1))
    off = np.zeros(13, np.int32)
    np.cumsum(cnt[:-1], out=off[1:])
    T = int(cnt.sum())
    for idx16 in (True, False):
        Tpad = 1 << (T - 1).bit_length()
        fv, fi = pack_flat(jnp.asarray(x), eps, jnp.asarray(off),
                           Tpad, idx16)
        fv, fi = np.asarray(fv)[:T], np.asarray(fi)[:T].astype(np.int64)
        for b in range(13):
            cols = np.nonzero(x[b] > eps)[0]
            s = int(off[b])
            np.testing.assert_array_equal(fi[s:s + len(cols)], cols)
            np.testing.assert_array_equal(fv[s:s + len(cols)], x[b, cols])


def test_compact_frac_snap_is_exact(monkeypatch):
    """Unions snapped to full width by SLIM_COMPACT_FRAC (the high-l1
    OOM guard: the compact launch's (K, npad)+(K, K) workspace outweighs
    its sweep saving near full width) must produce the identical model."""
    import numpy as np

    from conftest import random_csr
    from slim_tpu.config import SlimConfig
    from slim_tpu.solvers.cd import estimate_model_cd

    train = random_csr(None, 150, 300, density=0.08, seed=42).infer_ncols()
    cfg = SlimConfig(l1r=0.8, l2r=0.8, optTol=1e-9, block_size=32,
                     compact_threshold=64)
    m_compact, _ = estimate_model_cd(train, cfg)
    monkeypatch.setenv("SLIM_COMPACT_FRAC", "0.0")   # snap EVERY union
    m_full, _ = estimate_model_cd(train, cfg)
    assert m_compact.nnz == m_full.nnz
    np.testing.assert_array_equal(m_compact.indices, m_full.indices)
    np.testing.assert_allclose(m_compact.values(), m_full.values(),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("f", [2, 4])
def test_group_union_flags_match_direct_screen(f):
    """Wider blocks' union flags ORed from narrower ones equal the
    direct screen at the wider block (self-exclusion included)."""
    import jax.numpy as jnp

    from slim_tpu.ops.cd_kernel import block_union_flags, group_union_flags

    rng = np.random.default_rng(f)
    n, npad, B = 100, 128, 8
    A = (rng.random((60, n)) < 0.1).astype(np.float32)
    G = np.zeros((npad, npad), np.float32)
    G[:n, :n] = A.T @ A
    u = block_union_flags(jnp.asarray(G), -(-n // B), B, 1.0)
    got, cnt = group_union_flags(u, f)
    want = block_union_flags(jnp.asarray(G), -(-n // (B * f)), B * f, 1.0)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    np.testing.assert_array_equal(np.asarray(cnt),
                                  np.asarray(want).sum(axis=1))


@pytest.mark.parametrize("band,want", [(None, 256), (200, 64)])
def test_compact_block_size_from_union_widths(band, want):
    """Unions that stay full width take the largest candidate block;
    unions that grow with the block (a banded Gram) take the smallest."""
    import jax.numpy as jnp

    from slim_tpu.solvers.cd import _compact_block_size, bucket_npad

    n = 3000
    npad = bucket_npad(n)
    i = np.arange(n)
    near = np.ones((n, n), bool) if band is None else \
        np.abs(i[:, None] - i[None, :]) < band
    G = np.zeros((npad, npad), np.float32)
    G[:n, :n] = np.where(near, 2.0, 0.0)
    B, u = _compact_block_size(jnp.asarray(G), n, npad, 128, 256, 1.0)
    assert B == want
    assert u.shape == (-(-n // B), npad)
