"""Gram-path parity: host SpGEMM vs device scatter-densify vs dense row
blocks, plus the batched union-flag screen against the per-block oracle.

Reference behavior restated: ATy[i] = (AᵀA)[i,j] (estimate.c:411-421), the
active-set screen keeps i with ATy[i] > l1r, i != j (estimate.c:424-430).
"""

import numpy as np
import pytest

from conftest import random_csr
from slim_tpu.ops.cd_kernel import block_union_flags, block_union_mask
from slim_tpu.ops.gram import (compute_gram, gram_device, gram_device_sparse,
                               gram_host)


def test_gram_paths_agree(rng):
    mat = random_csr(rng, 64, 48, density=0.2, implicit=False)
    gh = gram_host(mat, pad_to=128)
    gd = np.asarray(gram_device(mat, pad_to=128))
    gs = np.asarray(gram_device_sparse(mat, pad_to=128, row_block=16))
    np.testing.assert_allclose(gd, gh, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gs, gh, rtol=1e-5, atol=1e-5)


def test_gram_sparse_implicit_exact_counts(rng):
    # implicit data => G holds integer co-occurrence counts, exactly
    mat = random_csr(rng, 200, 60, density=0.15, implicit=True)
    gh = gram_host(mat, pad_to=128)
    gs = np.asarray(gram_device_sparse(mat, pad_to=128, row_block=64))
    assert np.array_equal(gs, gh)
    assert np.array_equal(gs, np.round(gs))


def test_compute_gram_modes(rng):
    mat = random_csr(rng, 50, 30, density=0.3, implicit=False)
    for mode in ("host", "device", "auto"):
        g = np.asarray(compute_gram(mat, mode, pad_to=128))
        np.testing.assert_allclose(g, gram_host(mat, pad_to=128),
                                   rtol=1e-5, atol=1e-5)


def test_union_flags_match_per_block_oracle(rng):
    import jax.numpy as jnp

    mat = random_csr(rng, 120, 100, density=0.12, implicit=False)
    npad, B = 128, 16
    G = jnp.asarray(gram_host(mat, pad_to=npad))
    nblocks = (mat.ncols + B - 1) // B
    l1r = 0.5
    u = np.asarray(block_union_flags(G, nblocks, B, l1r))
    assert u.shape == (nblocks, npad)
    for blk in range(nblocks):
        j_ids = np.minimum(np.arange(blk * B, blk * B + B), npad - 1)
        j_ids[blk * B + np.arange(B) >= mat.ncols] = npad - 1
        S, cnt = block_union_mask(G, jnp.asarray(j_ids), l1r, npad)
        oracle = np.zeros(npad, bool)
        oracle[np.asarray(S)[:int(cnt)]] = True
        assert np.array_equal(u[blk], oracle), f"block {blk}"


@pytest.mark.parametrize("kind", ["binary", "bf16_exact", "real", "long_rows"])
def test_gram_device_csr_parity(rng, kind):
    """The device Gram (CSR indices shipped, rows rebuilt on device, row
    blocks scatter-densified and contracted) against host SpGEMM: exact
    integer counts for binary data, exact for bf16-exact ratings (the
    single bf16 product path), f32-close for arbitrary values, and rows
    longer than a row block's average (power users)."""
    import scipy.sparse as sp

    from slim_tpu.ops.gram import gram_device_csr
    from slim_tpu.types import CSR

    if kind == "long_rows":
        dense = (rng.random((90, 100)) < 0.05).astype(np.float32)
        dense[3, :] = 1.0        # a 100-nnz power row
        dense[40, ::2] = 2.0
        mat = CSR.from_scipy(sp.csr_matrix(dense))
    else:
        mat = random_csr(rng, 700, 100, density=0.12,
                         implicit=(kind == "binary"))
        if kind == "real":
            mat = CSR.from_arrays(mat.nrows, mat.ncols, mat.indptr,
                                  mat.indices,
                                  rng.random(mat.nnz).astype(np.float32)
                                  + 0.1)
    gd = np.asarray(gram_device_csr(mat, pad_to=128, row_block=64))
    gh = gram_host(mat, pad_to=128)
    if kind == "real":
        np.testing.assert_allclose(gd, gh, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(gd, gh)


def test_compute_gram_auto_respects_device_memory(rng, monkeypatch):
    """mode='auto' takes the host SpGEMM when the dense G and the solver
    working set do not fit the device's memory limit, the device path
    when they do (and on backends that report no limit)."""
    from slim_tpu.ops import gram as gram_mod

    mat = random_csr(rng, 50, 30, density=0.3)
    calls = []
    monkeypatch.setattr(gram_mod, "gram_host",
                        lambda m, pad_to=None: calls.append("host") or
                        np.zeros((pad_to, pad_to), np.float32))
    monkeypatch.setattr(gram_mod, "gram_device_csr",
                        lambda m, pad_to=None: calls.append("device") or
                        np.zeros((pad_to, pad_to), np.float32))

    class Dev:
        def __init__(self, stats):
            self.stats = stats

        def memory_stats(self):
            return self.stats

    import jax
    npad = 1024
    need = 4 * (3 * npad * npad + 8 * 1024 * npad)
    for stats, want in [(None, "device"), ({"bytes_limit": need}, "device"),
                        ({"bytes_limit": need - 1}, "host")]:
        monkeypatch.setattr(jax, "local_devices", lambda s=stats: [Dev(s)])
        calls.clear()
        gram_mod.compute_gram(mat, "auto", pad_to=npad)
        assert calls == [want], (stats, calls)
