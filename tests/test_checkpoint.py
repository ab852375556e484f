"""Checkpoint/resume of column-block solves."""

import glob
import os

import numpy as np

from conftest import random_csr
from slim_tpu.config import SlimConfig
from slim_tpu.solvers.cd import estimate_model_cd


def test_checkpoint_resume_identical(tmp_path, rng):
    mat = random_csr(rng, 50, 40, density=0.25, seed=91)
    cfg = SlimConfig(l1r=0.4, l2r=0.6, block_size=16,
                     checkpoint_dir=str(tmp_path), shuffle=False)

    m1, s1 = estimate_model_cd(mat, cfg)
    files = glob.glob(str(tmp_path / "cdblk_*"))
    assert len(files) == (40 + 15) // 16  # one per block

    # simulate a crash that lost one block's result
    os.remove(files[1])
    m2, s2 = estimate_model_cd(mat, cfg)
    np.testing.assert_allclose(m1.to_scipy().toarray(),
                               m2.to_scipy().toarray(), atol=1e-7)
    np.testing.assert_allclose(s1["loss"], s2["loss"], rtol=1e-6)

    # different hyper-parameters must NOT reuse stale checkpoints
    cfg3 = cfg.replace(l1r=0.9)
    m3, _ = estimate_model_cd(mat, cfg3)
    assert m3.nnz != m1.nnz or not np.allclose(
        m3.to_scipy().toarray(), m1.to_scipy().toarray())


def test_checkpoint_keyed_by_warmstart_and_data(tmp_path, rng):
    """The signature must change with the warm-start model and with the
    matrix entries, not just the shape/nnz profile (stale-key hazard)."""
    from slim_tpu.solvers.cd import _Checkpoint

    mat = random_csr(rng, 50, 40, density=0.25, seed=93)
    imodel = random_csr(rng, 40, 40, density=0.1, seed=94)
    cfg = SlimConfig(l1r=0.4, l2r=0.6, checkpoint_dir=str(tmp_path))

    sig_plain = _Checkpoint(cfg, mat, 40).sig
    sig_warm = _Checkpoint(cfg, mat, 40, imodel).sig
    assert sig_plain != sig_warm

    # same shape profile, different entries
    mat2 = random_csr(rng, 50, 40, density=0.25, seed=95)
    assert _Checkpoint(cfg, mat2, 40).sig != sig_plain


def test_checkpoint_off_by_default(tmp_path, rng):
    mat = random_csr(rng, 30, 20, density=0.3, seed=92)
    estimate_model_cd(mat, SlimConfig(l1r=0.5, l2r=0.5))
    assert not glob.glob(str(tmp_path / "cdblk_*"))


def test_distributed_blockwise_checkpoint_resume(tmp_path, rng):
    """Per-superblock checkpoint/resume in the G-free distributed mode:
    a lost superblock is re-solved, everything else resumes from disk,
    and the result is identical (cluster-scale failure recovery)."""
    from slim_tpu.parallel.dist import distributed_learn_blockwise
    from slim_tpu.parallel.mesh import make_mesh

    mat = random_csr(rng, 60, 48, density=0.25, seed=96)
    mesh = make_mesh(8)
    cfg = SlimConfig(l1r=0.4, l2r=0.6, block_size=2,
                     checkpoint_dir=str(tmp_path), shuffle=False)

    m1, s1 = distributed_learn_blockwise(mat, cfg, mesh)
    files = sorted(glob.glob(str(tmp_path / "cdblk_*")))
    assert len(files) == (48 + 15) // 16     # one per Bsup=8*2 superblock

    os.remove(files[1])                       # crash lost one superblock
    m2, s2 = distributed_learn_blockwise(mat, cfg, mesh)
    np.testing.assert_allclose(m1.to_scipy().toarray(),
                               m2.to_scipy().toarray(), atol=1e-7)
    np.testing.assert_allclose(s1["loss"], s2["loss"], rtol=1e-6)

    # the single-device and distributed decompositions must not share
    # checkpoint files even under identical (data, cfg)
    m3, _ = estimate_model_cd(mat, cfg.replace(block_size=16))
    sd = sorted(glob.glob(str(tmp_path / "cdblk_*")))
    assert len(sd) > len(files)               # new files, distinct keys
    np.testing.assert_allclose(m1.to_scipy().toarray(),
                               m3.to_scipy().toarray(), atol=5e-4)
