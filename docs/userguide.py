"""slim_tpu user guide — executable walkthrough of every public API.

Mirrors the coverage of the reference's python-package/UserGuide.ipynb:
all four ingestion paths, train, save/load, predict, 1-vs-k predict,
mselect, FSLIM, ADMM, and the scipy export.

Run:  python docs/userguide.py   (uses synthetic data; ~1 min on CPU)
"""

import numpy as np
import scipy.sparse as sp

from slim_tpu import (SLIM, SLIMatrix, SlimConfig, learn, evaluate_topn,
                      determine_head_tail, predict_topn)
from slim_tpu.types import CSR

rng = np.random.default_rng(0)

# --------------------------------------------------------------------- #
# 1. Ingestion: four equivalent ways to build a SLIMatrix
# --------------------------------------------------------------------- #
nusers, nitems = 120, 60
dense = (rng.random((nusers, nitems)) < 0.15) * \
    rng.integers(1, 6, (nusers, nitems))

# (a) scipy CSR
m_scipy = SLIMatrix(sp.csr_matrix(dense.astype(np.float32)))

# (b) (user, item, rating) triplets as a list / ndarray
rows, cols = np.nonzero(dense)
triplets = np.stack([rows, cols, dense[rows, cols]], axis=1)
m_tri = SLIMatrix(triplets)

# (c) pandas DataFrame (same columns)
try:
    import pandas as pd

    m_df = SLIMatrix(pd.DataFrame(triplets, columns=["u", "i", "r"]))
except ImportError:
    m_df = m_tri

# (d) slim_tpu CSR directly
m_csr = SLIMatrix(CSR.from_scipy(sp.csr_matrix(dense.astype(np.float32))))

# --------------------------------------------------------------------- #
# 2. Train (dict params use the reference's knob names)
# --------------------------------------------------------------------- #
model = SLIM()
model.train({"l1r": 0.5, "l2r": 1.0, "optTol": 1e-7, "niters": 1000}, m_scipy)

# --------------------------------------------------------------------- #
# 3. Predict top-N (history items are never recommended)
# --------------------------------------------------------------------- #
topn = model.predict(m_scipy, nrcmds=5)
print("user 0 recommendations:", topn[0])

# 1-vs-k: score only a supplied candidate list per user
negitems = {u: rng.choice(nitems, size=8, replace=False).tolist()
            for u in range(nusers)}
top1vsk = model.predict(m_scipy, nrcmds=5, negitems=negitems, nnegs=8)

# --------------------------------------------------------------------- #
# 4. Save / load round-trip (+ item-map sidecar, core.py:615-655 parity)
# --------------------------------------------------------------------- #
model.save_model("/tmp/slim_demo.model", "/tmp/slim_demo.map")
m2 = SLIM()
m2.load_model("/tmp/slim_demo.model", "/tmp/slim_demo.map")

# scipy export
W, item_map = m2.to_csr(returnmap=True)
print("model:", W.shape, "nnz", W.nnz)

# --------------------------------------------------------------------- #
# 5. Model selection: warm-started grid sharing one Gram matrix
# --------------------------------------------------------------------- #
test_dense = (rng.random((nusers, nitems)) < 0.03) * 1.0
m_test = SLIMatrix(sp.csr_matrix(test_dense.astype(np.float32)))
res = model.mselect({"optTol": 1e-7}, m_scipy, m_test,
                    arrayl1=[0.1, 1.0], arrayl2=[0.5, 2.0], nrcmds=5)
print("best HR point:", res["bestl1HR"], res["bestl2HR"], res["bestHRHR"])

# --------------------------------------------------------------------- #
# 6. FSLIM (neighbour-restricted) and ADMM variants
# --------------------------------------------------------------------- #
fslim = SLIM()
fslim.train({"l1r": 0.5, "l2r": 1.0, "nnbrs": 10, "simtype": "cos"}, m_scipy)

admm = SLIM()
admm.train({"l1r": 1.0, "l2r": 1.0, "algo": "admm"}, m_scipy)

# --------------------------------------------------------------------- #
# 7. Functional API + explicit evaluation
# --------------------------------------------------------------------- #
train_csr = CSR.from_scipy(sp.csr_matrix(dense.astype(np.float32)))
test_csr = CSR.from_scipy(sp.csr_matrix(test_dense.astype(np.float32)))
mdl, stats = learn(train_csr, SlimConfig(l1r=0.5, l2r=1.0))
ids, scores, counts = predict_topn(mdl, train_csr, nrcmds=10)
fmarker = determine_head_tail(train_csr)
print(evaluate_topn(ids, counts, test_csr, fmarker))
print("objective:", stats["loss"])

# --------------------------------------------------------------------- #
# 8. Device execution knobs (all optional)
# --------------------------------------------------------------------- #
# gram:   "auto" (device when G fits its memory) | "device" (sparse CSR
#         scatter-densified on device) | "host" (native OpenMP SpGEMM).
# kernel: "auto" (by platform) | "triton" (GPU chunk kernel) | "xla".
# block_size, compact_threshold, shuffle, checkpoint_dir (crash-resume
# of column blocks), profile_dir (jax.profiler trace): see SlimConfig.
mdl2, _ = learn(train_csr, SlimConfig(l1r=0.5, l2r=1.0, gram="device"))

# Large catalogues: once a dense W no longer fits the device memory,
# predict_topn switches to a padded-sparse device model automatically
# (n*R*8 bytes instead of n^2*4); force either path with sparse=True/False.
ids2, _, _ = predict_topn(mdl2, train_csr, nrcmds=10, sparse=True)

# Serving pattern (one model, many request batches): build the device
# model once and pass it back in -- predict_topn then runs one lax.scan
# dispatch over all user blocks (host round trips don't scale with the
# user count).  For sparse catalogues the resident model is the
# (Widx, Wval) tuple; for dense ones, the densified W.
from slim_tpu.predict import sparsify_model_device
Wsp = sparsify_model_device(mdl2)
ids3, _, _ = predict_topn(mdl2, train_csr, nrcmds=10, W_dev=Wsp, scan=True)

# At >=2^19 items the sparse scan switches to the COO segment-top-k
# kernel: per-user cost O(history x model-row-width), independent of the
# catalogue size -- 2M-item catalogues serve without any npad-wide
# buffer (SLIM_PREDICT_COO_NPAD overrides the threshold; the neg-file
# and 1-vs-k paths use the same machinery via a searchsorted join, and
# sharded_predict runs it per user shard on a mesh).

# Native CPU predict (serving small catalogues; same scoring semantics):
from slim_tpu import native
if native.available():
    nids, nsc, ncnt = native.predict_topn(mdl2, train_csr, nrcmds=10)

# Small catalogues route to the native kernel AUTOMATICALLY: an unpinned
# predict_topn call (no W_dev/sparse/scan/precision) with npad <=
# SLIM_PREDICT_NATIVE_NPAD (default 4096) uses the host loop, where the
# whole job costs less than one device dispatch.  Set the env var to 0
# to force everything onto the device.

# --------------------------------------------------------------------- #
# 9. Multi-chip SPMD (works on any jax.sharding.Mesh; here: CPU devices)
# --------------------------------------------------------------------- #
# distributed_learn: rating matrix row-sharded as sparse triplets, Gram
# psum'd over the mesh, column blocks fanned out across per-device G
# replicas through the same single-device driver.  Result matches the
# single-device solver.
import jax
from jax.sharding import Mesh

if len(jax.devices()) > 1:
    from slim_tpu.parallel.dist import (distributed_learn,
                                        distributed_learn_blockwise,
                                        sharded_predict)

    devs = np.array(jax.devices()).reshape(len(jax.devices()), 1)
    mesh = Mesh(devs, ("dp", "mp"))
    dmodel, dstats = distributed_learn(train_csr, SlimConfig(l1r=1.0,
                                                             l2r=1.0), mesh)
    # blockwise mode: G is never materialized anywhere -- use for
    # catalogues too large for an (n, n) Gram (>100k items)
    bmodel, bstats = distributed_learn_blockwise(
        train_csr, SlimConfig(l1r=1.0, l2r=1.0, block_size=128), mesh)
    # sharded-G mode: G computed once, column-sharded over the grid
    # (per-device memory = n^2*4/ndev) -- the many-device regime where
    # re-deriving per-block Grams from triplets would be wasteful
    from slim_tpu.parallel.dist import distributed_learn_sharded_g
    gmodel, gstats = distributed_learn_sharded_g(
        train_csr, SlimConfig(l1r=1.0, l2r=1.0, block_size=64), mesh)
    # users sharded over the grid, W replicated
    dids, dsc, dcnt = sharded_predict(dmodel, train_csr, mesh, nrcmds=10)
    # distributed model selection: one psum'd Gram shared by the whole
    # sweep, solves fanned out over the mesh, warm starts preserved
    from slim_tpu.mselect import mselect_pairs
    sweep = mselect_pairs(train_csr, train_csr,
                          SlimConfig(optTol=1e-7, nrcmds=5),
                          [(0.5, 0.5), (1.0, 0.5)], mesh=mesh)

# Multi-host: call slim_tpu.parallel.mesh.init_distributed() once per
# process (wraps jax.distributed.initialize), then build the Mesh over
# jax.devices() exactly as above.
