"""2M-item north-star dryrun (BASELINE configs[4] shape) on a virtual mesh.

Runs `distributed_learn_blockwise` end-to-end on a 2,000,000-item
catalogue (Amazon-books scale) with long-tail activity, on an 8-device
virtual CPU mesh -- every array is the REAL 2M-item shape (npad ~2.003M,
(npad, chunk) screens, compact Grams), only the nnz is kept small enough
for CPU execution.  Demonstrates that the G-free path holds the north
star's item count with bounded memory: G would be 16TB dense; peak here
is the (npad, chunk) screen buffer per device.

Usage:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    SLIM_SCREEN_BYTES=$((1<<30)) python scripts/amazon2m_dryrun.py

Cross-checks the objective against the native CPU oracle.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if os.environ.get("JAX_PLATFORMS"):
    import jax

    jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])


def main():
    import logging

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(message)s")
    import jax

    from slim_tpu.config import SlimConfig
    from slim_tpu.parallel.dist import distributed_learn_blockwise
    from slim_tpu.parallel.mesh import make_mesh
    from slim_tpu.types import CSR
    from slim_tpu import native

    ncols = int(sys.argv[1]) if len(sys.argv) > 1 else 2_000_000
    nrows, nnz = 50_000, 400_000

    rng = np.random.default_rng(0)
    users = rng.integers(0, nrows, nnz)
    # long-tail: activity concentrates on ~2k items spread over the full
    # 2M id space (the real Amazon shape: most of the catalogue is cold)
    hot = (rng.zipf(1.2, nnz * 2) % 2000)[:nnz]
    items = hot * 997 % ncols
    train = CSR.from_ijv(users, items, np.ones(nnz, np.float32),
                         nrows, ncols).binarize()
    print(f"workload {nrows}x{ncols} nnz={train.nnz} "
          f"(active items ~{np.unique(items).size})", flush=True)

    ndev = len(jax.devices())
    mesh = make_mesh(ndev)
    # SLIM_DRYRUN_NNBRS>0 runs FSLIM at this scale (chunked top-k screen)
    nnbrs = int(os.environ.get("SLIM_DRYRUN_NNBRS", "0"))
    cfg = SlimConfig(l1r=0.5, l2r=0.5, block_size=64, shuffle=False,
                     nnbrs=nnbrs)

    t0 = time.perf_counter()
    model, stats = distributed_learn_blockwise(train, cfg, mesh)
    dt = time.perf_counter() - t0

    out = {"metric": "amazon2m_dryrun_learn_s", "value": round(dt, 1),
           "ncols": ncols, "ndevices": ndev, "loss": stats["loss"],
           "model_nnz": stats["nnz"], "mode": stats["mode"]}
    if native.available() and os.environ.get("SLIM_DRYRUN_NATIVE") != "0":
        t0 = time.perf_counter()
        _, _, obj = native.cd_learn(train, l1r=0.5, l2r=0.5, optTol=1e-7,
                                    maxniters=10000, nthreads=0)
        out["native_loss"] = obj
        out["native_s"] = round(time.perf_counter() - t0, 1)
        out["loss_rel_err"] = abs(stats["loss"] - obj) / max(abs(obj), 1.0)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
