"""Worker for the multi-process jax.distributed test (test_multiprocess.py).

Each process owns 2 virtual CPU devices; after ``init_distributed`` the
global mesh spans 2*nproc devices across both OS processes, so the learn's
collectives (Gram psum / screen psum_scatter) actually cross a process
boundary -- the code path a real multi-host cluster runs, which
single-process virtual-mesh tests never exercise.

Usage: python tests/_mp_worker.py <process_id> <num_processes> <port> <mode>
Prints one "RESULT <json>" line on success.

Importable WITHOUT side effects (the test process imports toy_train): env
mutations and the jax import happen only when run as a script.
"""

import json
import os
import sys

if __name__ == "__main__":
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    os.environ.setdefault("SLIM_PREDICT_NATIVE_NPAD", "0")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def toy_train():
    """Deterministic toy rating matrix (same in every process)."""
    from slim_tpu.types import CSR

    rng = np.random.default_rng(42)
    nrows, ncols, nnz = 120, 48, 900
    rows = rng.integers(0, nrows, nnz)
    cols = rng.integers(0, ncols, nnz)
    vals = rng.integers(1, 6, nnz).astype(np.float32)
    return CSR.from_ijv(rows, cols, vals, nrows=nrows, ncols=ncols)


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")

    pid, nproc, port, mode = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    from slim_tpu.parallel.mesh import init_distributed, make_mesh

    init_distributed(coordinator_address=f"127.0.0.1:{port}",
                     num_processes=nproc, process_id=pid)
    assert jax.process_count() == nproc, jax.process_count()
    ndev = len(jax.devices())
    assert ndev == 2 * nproc, ndev

    from slim_tpu.config import SlimConfig
    from slim_tpu.parallel.dist import (distributed_learn,
                                        distributed_learn_blockwise,
                                        distributed_learn_sharded_g)

    train = toy_train()
    cfg = SlimConfig(l1r=1.0, l2r=1.0, shuffle=False)
    mesh = make_mesh(ndev)
    if mode == "replicated":
        model, stats = distributed_learn(train, cfg, mesh)
    elif mode == "blockwise":
        model, stats = distributed_learn_blockwise(train, cfg, mesh)
    elif mode == "sharded_g":
        model, stats = distributed_learn_sharded_g(train, cfg, mesh)
    else:
        raise SystemExit(f"unknown mode {mode}")

    # sharded serving across the process boundary: users sharded over the
    # grid, fetched through _host_fetch (dense path at this toy npad)
    from slim_tpu.parallel.dist import sharded_predict

    ids, scores, counts = sharded_predict(model, train, mesh, nrcmds=5)
    print("RESULT " + json.dumps({
        "pid": pid, "nproc": nproc, "ndev": ndev,
        "loss": float(stats["loss"]), "nnz": int(stats["nnz"]),
        "pred_ids_sum": int(ids[ids >= 0].sum()),
        "pred_counts_sum": int(counts.sum()),
        "process_count": jax.process_count()}), flush=True)


if __name__ == "__main__":
    main()
