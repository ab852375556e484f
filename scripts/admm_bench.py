"""ADMM device bench at its native regime (small-m tall problems).

The reference gates ADMM behind MKL and recommends it for datasets with
few items and many users (estimate.c:38-304: dense (n, n) iterations, 30
fixed dgemm rounds).  This script times the device path against the
same-algorithm f64 CPU oracle shape (numpy) on a tall synthetic workload
and reports iterations/sec and end-to-end learn time.

Usage:  python scripts/admm_bench.py [nrows] [ncols] [nnz]
Defaults: 500k users x 4096 items x 20M nnz.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from slim_tpu.config import SlimConfig
from slim_tpu.solvers.admm import estimate_model_admm
from slim_tpu.types import CSR


def main():
    nrows = int(sys.argv[1]) if len(sys.argv) > 1 else 500_000
    ncols = int(sys.argv[2]) if len(sys.argv) > 2 else 4096
    nnz = int(sys.argv[3]) if len(sys.argv) > 3 else 20_000_000

    rng = np.random.default_rng(0)
    users = rng.integers(0, nrows, nnz)
    items = (rng.zipf(1.25, nnz * 2) % ncols)[:nnz]
    t0 = time.perf_counter()
    train = CSR.from_ijv(users, items, np.ones(nnz, np.float32),
                         nrows, ncols).binarize()
    print(f"workload {nrows}x{ncols} nnz={train.nnz} "
          f"(gen {time.perf_counter() - t0:.1f}s)", flush=True)

    cfg = SlimConfig(algo="admm", l1r=2.0, l2r=2.0, dbglvl=0)

    t0 = time.perf_counter()
    model, stats = estimate_model_admm(train, cfg)
    warm = time.perf_counter() - t0
    print(f"warmup learn {warm:.1f}s  loss={stats.get('loss'):.5e} "
          f"nnz={stats['nnz']}", flush=True)

    best = float("inf")
    for r in range(3):
        t0 = time.perf_counter()
        model, stats = estimate_model_admm(train, cfg)
        dt = time.perf_counter() - t0
        best = min(best, dt)
        print(f"repeat {r}: {dt:.2f}s", flush=True)

    cpu_s = None
    if os.environ.get("SLIM_ADMM_CPU") == "1":
        # same-algorithm CPU baseline: the f64 scipy/numpy oracle (the
        # reference's own ADMM is MKL double precision, estimate.c:38-304)
        from slim_tpu.ops.gram import compute_gram
        from slim_tpu.solvers.admm import _round_up, admm_solve_f64

        npad = _round_up(ncols + 1, 128)
        T_host = np.asarray(compute_gram(train, "auto", pad_to=npad))
        t0 = time.perf_counter()
        admm_solve_f64(T_host, cfg.l1r, cfg.l2r, ncols)
        cpu_s = time.perf_counter() - t0
        print(f"cpu f64 oracle: {cpu_s:.2f}s", flush=True)

    import jax

    print({
        "metric": "admm_learn_s",
        "value": round(best, 3),
        "cols_per_s": round(ncols / best, 1),
        "iters_per_s": round(30 / best, 2),
        "vs_cpu_f64": round(cpu_s / best, 2) if cpu_s else None,
        "loss": stats.get("loss"),
        "nnz": stats["nnz"],
        "device": str(jax.devices()[0]),
    })


if __name__ == "__main__":
    main()
