"""Large-catalogue predict benchmark: padded-sparse scan path on device
vs the native CPU top-N baseline.

This is the large-catalogue serving regime: a >100k-item catalogue where the dense (npad, npad) W cannot
exist and the reference's per-user scalar loop (predict.c:40-66) meets
the device's one-dispatch scan (predict._get_predict_scan_sparse).  The
model is synthesized directly at serving shape (learning it first would
conflate the two benchmarks).

Usage (GPU):   python scripts/predict_large_bench.py [nitems] [nusers]
Usage (CPU check): JAX_PLATFORMS=cpu \
                     python scripts/predict_large_bench.py 50000 2000

Prints one JSON line with users/sec for both sides.
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
    from slim_tpu import native
    from slim_tpu.predict import (densify_model, predict_topn,
                                  sparsify_model_device)
    from slim_tpu.types import CSR
    from slim_tpu.utils import enable_compilation_cache

    enable_compilation_cache()

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 262_144
    nusers = int(sys.argv[2]) if len(sys.argv) > 2 else 100_000
    nnz_row, hlen, reps = 50, 40, int(os.environ.get("SLIM_BENCH_REPS", "3"))

    rng = np.random.default_rng(7)
    # model: top-popularity-biased candidate ids (realistic SLIM output)
    mr = np.repeat(np.arange(n), nnz_row)
    mc = (rng.zipf(1.3, mr.size * 2) % n)[:mr.size]
    mv = rng.random(mr.size, dtype=np.float32) + 0.01
    model = CSR.from_ijv(mr, mc, mv, nrows=n, ncols=n)
    hr = np.repeat(np.arange(nusers), hlen)
    hc = (rng.zipf(1.2, hr.size * 2) % n)[:hr.size]
    hist = CSR.from_ijv(hr, hc, np.ones(hr.size, np.float32),
                        nrows=nusers, ncols=n).binarize()
    print(f"[bench] model {n}x{n} nnz={model.nnz}  "
          f"users {nusers} hist nnz={hist.nnz}", file=sys.stderr, flush=True)

    # SLIM_PREDICT_BENCH_DENSE=1 measures the dense-W device path instead
    # (the device's best path for small catalogues -- use it for the
    # crossover points of the serving table, where the sparse scan would
    # understate the device side)
    dense = os.environ.get("SLIM_PREDICT_BENCH_DENSE") == "1"
    t0 = time.perf_counter()
    if dense:
        W_dev = densify_model(model)
        W_dev.block_until_ready()
        kw = {"W_dev": W_dev, "sparse": False}
    else:
        W_dev = sparsify_model_device(model)
        W_dev[0].block_until_ready()
        kw = {"W_dev": W_dev, "scan": True}
    print(f"[bench] {'densify' if dense else 'sparsify'} (one-time model "
          f"upload+build) {time.perf_counter() - t0:.1f}s",
          file=sys.stderr, flush=True)

    predict_topn(model, hist, nrcmds=10, **kw)  # warm
    best = float("inf")
    for r in range(reps):
        t0 = time.perf_counter()
        ids, scores, counts = predict_topn(model, hist, nrcmds=10, **kw)
        dt = time.perf_counter() - t0
        print(f"[bench] device repeat {r}: {dt:.2f}s", file=sys.stderr,
              flush=True)
        best = min(best, dt)
    dev_ups = nusers / best

    cpu_ups = None
    if native.available():
        native.predict_topn(model, hist, nrcmds=10)  # warm/alloc
        cbest = float("inf")
        for r in range(reps):
            t0 = time.perf_counter()
            native.predict_topn(model, hist, nrcmds=10)
            cbest = min(cbest, time.perf_counter() - t0)
        cpu_ups = nusers / cbest

    out = {"metric": "predict_large_users_per_sec", "value": round(dev_ups, 1),
           "unit": "users/sec", "nitems": n, "nusers": nusers,
           "device_path": "dense" if dense else "sparse",
           "model_nnz": int(model.nnz),
           "cpu_users_per_sec": round(cpu_ups, 1) if cpu_ups else None,
           "vs_baseline": round(dev_ups / cpu_ups, 3) if cpu_ups else None}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
