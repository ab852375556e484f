"""Instrumented ML-20M learn: phase timers + warm repeat.

Usage: python scripts/ml20m_learn.py [reps]
"""
import logging
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

logging.basicConfig(level=logging.INFO,
                    format="%(asctime)s %(message)s", stream=sys.stderr)

import bench
from slim_tpu.api import learn
from slim_tpu.config import SLIM_DBG_INFO, SLIM_DBG_TIME, SlimConfig
from slim_tpu.utils import enable_compilation_cache

enable_compilation_cache()

reps = int(sys.argv[1]) if len(sys.argv) > 1 else 2
t0 = time.perf_counter()
train, name, _ = bench.load_workload()
train = train.infer_ncols()
print(f"workload {name} {train.nrows}x{train.ncols} nnz={train.nnz} "
      f"gen {time.perf_counter()-t0:.1f}s", flush=True)

cfg = SlimConfig(l1r=1.0, l2r=1.0, optTol=1e-7, maxniters=10000,
                 block_size=512, dbglvl=SLIM_DBG_TIME | SLIM_DBG_INFO)
for r in range(reps):
    t0 = time.perf_counter()
    model, stats = learn(train, cfg)
    dt = time.perf_counter() - t0
    print(f"rep{r}: {dt:.1f}s  {train.ncols/dt:.1f} cols/s  "
          f"loss {stats['loss']:.6e} nnz {stats['nnz']} "
          f"niters {stats['niters']}", flush=True)
