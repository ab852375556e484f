"""Small shared utilities."""

from __future__ import annotations

import logging
import os

logger = logging.getLogger("slim_tpu")

# fixed compile-cache directory of this checkout (the path is part of the
# cache key, so it must not move between runs)
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")

_cache_enabled = False
_fetch_pool = None


def _pool():
    global _fetch_pool
    if _fetch_pool is None:
        from concurrent.futures import ThreadPoolExecutor

        _fetch_pool = ThreadPoolExecutor(1)
    return _fetch_pool


def submit_fetch(*arrs):
    """Device->host copies of ``arrs`` on the fetch worker thread, so the
    caller can keep dispatching device work meanwhile.  Returns a future
    whose result is the tuple of numpy arrays."""
    import numpy as np

    return _pool().submit(lambda: tuple(np.asarray(a) for a in arrs))


def nnz_bucket(n: int, floor: int = 8) -> int:
    """1/8-octave size bucket: next multiple of pow2ceil(n)/8 above n
    (>= floor).  Flat nnz-sized buffers padded to pure powers of two
    waste up to 2x transfer bytes right above a power of two (an ML-20M
    model's 34.5M nnz would pad to 67M); eight sub-buckets per octave cap
    the padding at 12.5% for a bounded (8x) growth in distinct compiled
    programs, all persistent-cached.  Results above 1024 are multiples of
    256."""
    m = max(floor, 8)
    while m < n:
        m *= 2
    if m <= 1024:
        return m
    step = m >> 3
    return max(((n + step - 1) // step) * step, floor)


def enable_compilation_cache() -> None:
    """Enable JAX's persistent compilation cache (idempotent).

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is configured here.  Otherwise the cache lives in
    ``<checkout>/.jax_cache`` (:data:`CACHE_DIR`), so later processes of
    the same checkout skip recompiling the solver and serving programs.
    """
    global _cache_enabled
    if _cache_enabled:
        return
    _cache_enabled = True
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
