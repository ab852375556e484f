"""Compile-cache placement and the device->host fetch helper."""

import os

import numpy as np
import pytest


@pytest.fixture
def fresh_cache_state(monkeypatch):
    import jax

    from slim_tpu import utils

    monkeypatch.setattr(utils, "_cache_enabled", False)
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return utils, calls


def test_compile_cache_env_var_set_configures_nothing(fresh_cache_state,
                                                      monkeypatch, tmp_path):
    utils, calls = fresh_cache_state
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    utils.enable_compilation_cache()
    utils.enable_compilation_cache()
    assert calls == []


@pytest.mark.parametrize("pid", [1234, 98765])
def test_compile_cache_default_is_checkout_dir(fresh_cache_state, monkeypatch,
                                               pid):
    """Unset: the cache goes to <checkout>/.jax_cache, a path that depends
    on nothing but the checkout (not the process id, not the time)."""
    utils, calls = fresh_cache_state
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(os, "getpid", lambda: pid)
    utils.enable_compilation_cache()
    utils.enable_compilation_cache()       # idempotent
    root = os.path.dirname(os.path.dirname(os.path.abspath(utils.__file__)))
    assert dict(calls)["jax_compilation_cache_dir"] == \
        os.path.join(root, ".jax_cache")
    assert [n for n, _ in calls].count("jax_compilation_cache_dir") == 1


def test_submit_fetch_returns_host_arrays():
    import jax.numpy as jnp

    from slim_tpu.utils import submit_fetch

    a = jnp.arange(12, dtype=jnp.float32).reshape(3, 4)
    b = jnp.ones(5, jnp.int32)
    fut = submit_fetch(a, b)
    ha, hb = fut.result()
    assert fut.done()
    assert isinstance(ha, np.ndarray) and isinstance(hb, np.ndarray)
    np.testing.assert_array_equal(ha, np.arange(12).reshape(3, 4))
    np.testing.assert_array_equal(hb, np.ones(5))
