"""Test harness configuration.

Forces JAX onto the host CPU backend with 8 virtual devices so sharding /
multi-device tests run anywhere.  Must run before jax is imported.  Tests
that need the GPU carry the ``gpu`` marker and skip here; ``chip_smoke.py``
runs the same paths on the card.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

# pin the JAX predict paths (hard set, not setdefault: an ambient shell
# value must not silently reroute the suite off the device code): the
# native small-catalogue serving fallback (predict.NATIVE_PREDICT_NPAD)
# would otherwise hijack every small test matrix.  The dispatch itself is
# tested explicitly in test_native.py via monkeypatch.
os.environ["SLIM_PREDICT_NATIVE_NPAD"] = "0"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest


REFERENCE_TEST_DIR = "/root/reference/test"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips on the CPU backend)")


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip ``gpu``-marked tests unless JAX's backend is a GPU (decided
    when the test runs, never at import)."""
    if request.node.get_closest_marker("gpu") is not None \
            and jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this path on "
                    "the card")


def reference_data_available() -> bool:
    return os.path.isdir(REFERENCE_TEST_DIR)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def random_csr(rng, nrows, ncols, density=0.1, implicit=False, seed=None):
    """Small random rating matrix for unit tests."""
    from slim_tpu.types import CSR

    if seed is not None:
        rng = np.random.default_rng(seed)
    mask = rng.random((nrows, ncols)) < density
    vals = np.where(mask, rng.integers(1, 6, size=(nrows, ncols)), 0).astype(
        np.float32)
    rows, cols = np.nonzero(vals)
    data = None if implicit else vals[rows, cols]
    mat = CSR.from_ijv(rows, cols, vals[rows, cols], nrows=nrows, ncols=ncols)
    if implicit:
        mat = mat.binarize()
    return mat
