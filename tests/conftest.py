"""Test harness configuration.

Tests run on an 8-device virtual CPU mesh, so sharding tests get 8 XLA
devices.  ``JAX_PLATFORMS`` selects the platform (CPU unless it is set);
tests that need the GPU carry the ``gpu`` marker and decide in a fixture
whether to skip, so ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``
runs them on a card.  ``chip_smoke.py`` is the main check on the card.

Mirrors the reference's test fixture (`tests/common/mod.rs`): EPSILON = 1e-3
absolute tolerance, labeled approx asserts.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# Reference tolerance: tests/common/mod.rs:6.
EPSILON = 1e-3


def assert_approx(actual, expected, eps=EPSILON, label=""):
    actual = float(actual)
    expected = float(expected)
    assert abs(actual - expected) <= eps, (
        f"{label}: {actual} != {expected} (diff {abs(actual - expected):.3e} > {eps})"
    )


def assert_slice_approx(actual, expected, eps=EPSILON, label=""):
    a = np.asarray(actual, dtype=np.float64)
    e = np.asarray(expected, dtype=np.float64)
    assert a.shape == e.shape, f"{label}: shape {a.shape} != {e.shape}"
    diff = np.abs(a - e)
    idx = int(np.argmax(diff)) if diff.size else 0
    assert diff.size == 0 or diff.max() <= eps, (
        f"{label}: max diff {diff.max():.3e} > {eps} at index {idx} "
        f"({a.flat[idx]} vs {e.flat[idx]})"
    )


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """The GPU device, or a skip when the run has none (decided here, at
    test time, never while modules are imported)."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest -m gpu tests/")
    return jax.devices()[0]
