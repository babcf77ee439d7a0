"""Test configuration: JAX runs on the CPU with 8 virtual devices, so the
multi-device sharding paths are testable without accelerators.

A ``JAX_PLATFORMS`` that is already set is respected, so the tests marked
``gpu`` can run on a card (``JAX_PLATFORMS=cuda python -m pytest -m gpu``).
``XLA_FLAGS`` must be set before the backend initialises.
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default backend is a GPU; decided when
    the test runs, never at import or collection time."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run: JAX_PLATFORMS=cuda "
                    "python -m pytest -m gpu)")
    return jax.devices()[0]
