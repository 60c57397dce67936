"""Test configuration: JAX on a virtual 8-device CPU mesh.

Parity tests are deterministic on CPU; multi-chip sharding tests use the
8 virtual host devices. Tests marked ``gpu`` check kernels and parity on
the card: they skip on the CPU and run with ``CBV_TEST_GPU=1`` on a
machine with an NVIDIA GPU (``CBV_TEST_GPU=1 pytest tests/ -m gpu``).
"""

import os

_ON_CARD = os.environ.get("CBV_TEST_GPU") == "1"
if not _ON_CARD:
    # Must be set before jax initializes its backends.
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from chessboard_vision.utils.jax_cache import enable_compile_cache  # noqa: E402

enable_compile_cache(min_compile_secs=0.1, min_entry_bytes=-1)


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX finds none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with CBV_TEST_GPU=1 on the card)")
    return dev
