"""Test configuration: 8-device virtual CPU mesh + float64 for parity.

The suite runs on the CPU backend (``JAX_PLATFORMS=cpu``): true float64,
fast local compiles, and ``--xla_force_host_platform_device_count=8``
provides the standard 8-device virtual mesh for sharding tests. The fused
Pallas kernels run in Pallas's interpreter here (one autouse fixture asks
for it); tests marked ``gpu`` need a CUDA GPU and run the compiled kernels
instead (``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` on a
machine with one).
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(101)


@pytest.fixture(autouse=True)
def _kernel_mode(request, monkeypatch):
    """Run the fused kernels in Pallas's interpreter, except in tests
    marked ``gpu``: those need a CUDA GPU and are skipped without one."""
    from proxmin_tpu.ops import nmf_kernels

    if request.node.get_closest_marker("gpu") is not None:
        if not nmf_kernels.cuda_available():
            pytest.skip("needs a CUDA GPU (run with pytest -m gpu there)")
        return
    monkeypatch.setattr(nmf_kernels, "INTERPRET", True)
