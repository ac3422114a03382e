"""Test configuration.

By default the suite runs on an 8-device virtual CPU platform: it checks the
numerics (Pallas kernels in interpret mode) and the multi-device sharding
path without an accelerator.  NANORQ_TEST_GPU=1 leaves JAX on its default
backend for the `gpu`-marked on-card tests (`make test-gpu`, one process);
a fixture skips those wherever JAX finds no GPU.
"""

import os

import pytest

if not os.environ.get("NANORQ_TEST_GPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

    import jax

    jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip `gpu`-marked tests unless JAX's first device is a GPU."""
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {platform!r}); run NANORQ_TEST_GPU=1 on the card")
