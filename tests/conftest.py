"""Test configuration: run everything on a virtual 8-device CPU mesh so
multi-chip sharding paths compile and execute without TPU hardware.

Note: the TPU plugin on this machine ignores the JAX_PLATFORMS env var, so
we must force the CPU platform through jax.config before any computation.
"""

import os

xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (a hand-written CUDA kernel "
        "has no CPU mode); skips where torch.cuda.is_available() is False")
