"""Test configuration: force CPU with an 8-device virtual mesh, enable x64.

Must run before any jax import. The TPU-targeting code paths are validated on
the virtual CPU mesh (sharding semantics are identical); real-TPU runs happen
through bench.py.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_PLATFORM_NAME", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# jax may already be imported by a pytest plugin before this conftest runs;
# updating the config still works as long as no backend has been initialized.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: launches a hand-written CUDA kernel; skips unless "
        "torch.cuda.is_available()",
    )
