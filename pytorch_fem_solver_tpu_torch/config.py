"""Global configuration for the PyTorch/CUDA port.

Counterpart of ``pytorch_fem_solver_tpu/config.py``. The JAX package switches
precision with ``jax_enable_x64``; here the library default dtype is float32
(the card's working type) and callers that want float64, such as the parity
tests, set it explicitly. Index arrays stay int32 as in the JAX package.

The JAX package's host-construction machinery (``HostConstructed``,
``setup_device_context``) has no counterpart: structures are built on the
host with NumPy and moved to the device once.

Device rule: entry points run on ``cuda`` unless the caller passes
``device="cpu"``. Without a CUDA device and without an explicit request they
raise instead of carrying on on the CPU.
"""

from __future__ import annotations

import torch

# TF32 keeps ~3 decimal digits; a reduced-precision product in the load
# vector alone was enough to move the benchmark solution by 3e-3 on the TPU
# (bench.py's SoA note), so both switches are pinned off explicitly.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_default_dtype: torch.dtype | None = None


def set_default_dtype(dtype: torch.dtype | None) -> None:
    """Set the dtype of newly built meshes and bases (None: float32)."""
    global _default_dtype
    _default_dtype = dtype


def default_dtype() -> torch.dtype:
    """Real dtype for FEM arrays: the configured one, else float32."""
    return _default_dtype if _default_dtype is not None else torch.float32


def index_dtype() -> torch.dtype:
    """Integer dtype for connectivity / DOF indices."""
    return torch.int32


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card. With no CUDA device this raises: a run that
    asked for nothing must not silently measure the CPU.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU explicitly"
            )
        return torch.device("cuda")
    return torch.device(device)
