"""Build, load and launch the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source (``csrc/*.cuh`` are headers they share) has a
plain C interface and is compiled by hand with ``nvcc`` for Hopper
(``sm_90a``) into its own shared library under ``_build/`` (listed in
``.gitignore``), then loaded with ctypes. Builds happen at first use:
``build_all`` starts one ``nvcc`` per stale source, all at once, and waits
for them. Nothing here runs at import time, so the CPU tests import every
module without a toolchain.

``launch_counts`` holds one plain integer per kernel wrapper; a wrapper adds
one where it launches its kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = {
    "p1_element": SOURCE_DIR / "p1_element.cu",
    "bsr_spmv": SOURCE_DIR / "bsr_spmv.cu",
    "fused_pcg": SOURCE_DIR / "fused_pcg.cu",
    "gather": SOURCE_DIR / "gather.cu",
    "small_inv": SOURCE_DIR / "small_inv.cu",
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

launch_counts = {
    "p1_element_3d": 0,
    "bsr_spmv": 0,
    "bsr_spmv_bf16": 0,
    "agg_smooth_restrict": 0,
    "coarse_prolong_dot": 0,
    "p1_element_2d": 0,
    "gather_rows": 0,
    "small_inv": 0,
}

_libs: dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME  # PyTorch's own lookup

    candidate = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if CUDA_HOME and candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """Whether a library is older than its source or any shared header."""
    lib = _lib_path(name)
    inputs = [SOURCES[name], *SOURCE_DIR.glob("*.cuh")]
    return not lib.exists() or lib.stat().st_mtime < max(p.stat().st_mtime for p in inputs)


def build_all(force: bool = False) -> dict[str, str]:
    """Compile every stale kernel source in parallel; returns the compiler
    output (the ptxas register report) of each source built.

    Each build writes to a temporary file that is renamed into place, so
    concurrent builders never load a half-written library.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, src in SOURCES.items():
        if not (force or _stale(name)):
            continue
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            Path(tmp),
        )
    logs, failures = {}, []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate(timeout=600)
        logs[name] = out
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"{name} (rc={proc.returncode}):\n{out}")
        else:
            tmp.replace(_lib_path(name))
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of one kernel source (built on demand)."""
    lib = _libs.get(name)
    if lib is None:
        if _stale(name):
            build_all()
        lib = ctypes.CDLL(str(_lib_path(name)))
        _libs[name] = lib
    return lib


_SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}


def function(lib_name: str, symbol: str, dtype: torch.dtype, argtypes, x_dtype=None):
    """The C entry point ``<symbol>_<f32|f64>`` with its argtypes set, or
    for a pair of dtypes (values in ``dtype``, vectors in another
    ``x_dtype``) ``<symbol>_<dtype>_<x_dtype>``, e.g. ``bsr_spmv_bf16_f32``.

    Pointers and the stream travel as ``c_void_p`` and sizes as ``c_int64``:
    ctypes would otherwise pass Python ints as 32-bit and cut pointers.
    """
    if x_dtype is None or x_dtype == dtype:
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{symbol}: kernels take float32 or float64, got {dtype}")
        suffix = _SUFFIX[dtype]
    else:
        if dtype not in _SUFFIX or x_dtype not in _SUFFIX:
            raise TypeError(f"{symbol}: no kernel for {dtype} with {x_dtype}")
        suffix = f"{_SUFFIX[dtype]}_{_SUFFIX[x_dtype]}"
    fn = getattr(library(lib_name), f"{symbol}_{suffix}")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check(t: torch.Tensor, name: str, shape, dtype, align: int = 0) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``shape``/``dtype``
    (and, with ``align``, its data pointer a multiple of ``align`` bytes)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if align and t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def misaligned_copy(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose base lies one element past a 16-byte
    boundary: what the checks of the kernels' one-word paths feed them."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    if view.data_ptr() % 16 == 0:
        raise RuntimeError("misaligned_copy: the allocation was not 16-byte aligned")
    return view


def raise_on_error(err: int, kernel: str) -> None:
    """Raise if a launch returned a nonzero ``cudaGetLastError()``."""
    if err:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {err}")
