"""Step timing and the PyTorch profiler.

Counterpart of ``pytorch_fem_solver_tpu/utils/profiling.py``. ``StepTimer``
keeps the JAX class's surface (``step``, ``time_fn``, ``summary`` and its
keys); its sync waits for the card instead of copying every leaf to the
host. ``trace`` wraps ``torch.profiler`` and writes a Chrome trace, where
the JAX one starts the XLA profiler.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import tempfile
import time
from typing import Callable, Optional

import torch

__all__ = ["StepTimer", "trace"]


def _tensors(tree):
    """The tensors of a nested tuple / list / dict / NamedTuple result."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


class StepTimer:
    """Accumulates wall-clock per step with device synchronization."""

    def __init__(self):
        self.times: list[float] = []
        self._t0: Optional[float] = None

    @staticmethod
    def _sync(result):
        """Wait for the work behind ``result``: one
        ``torch.cuda.synchronize`` per CUDA device among its tensors (CPU
        tensors are complete when returned)."""
        if result is None:
            return
        devices = {t.device for t in _tensors(result) if t.is_cuda}
        for device in devices:
            torch.cuda.synchronize(device)

    @contextlib.contextmanager
    def step(self, result=None):
        t0 = time.perf_counter()
        yield
        self._sync(result)
        self.times.append(time.perf_counter() - t0)

    def time_fn(self, fn: Callable, *args, warmup: int = 1, reps: int = 10):
        """Median wall-clock of a callable (``warmup`` untimed calls first)."""
        for _ in range(warmup):
            self._sync(fn(*args))
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn(*args)
            self._sync(out)
            self.times.append(time.perf_counter() - t0)
        return self.summary()

    def summary(self) -> dict:
        if not self.times:
            return {"count": 0}
        return {
            "count": len(self.times),
            "median_s": statistics.median(self.times),
            "mean_s": statistics.fmean(self.times),
            "min_s": min(self.times),
            "max_s": max(self.times),
        }


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    when a card is present) and write its Chrome trace
    (``trace_<pid>_<ns>.json``, viewable in Perfetto or chrome://tracing)
    into ``log_dir`` (default: ``torch-trace`` in the temporary directory).
    Yields ``log_dir``."""
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "torch-trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        )
