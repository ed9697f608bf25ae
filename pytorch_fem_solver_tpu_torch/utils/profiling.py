"""Step timing, the PyTorch profiler and the solve path's spans.

Counterpart of ``pytorch_fem_solver_tpu/utils/profiling.py``. ``StepTimer``
keeps the JAX class's surface (``step``, ``time_fn``, ``summary`` and its
keys); its sync waits for the card instead of copying every leaf to the
host. ``trace`` wraps ``torch.profiler`` and writes a Chrome trace, where
the JAX one starts the XLA profiler.

The recorder (the port's own; the JAX package has none) times the solve
path from inside: ``span(name)`` around a stretch of host code, ``read(t)``
for each blocking device-to-host read, ``count(name)`` for a counter.
They record only while a ``torch.profiler`` session runs; otherwise each
costs one read of the profiler's Python flag and records, allocates and
changes nothing. Under a session:

* a span is kept as ``Span(name, request, parent, start_ns, end_ns,
  device_ms)``, stamped with ``time.time_ns()``, the clock of the
  profiler's (Kineto's) events, so spans line up with the device trace.
  Spans of one request share ``request``, numbered when an outermost
  ``fem.solve`` opens; ``parent`` is the index of the enclosing span in
  ``recorded().spans``;
* a span also enters a profiler range of its name (PyTorch's
  ``_RecordFunctionFast``, else ``record_function``), so it shows in the
  Chrome trace beside the kernels (``read``'s ``fem.host_read`` spans do
  not: they are too many).
  Its start is stamped inside that range, microseconds after the
  profiler's own event starts (``record_function``'s entry alone can take
  a millisecond);
* a span given a CUDA ``device`` records a pair of timing events on its
  current stream; ``device_ms``, the stream time between them, is resolved
  by ``recorded()``, after the caller's own synchronise (none is added);
* ``read`` records a ``fem.host_read`` span and counts ``host_reads``.

Construction spans (``span(..., always=True)``: ``fem.tables.*``, once per
solver build) are recorded with or without a session. The spans and
counters of the solve path:

===================== ======================================================
``fem.solve``         a ``compiled_bsr_solver`` or ``compiled_refined_solver``
                      solve (numbers the request)
``fem.assemble``      the operator's values and the load vector (CUDA events)
``.local``            inside it, per run of cells: the element matrices (and
                      in the last run the element loads) (CUDA events)
``.scatter``          inside it, after each ``.local``: their scatter into the
                      BSR values (and in the last run the mirror completion
                      and the padded load) (CUDA events)
``fem.precond_setup`` the diagonal and the preconditioner's set-up (CUDA
                      events)
``.galerkin``         inside it: the coarse matrix of the block or affine
                      M, symmetrised (CUDA events)
``.coarse_inverse``   inside it: the shifted coarse matrix's ``spd_inverse``
                      (CUDA events)
``.smoother``         inside it: the fine smoother's block or aggregate-block
                      inverses (CUDA events)
``coarse_rows``       the counter of the coarse sizes set up (n_pad / g, or
                      na m of the affine and rigid-body-mode M)
``scatter_values``    the counter of the values the assembly's scatters add
                      (``ops.bsr``: canonical pairs and drop-mode values);
                      ``scatter_kernel_values`` of those the kernel K8 added
``fem.pcg``           a PCG solve (``fem.pcg_cols``, ``fem.minres``,
                      ``fem.bicgstab``: the other loops of ``ops.solvers``)
``.capture``          inside it, on the card: the capture and instantiation
                      of ``pcg_chunked``'s CUDA graph; beside it the counter
                      ``pcg_graphed_iterations`` of the iterations that ran
                      in the graph's replays
``fem.host_read``     one blocking read (stop tests, chunk counts,
                      ``spd_inverse``)
``host_reads``        the counter of those reads
``fem.tables.solver`` a solver's construction, with ``fem.tables.bsr`` (the
                      BSR layout) and ``fem.tables.precond`` (the
                      preconditioner's host tables) inside
===================== ======================================================

To look at a solve: run it inside ``with trace(): ...``, open the Chrome
trace it writes, and read ``recorded()`` (``trace`` calls ``reset`` on
entry). One thread records at a time.
"""

from __future__ import annotations

import collections
import contextlib
import os
import statistics
import tempfile
import time
from typing import Callable, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = [
    "Recording",
    "Span",
    "StepTimer",
    "count",
    "read",
    "recorded",
    "reset",
    "span",
    "trace",
]


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
    Clears the recorder first, so ``recorded()`` afterwards holds the
    block's spans and counters. Yields ``log_dir``."""
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "torch-trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    reset()
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        )


# -- the recorder -------------------------------------------------------------


class Span(NamedTuple):
    """One recorded span; times in ns of ``time.time_ns()``."""

    name: str
    request: Optional[int]  # the request it belongs to (None outside a solve)
    parent: Optional[int]  # index of the enclosing span in ``recorded().spans``
    start_ns: int
    end_ns: Optional[int]  # None while the span is open
    device_ms: Optional[float] = None  # stream time of its CUDA event pair


class Recording(NamedTuple):
    """What ``recorded()`` returns: the spans in the order they opened and
    the counters."""

    spans: list
    counters: dict


class _Recorder:
    """The state behind ``span``, ``read``, ``count`` and ``recorded``."""

    def __init__(self):
        self.spans: list[Span] = []
        self.counters: collections.Counter = collections.Counter()
        self.events: list = []  # (span index, start event, end event)
        self.open: list[int] = []  # indices of the open spans, innermost last
        self.requests = 0
        self.request: Optional[int] = None
        self.solves_open = 0
        self.generation = 0  # bumped by ``reset``: spans open across it are dropped

    @contextlib.contextmanager
    def span(self, name: str, device, annotate: bool):
        generation, index = self.generation, len(self.spans)
        if name == "fem.solve":
            if not self.solves_open:
                self.requests += 1
                self.request = self.requests
            self.solves_open += 1
        request = self.request
        parent = self.open[-1] if self.open else None
        events = None
        if device is not None and torch.device(device).type == "cuda":
            stream = torch.cuda.current_stream(device)
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        start = time.time_ns()
        self.spans.append(Span(name, request, parent, start, None))
        self.open.append(index)
        try:
            with _range(name) if annotate else contextlib.nullcontext():
                start = time.time_ns()  # the range's event starts inside its entry
                if events is not None:
                    events[0].record(stream)
                try:
                    yield
                finally:
                    if events is not None:
                        events[1].record(stream)
        finally:
            end = time.time_ns()
            if name == "fem.solve":
                self.solves_open -= 1
                if not self.solves_open:
                    self.request = None
            if generation == self.generation:
                self.open.pop()
                self.spans[index] = Span(name, request, parent, start, end)
                if events is not None:
                    self.events.append((index, *events))

    def host_read(self, tensor: torch.Tensor, after):
        start = time.time_ns()
        if after is not None:
            after.synchronize()
        value = tensor.item()
        end = time.time_ns()
        self.spans.append(Span("fem.host_read", self.request,
                               self.open[-1] if self.open else None, start, end))
        return value

    def recorded(self) -> Recording:
        for index, start, end in self.events:
            end.synchronize()
            self.spans[index] = self.spans[index]._replace(device_ms=start.elapsed_time(end))
        self.events.clear()
        return Recording(list(self.spans), dict(self.counters))

    def reset(self) -> None:
        self.spans.clear()
        self.counters.clear()
        self.events.clear()
        self.open.clear()
        self.generation += 1


#: the profiler range of a span: PyTorch's C++ context manager, entered
#: without the dispatcher call that ``record_function`` makes (a private
#: name: where a build lacks it, ``record_function`` itself)
_range = getattr(
    getattr(torch._C, "_profiler", None), "_RecordFunctionFast", torch.profiler.record_function
)

_RECORDER = _Recorder()
_OFF = contextlib.nullcontext()  # reusable: what ``span`` returns outside a session


def span(name: str, device=None, always: bool = False):
    """A context manager that records the block as the span ``name``.

    Without a profiler session it is a shared no-op, unless ``always``
    (construction spans, not annotated in the profiler's trace). With a
    CUDA ``device`` the span also records a timing-event pair on that
    device's current stream (``Span.device_ms``).
    """
    if always:
        return _RECORDER.span(name, None, annotate=False)
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _RECORDER.span(name, device, annotate=True)


def read(tensor: torch.Tensor, after=None):
    """``tensor.item()``: a blocking device-to-host read of a one-element
    tensor, recorded as a ``fem.host_read`` span and counted under
    ``host_reads`` during a profiler session. With ``after``, a CUDA event,
    the read waits for the event and then reads ``tensor``, a host copy
    that the work before the event writes (the wait is the read's)."""
    if not _autograd_profiler._is_profiler_enabled:
        if after is not None:
            after.synchronize()
        return tensor.item()
    count("host_reads")
    return _RECORDER.host_read(tensor, after)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` during a profiler session."""
    if _autograd_profiler._is_profiler_enabled:
        _RECORDER.counters[name] += n


def recorded() -> Recording:
    """The spans and counters recorded since the last ``reset``, with each
    span's CUDA event pair resolved to ``device_ms`` (waiting for its end
    event)."""
    return _RECORDER.recorded()


def reset() -> None:
    """Forget every span and counter (spans open now are not recorded)."""
    _RECORDER.reset()
