"""Device events of a traced window, read from the profiler's raw events.

The arithmetic of the repository's ``chip_smoke.py:_profiled`` (Kineto's
raw device events, without the profiler's event tree, which takes tens of
seconds of host for ~100,000 launches), extended with each event's start:
the union of the device's busy intervals, the idle gaps between them, and
the operations that took the most time.
"""

from __future__ import annotations

import collections
import functools
from typing import NamedTuple


class DeviceEvent(NamedTuple):
    name: str
    start_ns: int
    end_ns: int

    @property
    def copy(self) -> bool:
        """A memory copy or set, not a kernel launch."""
        return self.name.startswith(("Memcpy", "Memset"))


def device_events(prof) -> list[DeviceEvent]:
    """The device events of a stopped ``torch.profiler.profile``, by start."""
    import torch

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA or e.is_user_annotation():
            continue
        start = int(e.start_ns())
        out.append(DeviceEvent(e.name(), start, start + int(e.duration_ns())))
    out.sort(key=lambda e: e.start_ns)
    return out


def busy_intervals(events: list[DeviceEvent]) -> list[tuple[int, int, int, int]]:
    """The union of the events' intervals as ``(start, end, first, last)``
    with the indices of the first and the last event of each."""
    merged: list[list[int]] = []
    end = -1
    for k, (_, start, stop) in enumerate(events):
        if start <= end:
            if stop > end:
                end = merged[-1][1] = stop
                merged[-1][3] = k
        else:
            end = stop
            merged.append([start, stop, k, k])
    return [tuple(m) for m in merged]


def busy_s(events: list[DeviceEvent]) -> float:
    return sum(b - a for a, b, _, _ in busy_intervals(events)) / 1e9


@functools.lru_cache(maxsize=None)
def short_name(name: str) -> str:
    """A kernel's name without ``void``, the anonymous namespace and its
    parameter list, at most 90 characters."""
    name = name.replace("(anonymous namespace)::", "").replace("at::native::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for k, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and k > 0:
            name = name[:k]
            break
    return name.strip()[:90]


@functools.lru_cache(maxsize=None)
def template_args(name: str) -> tuple[str, ...]:
    """The outer template arguments of a kernel's name (empty if none)."""
    name = short_name(name)
    if "<" not in name:
        return ()
    inner, depth, args, cur = name[name.index("<") + 1:], 1, [], ""
    for ch in inner:
        depth += (ch == "<") - (ch == ">")
        if depth == 0 or (ch == "," and depth == 1):
            args.append(cur.strip())
            cur = ""
            if depth == 0:
                break
        else:
            cur += ch
    return tuple(args)


def top_ops(events: list[DeviceEvent], n: int = 10) -> list[list]:
    """``[[name, seconds], ...]`` of the operations that took most device time."""
    by_name = collections.Counter()
    for name, start, stop in events:
        by_name[name] += stop - start
    total = collections.Counter()
    for name, ns in by_name.items():
        total[short_name(name)] += ns
    return [[name, ns / 1e9] for name, ns in total.most_common(n)]


def idle_gaps(events: list[DeviceEvent], n: int = 10) -> list[list]:
    """``[[name, seconds], ...]``: the idle time between busy intervals,
    summed by what bounds each gap (the operation before it and the one
    after it), the largest first. A gap ending in a host-to-device copy is
    a request boundary (the harness's sync and field update); one starting
    at a device-to-host copy is a host read of the program."""
    total = collections.Counter()
    spans = busy_intervals(events)
    for (_, end, _, last), (start, _, first, _) in zip(spans, spans[1:]):
        label = f"{short_name(events[last].name)} -> {short_name(events[first].name)}"
        total[label] += start - end
    return [[name, ns / 1e9] for name, ns in total.most_common(n)]
