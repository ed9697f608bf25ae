"""One traced run of a cell, as ``fem_bench.run --trace 1`` makes it, and
where its idle time and its host time went, by the program's own spans.

    python3 -m fem_bench.split --workload <cell> --seed <n> --seconds <s> [--out <file>]

from the root of a checkout, on a machine with a CUDA card. Prints the
run's result line, then one JSON line (also written to ``--out``) with:

* ``requests``, ``median_request_ms``, ``device_events_per_request``,
  ``launches_per_iteration``, ``dtoh_per_request``: the device trace of the
  window, which a program without spans has too;
* with the program's spans: ``host_reads_per_request``; the host ms a
  request in each state (``pcg_dispatch``, ``pcg_first_read``: each loop's
  first stop test, ``pcg_read``: the others, ``setup_read``, ``assemble``,
  ``precond_setup``, ``solve_rest``: ``fem.solve`` less its children, and
  ``outside_solve``: the caller's part of the latency); the
  share of the card's idle time that overlaps each state (``idle_by_state``,
  %); ``solve_over_latency`` (the summed ``fem.solve`` spans over the summed
  latencies); ``read_lag_us``: median, 95th percentile and count of the lag
  from the end of each stop test's ``Memcpy DtoH`` to the end of its
  ``fem.host_read`` span (the clock the spans share with the device
  events); and by quarter of the window the host ms an iteration with its
  dispatch and read parts.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import sys

from . import run as harness
from .spans import idle_gaps, overlap_ns, recording, self_intervals


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def _minus(intervals, holes):
    """``intervals`` less ``holes`` (both sorted and disjoint)."""
    out, j = [], 0
    for a, b in intervals:
        while j < len(holes) and holes[j][1] <= a:
            j += 1
        k, at = j, a
        while k < len(holes) and holes[k][0] < b:
            if holes[k][0] > at:
                out.append((at, holes[k][0]))
            at = max(at, holes[k][1])
            k += 1
        if at < b:
            out.append((at, b))
    return out


def _quantile(values, q):
    values = sorted(values)
    return values[min(len(values) - 1, int(q * len(values)))] if values else None


def _read_lags(reads, events):
    """Lag (ns) from the end of the copy each read waited for to the end of
    its span: the ``Memcpy DtoH`` that ends nearest the span's end, within
    the span's time and 1 ms either side."""
    copies = sorted((e.end_ns, e.start_ns) for e in events if e.name.startswith("Memcpy DtoH"))
    ends = [c[0] for c in copies]
    lags = []
    for s in reads:
        lo = bisect.bisect_left(ends, s.start_ns - 1_000_000)
        hi = bisect.bisect_right(ends, s.end_ns + 1_000_000)
        if lo < hi:
            end = min(ends[lo:hi], key=lambda t: abs(s.end_ns - t))
            lags.append(s.end_ns - end)
    return lags


def analyse(lat, its, events, rec) -> dict:
    """The split of one traced window (see the module docstring)."""
    n = len(lat)
    out = {
        "requests": n,
        "median_request_ms": 1e3 * statistics.median(lat),
        "device_events_per_request": len(events) / n,
        "launches_per_iteration": sum(not e.copy for e in events) / sum(its),
        "dtoh_per_request": sum(e.name.startswith("Memcpy DtoH") for e in events) / n,
    }
    if rec is None:
        return out
    spans = rec.spans
    closed = [s for s in spans if s.request is not None and s.end_ns is not None]
    solves = [s for s in closed if s.name == "fem.solve" and s.parent is None]
    reads = [s for s in closed if s.name == "fem.host_read"]
    pcg_reads = [s for s in reads if spans[s.parent].name == "fem.pcg"]
    first = {}  # each loop's first stop test, which waits for the work queued before it
    for s in pcg_reads:
        first.setdefault(s.parent, s)
    states = {
        "pcg_dispatch": self_intervals(spans, "fem.pcg", "fem.host_read"),
        "pcg_first_read": sorted((s.start_ns, s.end_ns) for s in first.values()),
        "pcg_read": sorted((s.start_ns, s.end_ns) for s in pcg_reads
                           if first[s.parent] is not s),
        "setup_read": sorted((s.start_ns, s.end_ns) for s in reads
                             if spans[s.parent].name != "fem.pcg"),
        "assemble": self_intervals(spans, "fem.assemble", "fem.host_read"),
        "precond_setup": self_intervals(spans, "fem.precond_setup", "fem.host_read"),
    }
    solve_iv = sorted((s.start_ns, s.end_ns) for s in solves)
    states["solve_rest"] = _minus(solve_iv, _union([iv for v in states.values() for iv in v]))
    between = _minus([(solve_iv[0][0], solve_iv[-1][1])], solve_iv)
    gaps = idle_gaps(events)
    idle = sum(b - a for a, b in gaps)
    solve_ns = sum(b - a for a, b in solve_iv)
    host_ms = {k: sum(b - a for a, b in v) / 1e6 / n for k, v in states.items()}
    host_ms["outside_solve"] = (1e9 * sum(lat) - solve_ns) / 1e6 / n
    states["outside_solve"] = between
    idle_by = {k: 100.0 * overlap_ns(v, gaps) / idle if idle else None
               for k, v in states.items()}

    # by quarter of the window's requests: host ms an iteration, split
    loop_ns, read_ns = {}, {}
    for s in pcg_reads:
        read_ns[s.request] = read_ns.get(s.request, 0) + s.end_ns - s.start_ns
    for s in closed:
        if s.name == "fem.pcg":
            loop_ns[s.request] = loop_ns.get(s.request, 0) + s.end_ns - s.start_ns
    quarters = []
    for q in range(4):
        part = slice(q * n // 4, (q + 1) * n // 4)
        ids = [s.request for s in solves[part]]
        iters = sum(its[part])
        if not iters:
            quarters.append(None)
            continue
        reads_q = sum(read_ns.get(r, 0) for r in ids)
        quarters.append({
            "ms_per_iteration": 1e3 * sum(lat[part]) / iters,
            "dispatch_us_per_iteration": (sum(loop_ns.get(r, 0) for r in ids) - reads_q)
            / 1e3 / iters,
            "read_us_per_iteration": reads_q / 1e3 / iters,
        })
    lags = _read_lags(pcg_reads, events)
    out.update({
        "host_reads_per_request": rec.counters.get("host_reads", 0) / n,
        "host_ms_per_request": host_ms,
        "idle_ms_per_request": idle / 1e6 / n,
        "idle_by_state": idle_by,
        "solve_over_latency": solve_ns / (1e9 * sum(lat)),
        "read_lag_us": {"median": statistics.median(lags) / 1e3 if lags else None,
                        "p95": _quantile(lags, 0.95) / 1e3 if lags else None,
                        "matched": len(lags), "reads": len(pcg_reads)},
        "by_quarter": quarters,
    })
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cache = harness.ROOT / ".bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv"), ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
        os.environ[var] = str(cache / sub)
        (cache / sub).mkdir(parents=True, exist_ok=True)
    import torch

    if not torch.cuda.is_available():
        print("the split reads the card's trace: no CUDA device", file=sys.stderr)
        return 10
    torch.set_num_threads(4)
    # run_cell returns the result line only: keep the window's own readings
    seen = {}
    window = harness.window

    def kept(*a, **kw):
        seen["window"] = out = window(*a, **kw)
        return out

    harness.window = kept
    result = harness.run_cell(harness.ROOT, args.workload, args.seed, args.seconds, True)
    lat, its, _, _, _, events, _ = seen["window"]
    run = harness.RunRecord(0.0, 0.0, 0.0, lat, its, [], 0, events, None)
    split = {"workload": args.workload, "seed": args.seed, "correct": result["correct"],
             "failed": result["failed"], "device": torch.cuda.get_device_name(0),
             **analyse(lat, its, events, recording(run))}
    print(json.dumps(result), flush=True)
    print(json.dumps(split), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps({"result": result, "split": split}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
