"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m fem_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with a CUDA card. A cell names a
configuration (``fem_bench/configs/<config>.json``: the mesh input, the
problem, the element, the load) and a traffic mix
(``fem_bench/traffic/<traffic>.json``: the entry point a request drives
with its dtype and keywords, the coefficient and load fields, the
warm-up); its comparison lives in ``fem_bench/checks/<cell>.json``, each
metric in ``fem_bench/metrics/<metric>.py``, and what is solved and how its
answers are judged in the configuration's problem
(``fem_bench/problems/``). Nothing here names a cell or a problem.

A run: build the mesh input, the program's basis and solver (``tables_s``),
warm up, then one caller sends requests back to back for ``--seconds``:
each draws its fields from (seed, request index), writes them into the
forms' device tensors, runs the entry point, reads whether it converged and
synchronises. With ``--trace 1`` the profiler records the device's events
over the window. After the window the program's state is freed and the
problem's reference solves the sampled requests again from the same
inputs; the run is correct when each compared number is within its limit,
and a request that did not converge is one over the limit 0 of
``unconverged``. The last line of standard output is the result, in JSON;
the compared numbers and their limits are the last lines of standard
error.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, NamedTuple

ROOT = Path(__file__).resolve().parent.parent
#: top-level modules that may not be loaded in a run
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "pytorch_fem_solver_tpu"})
#: the first sampled requests that are compared; request 0 always is
MAX_CHECKED = 12


def _process_age() -> float:
    """Seconds since this process started (0 where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19]) / os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as f:
            age = float(f.read().split()[0]) - start
    except (OSError, ValueError, IndexError):
        return 0.0
    return age if 0.0 <= age < 120.0 else 0.0


#: the process's start on the ``time.perf_counter`` clock
T0 = time.perf_counter() - _process_age()


class Cell(NamedTuple):
    """One entry of ``workloads`` with everything it names."""

    name: str
    config: dict
    traffic: dict
    checks: dict
    end_to_end: list
    per_layer: list


def _for(cell_name: str, metrics: list) -> list:
    return [m for m in metrics if cell_name in m.get("workloads", [cell_name])]


def load_cell(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` and its files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json ({', '.join(cells)})")
    w = cells[workload]
    config_file = {c["name"]: c["file"] for c in bench["configs"]}[w["config"]]
    return Cell(
        name=workload,
        config=json.loads((root / config_file).read_text()),
        traffic=json.loads((root / "fem_bench" / "traffic" / f"{w['traffic']}.json").read_text()),
        checks=json.loads((root / "fem_bench" / "checks" / f"{workload}.json").read_text()),
        end_to_end=_for(workload, bench["end_to_end"]),
        per_layer=_for(workload, bench["per_layer"]),
    )


class RunRecord(NamedTuple):
    """What a run measured; the metric readers take their numbers from it."""

    setup_s: float
    tables_s: float
    window_s: float
    latencies_s: list
    iterations: list
    converged: list
    peak_window_bytes: int
    events: list | None  # trace.DeviceEvent of the window, with --trace 1
    work: dict | None  # the problem's work count (``nnz``, ``rows``), with --trace 1


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Program(NamedTuple):
    """The program's side of a cell, built at set-up."""

    request: Callable
    forms: object
    basis: object
    problem: object  # the module of ``fem_bench/problems/``
    specs: dict  # role -> fields.FieldSpec
    inputs: dict
    tables_s: float


def build_program(root: Path, cell: Cell, seed: int, device) -> Program:
    """Make the mesh input, build the program's basis and solver, warm up."""
    import torch

    from . import fields, problems

    cfg, traffic = cell.config, cell.traffic
    dtype = getattr(torch, traffic["dtype"])
    edge = float(cfg["domain_edge"])
    specs = {role: fields.field_spec(traffic[role], edge) for role in fields.STREAMS}
    inputs = importlib.import_module(f"fem_bench.meshes.{cfg['mesh']['kind']}").inputs(
        cfg["mesh"], root)
    problem = problems.of(cfg)

    t0 = time.perf_counter()
    basis, forms = problem.program(cell, inputs, specs, device, dtype)
    _set_fields(forms, specs, seed, 0, warmup=True, every=True)
    request = importlib.import_module(f"fem_bench.entries.{traffic['entry']}").build(
        basis, forms, traffic["keywords"])
    _sync(device)
    tables_s = time.perf_counter() - t0

    for j in range(int(traffic.get("warmup_requests", 2))):
        _set_fields(forms, specs, seed, j, warmup=True)
        _, _, converged = request()
        bool(converged)
    _sync(device)
    return Program(request, forms, basis, problem, specs, inputs, tables_s)


def _set_fields(forms, specs: dict, seed: int, index: int, warmup: bool = False,
                every: bool = False) -> None:
    """Write request ``index``'s fields into the forms: those drawn per
    request, and with ``every`` also those drawn once per run."""
    from .fields import params

    p = params(specs, seed, index, warmup)
    forms.set(*(p[r] if every or specs[r].per_request else None for r in ("coefficient", "load")))


def sampled(seed: int, share: float) -> Callable[[int], bool]:
    """Which requests are compared: request 0 and each other with
    probability ``share``, drawn from the seed alone."""
    import numpy as np

    from .fields import seed_words

    u = np.random.default_rng([*seed_words(seed), 99]).random(1 << 16)
    return lambda i: i == 0 or (i < u.size and bool(u[i] < share))


def window(prog: Program, cell: Cell, seed: int, seconds: float, trace: bool, device,
           share: float | None = None):
    """The measured window: returns (latencies, iterations, converged,
    window seconds, peak bytes of the window, events or None, the sampled
    answers as ``[(index, the problem's answer)]``). ``share`` replaces
    the cell's sampled share."""
    import torch

    cuda = torch.device(device).type == "cuda"
    pick = sampled(seed, float(cell.checks["share"]) if share is None else share)
    kept, lat, its, conv = [], [], [], []
    prof = None
    if trace and cuda:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.start()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    # what set-up allocated is not garbage: spare the window's full
    # collections a scan of it
    gc.collect()
    gc.freeze()
    t_start = now = time.perf_counter()
    i = 0
    while now - t_start < seconds:
        _set_fields(prog.forms, prog.specs, seed, i)
        u, iterations, converged = prog.request()
        ok = bool(converged)
        _sync(device)
        done = time.perf_counter()
        lat.append(done - now)
        its.append(int(iterations))
        conv.append(ok)
        if len(kept) < MAX_CHECKED and pick(i):
            kept.append((i, u))
        now = done
        i += 1
    window_s = now - t_start
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    events = [] if trace else None
    if prof is not None:
        t_stop = time.perf_counter()
        prof.stop()
        t_read = time.perf_counter()
        from .trace import device_events

        events = device_events(prof)
        print(f"profiler stop {t_read - t_stop:.3f} s, {len(events)} device events read in "
              f"{time.perf_counter() - t_read:.3f} s", file=sys.stderr)
    answers = [(k, prog.problem.answer(cell, prog.basis, u)) for k, u in kept]
    return lat, its, conv, window_s, peak, events, answers


def verdict(cell: Cell, numbers: dict) -> tuple[bool, dict]:
    """``correct`` and ``{name: {"value", "limit"}}`` of the compared numbers:
    the cell's limits and ``unconverged``, the requests of the window that
    did not converge, against 0."""
    limits = {**cell.checks["limits"], "unconverged": 0}
    compared = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return all(c["value"] <= c["limit"] for c in compared.values()), compared


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device="cuda") -> dict:
    """One run of a cell; returns the result line as a dict."""
    import torch

    cell = load_cell(root, workload)
    cuda = torch.device(device).type == "cuda"
    prog = build_program(root, cell, seed, device)
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    setup_s = time.perf_counter() - T0
    lat, its, conv, window_s, peak, events, answers = window(
        prog, cell, seed, seconds, trace, device)
    inputs, specs, tables_s, problem = prog.inputs, prog.specs, prog.tables_s, prog.problem
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    numbers, work = problem.compare(cell, inputs, specs, answers, seed, device)
    quarters = [slice(k * len(lat) // 4, (k + 1) * len(lat) // 4) for k in range(4)]
    per_iteration = [1e3 * sum(lat[q]) / max(1, sum(its[q])) for q in quarters]
    print(f"set-up {setup_s:.3f} s (tables {tables_s:.3f} s); window {window_s:.3f} s, "
          f"{len(lat)} requests, {sum(its) / max(1, len(its)):.2f} iterations a request, ms an "
          f"iteration by quarter {' '.join(f'{x:.4f}' for x in per_iteration)}; check of "
          f"{len(answers)} answers {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    numbers["unconverged"] = conv.count(False)
    correct, compared = verdict(cell, numbers)
    record = RunRecord(setup_s, tables_s, window_s, lat, its, conv, peak, events,
                       work() if trace else None)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = importlib.import_module(f"fem_bench.metrics.{m['name']}").read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": 1 if cuda else 0,
        "memory_peak_bytes": max(setup_peak, peak),
    }
    result = {"correct": bool(correct), "attempted": len(lat), "failed": conv.count(False),
              "metrics": metrics, "device": dev}
    if trace:
        from .trace import busy_s, idle_gaps, top_ops

        dev["busy_s"] = busy_s(events) if events else 0.0
        dev["window_s"] = window_s
        result["breakdown"] = {"device_ops": top_ops(events or []),
                               "idle_gaps": idle_gaps(events or [])}
    result["compared"] = compared
    return result


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "not read"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache the program or its libraries keep goes inside the checkout
    cache = ROOT / ".bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv"), ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
        os.environ[var] = str(cache / sub)
        (cache / sub).mkdir(parents=True, exist_ok=True)
    import torch

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: int(w["chips"]) for w in bench["workloads"]}.get(args.workload, 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s): this benchmark measures the card "
              "and does not fall back to the CPU", file=sys.stderr)
        return 10
    torch.set_num_threads(4)
    print(f"device: {torch.cuda.get_device_name(0)}", file=sys.stderr, flush=True)
    result = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace))
    print(f"card and power limit: {_power_limit()}", file=sys.stderr)
    loaded = sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)
    if loaded:
        print(f"forbidden modules loaded in the run: {', '.join(loaded)}", file=sys.stderr)
        return 11
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
