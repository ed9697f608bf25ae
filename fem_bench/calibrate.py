"""Readings that a cell's limits are set from (``fem_bench/checks/<cell>.json``).

    python3 -m fem_bench.calibrate --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...] --control-seeds <n> [<n> ...]

For each seed, in one process: the program's set-up, a short window at the
cell's own load and the comparison of its first answers (as many as a run
compares) with the problem's reference, as a run makes it (the lower
reading of each compared number is the largest over the seeds). For each
control seed, the same requests solved by the reference itself in the
precision below the one the cell states (the problem's ``control_for``), in
the program's place (the upper reading is the smallest), under the
compared names with ``control_`` before them. One JSON line per seed, then
a summary line. Runs on the card; the benchmark's own runs never run the
control.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

from . import problems
from .run import ROOT, build_program, load_cell, window


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 10
    cell = load_cell(ROOT, args.workload)
    problem = problems.of(cell.config)
    control = problem.control_for(cell)
    sound, controlled = [], []
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        prog = build_program(ROOT, cell, seed, args.device)
        lat, its, conv, window_s, _, _, answers = window(
            prog, cell, seed, args.seconds, False, args.device, share=1.0)
        inputs, specs = prog.inputs, prog.specs
        del prog
        gc.collect()
        line = {"seed": seed, "attempted": len(lat), "failed": conv.count(False),
                "checked": [i for i, _ in answers]}
        if seed in args.seeds:
            numbers = problem.compare(cell, inputs, specs, answers, seed, args.device)[0]
            line.update(numbers)
            sound.append(numbers)
        if seed in args.control_seeds:
            numbers = problem.compare(cell, inputs, specs, answers, seed, args.device,
                                      control=control)[0]
            line["control"] = control
            line.update({f"control_{k}": v for k, v in numbers.items()})
            controlled.append(numbers)
        print(json.dumps(line), flush=True)

    def reading(runs, pick):
        return {k: pick(n[k] for n in runs) for k in problem.COMPARED} if runs else None

    print(json.dumps({"workload": args.workload, "seeds": len(sound),
                      "lower_reading": reading(sound, max), "control_seeds": len(controlled),
                      "upper_reading": reading(controlled, min),
                      "device": torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
