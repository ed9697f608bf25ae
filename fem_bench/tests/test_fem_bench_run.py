"""Whole runs of tiny cells on the CPU, through ``run_cell`` without the
harness's look for a card: the program against the reference for both
entry points, the result line, and each fault a cell can have (the timed
path broken underneath) coming out as not correct."""

import json
import math
import shutil

import pytest
import torch

import fem_bench.entries.compiled_refined
import fem_bench.entries.compiled_solver
from fem_bench import forms
from fem_bench.run import build_program, judge, load_cell, run_cell, window

from fem_bench.tests.conftest import TINY, write_cell

CELLS = [name for name, _, _ in TINY]
SEED = 2**31 + 5


def _run(root, cell, trace=False, seconds=0.3):
    return run_cell(root, cell, SEED, seconds, trace, device="cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_program_matches_reference(tiny_root, cell):
    r = _run(tiny_root, cell)
    assert r["correct"], r["compared"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert 0 <= r["compared"]["u_err"]["value"] <= r["compared"]["u_err"]["limit"]


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(tiny_root, trace):
    r = _run(tiny_root, CELLS[0], trace=trace)
    line = json.loads(json.dumps(r))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "compared"
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    bench = load_cell(tiny_root, CELLS[0])
    wanted = {m["name"] for m in (bench.per_layer if trace else bench.end_to_end)}
    assert set(line["metrics"]) <= wanted
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"tables_s", "pcg_iterations_mean"} <= set(line["metrics"])
    else:  # off the card, the device readings are left out, never 0
        assert {"solves_per_s", "solve_ms_p95", "setup_s"} <= set(line["metrics"])
        assert "peak_device_gib" not in line["metrics"]


def _stale(build):
    """Every request returns the first request's answer: a step that
    leaves its state unchanged."""
    def wrapped(basis, f, kwargs):
        request, first = build(basis, f, kwargs), []

        def stale():
            u, its, conv = request()
            first.append(first[0] if first else u)
            return first[-1], its, conv
        return stale
    return wrapped


def _altered(build):
    """One entry of every answer moved by a thousandth of the answer's
    largest value, where the answer is produced."""
    def wrapped(basis, f, kwargs):
        request = build(basis, f, kwargs)

        def altered():
            u, its, conv = request()
            u = u.clone().reshape(-1)
            k = int(u.abs().argmax())
            u[k] += 1e-3 * u[k].abs()
            return u, its, conv
        return altered
    return wrapped


def _half_cells(a):
    """The bilinear form with every other cell left out."""
    def half(self, V):
        out = a(self, V)
        keep = torch.ones(out.shape[0], dtype=out.dtype)
        keep[1::2] = 0
        return out * keep.reshape(-1, *([1] * (out.dim() - 1)))
    return half


@pytest.mark.parametrize("fault", ["stale", "altered", "half_cells"])
@pytest.mark.parametrize("cell", [CELLS[0], CELLS[2]])
def test_faults_are_not_correct(tiny_root, monkeypatch, cell, fault):
    if fault == "half_cells":
        monkeypatch.setattr(forms.Forms, "a", _half_cells(forms.Forms.a))
    else:
        wrap = _stale if fault == "stale" else _altered
        for mod in (fem_bench.entries.compiled_solver, fem_bench.entries.compiled_refined):
            monkeypatch.setattr(mod, "build", wrap(mod.build))
    r = _run(tiny_root, cell, seconds=1.0)
    assert not r["correct"], r["compared"]


def _one_unconverged(build):
    """The first request of the window reports that it did not converge
    (the warm-ups before it do not)."""
    def wrapped(basis, f, kwargs):
        request, calls = build(basis, f, kwargs), []

        def flagged():
            u, its, conv = request()
            calls.append(None)
            return u, its, conv and len(calls) != 3
        return flagged
    return wrapped


@pytest.mark.parametrize("cell", [CELLS[0], CELLS[2]])
def test_an_unconverged_request_is_not_correct(tiny_root, monkeypatch, cell):
    for mod in (fem_bench.entries.compiled_solver, fem_bench.entries.compiled_refined):
        monkeypatch.setattr(mod, "build", _one_unconverged(mod.build))
    r = _run(tiny_root, cell)
    assert r["failed"] == 1 and r["compared"]["unconverged"] == {"value": 1, "limit": 0}
    assert r["compared"]["u_err"]["value"] <= r["compared"]["u_err"]["limit"]
    assert not r["correct"]


@pytest.mark.parametrize("cell,control", [(CELLS[0], "tf32"), (CELLS[1], "tf32"),
                                          (CELLS[2], "float32")])
def test_control_is_not_correct(tiny_root, cell, control):
    """The reference in the precision below the cell's, in the program's
    place, fails the limit; the float64 reference itself passes it."""
    c = load_cell(tiny_root, cell)
    prog = build_program(tiny_root, c, SEED, "cpu")
    *_, answers = window(prog, c, SEED, 0.5, False, "cpu")
    limit = c.checks["limits"]["u_err"]
    bad = judge(c, prog.inputs, prog.specs, answers, SEED, "cpu", control=control)[0]
    assert bad["u_err"] > limit
    sound = judge(c, prog.inputs, prog.specs, answers, SEED, "cpu")[0]
    assert sound["u_err"] <= limit


def test_a_cell_added_from_files_alone(tiny_root, tmp_path):
    """A fourth cell needs a configuration file, a traffic file, a checks
    file and an entry in BENCHMARK.json; no file of the harness changes."""
    root = tmp_path / "checkout"
    shutil.copytree(tiny_root, root)
    cfg = json.loads((root / "fem_bench/configs/cube_tiny.json").read_text())
    cfg.update(name="cube3", mesh=dict(cfg["mesh"], n=3))
    (root / "fem_bench/configs/cube3.json").write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "cube3", "source": "a test", "reduced": [],
                             "file": "fem_bench/configs/cube3.json", "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((root / "fem_bench/traffic/mc_lognormal.json").read_text())
    traffic["coefficient"]["sigma"] = 0.5
    (root / "fem_bench/traffic/mc_half_sigma.json").write_text(json.dumps(traffic))
    write_cell(root, "cube3.mc_half_sigma", "cube3", "mc_half_sigma", {"u_err": 1e-4})
    r = run_cell(root, "cube3.mc_half_sigma", 7, 0.3, True, device="cpu")
    assert r["correct"] and r["attempted"] >= 1
    assert "pcg_iterations_mean" in r["metrics"]


@pytest.mark.cuda
def test_one_short_run_on_the_card(tiny_root, card):
    r = run_cell(tiny_root, CELLS[1], SEED, 1.0, True, device=card)
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert r["device"]["busy_s"] > 0 and "spmv_roofline" in r["metrics"]
    assert 0 < r["metrics"]["spmv_roofline"]["value"] <= 105
