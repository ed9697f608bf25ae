"""Whole runs of tiny cells on the CPU, through ``run_cell`` without the
harness's look for a card: the program against the reference for both
entry points, the result line, and each fault a cell can have (the timed
path broken underneath) coming out as not correct."""

import json
import math
import os
import shutil
import subprocess
import sys

import pytest
import torch

import fem_bench.entries.compiled_refined
import fem_bench.entries.compiled_solver
from fem_bench import forms, problems, work
from fem_bench.run import _set_fields, build_program, load_cell, run_cell, window

from fem_bench.tests.conftest import REPO, TINY, write_cell

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
    problem = problems.of(c.config)
    assert problem.control_for(c) == control
    bad = problem.compare(c, prog.inputs, prog.specs, answers, SEED, "cpu", control=control)[0]
    assert bad["u_err"] > limit
    sound = problem.compare(c, prog.inputs, prog.specs, answers, SEED, "cpu")[0]
    assert sound["u_err"] <= limit


#: the cell of the scalar case, and the files of the three-component
#: problem that the vector cases add, laid out as under fem_bench/
SCALAR_CELL = "cube3.mc_half_sigma"
VECTOR = REPO / "fem_bench/tests/fixtures/vector_laplace"
VECTOR_CELL = "cube_vec.mc_lognormal_vec"

#: run in the checkout's own directory, so that ``fem_bench`` is its copy;
#: argv: the cell, and the factor of the limit by which the largest entry
#: of every answer is moved where it is produced (0: not moved)
IN_CHECKOUT = """
import json, sys
from pathlib import Path
import fem_bench
import fem_bench.entries.compiled_solver as entry
from fem_bench.run import build_program, load_cell, run_cell, window

root = Path.cwd()
cell, factor = sys.argv[1], float(sys.argv[2])
limit = load_cell(root, cell).checks["limits"]["u_err"]
if factor:
    build = entry.build

    def moved(basis, forms, kwargs):
        request = build(basis, forms, kwargs)

        def answer():
            u, its, conv = request()
            u = u.clone().reshape(-1)
            k = int(u.abs().argmax())
            u[k] += factor * limit * u[k].abs()
            return u, its, conv
        return answer
    entry.build = moved
c = load_cell(root, cell)
*_, answers = window(build_program(root, c, 7, "cpu"), c, 7, 0.2, False, "cpu")
print(json.dumps({"harness": str(Path(fem_bench.__file__).parent),
                  "shapes": [list(a.shape) for _, a in answers],
                  "result": run_cell(root, cell, 7, 0.3, True, device="cpu")}))
"""


def _checkout(tiny_root, tmp_path):
    """The tiny cells' files and a copy of the harness's code, as a checkout."""
    root = tmp_path / "checkout"
    shutil.copytree(tiny_root, root)
    shutil.copytree(REPO / "fem_bench", root / "fem_bench", dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("tests", "data", "__pycache__"))
    return root


def _add_scalar_cell(root):
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
    write_cell(root, SCALAR_CELL, "cube3", "mc_half_sigma", {"u_err": 1e-4})


def _add_vector_problem(root):
    for path in VECTOR.rglob("*"):
        if path.is_file() and path.name != "BENCHMARK.entries.json":
            target = root / "fem_bench" / path.relative_to(VECTOR)
            assert not target.exists()
            shutil.copy(path, target)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for group, entries in json.loads((VECTOR / "BENCHMARK.entries.json").read_text()).items():
        bench[group] += entries
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.mark.parametrize("case", ["scalar", "vector", "vector_perturbed"])
def test_a_cell_added_from_files_alone(tiny_root, tmp_path, case):
    """A cell added with a configuration file, a traffic file, a checks
    file and entries in BENCHMARK.json; and a cell of a three-component
    problem, which adds its problem module, its plain reference and a
    metric besides. No file of the harness changes: the run happens in the
    checkout's own copy of it. An answer moved past the limit is not
    correct."""
    root = _checkout(tiny_root, tmp_path)
    before = {p.relative_to(root): p.read_bytes() for p in (root / "fem_bench").rglob("*.py")}
    if case == "scalar":
        _add_scalar_cell(root)
    else:
        _add_vector_problem(root)
    assert all((root / p).read_bytes() == b for p, b in before.items())
    cell = SCALAR_CELL if case == "scalar" else VECTOR_CELL
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    out = subprocess.run([sys.executable, "-c", IN_CHECKOUT, cell,
                          "10" if case == "vector_perturbed" else "0"],
                         cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    r = line["result"]
    assert line["harness"] == str(root / "fem_bench")
    assert r["attempted"] >= 1 and line["shapes"]
    if case == "scalar":
        assert r["correct"], r["compared"]
        assert "pcg_iterations_mean" in r["metrics"]
        return
    v = json.loads((tiny_root / "fem_bench/configs/cube_tiny.json").read_text())["mesh"]["n"] + 1
    assert all(shape == [v**3, 3] for shape in line["shapes"])
    assert set(r["metrics"]) == {"operator_rows", "operator_nonzeros"}
    from fem_bench.meshes.kuhn_cube import kuhn_cube
    from fem_bench.reference.kuhn_cube import glue

    g = glue(dict(zip(("vertices", "tetrahedra"), kuhn_cube(v - 1))))
    nnz, rows = work.reduced_nonzeros(g.cells, g.dirichlet)
    assert r["metrics"]["operator_rows"]["value"] == 3 * rows
    assert r["metrics"]["operator_nonzeros"]["value"] == 9 * nnz
    if case == "vector":
        assert r["correct"], r["compared"]
    else:
        assert not r["correct"] and r["compared"]["unconverged"]["value"] == 0
        assert r["compared"]["u_err"]["value"] > r["compared"]["u_err"]["limit"]


#: at the parent of the move of the comparison into ``problems/``, on the CPU
#: (PyTorch 2.13.0): the first three requests' iterations at SEED, and the
#: ``u_err`` of their answers, sound and under the control, as float.hex
PINNED = {
    "net_tiny.mc_lognormal": ([21, 20, 20], "0x1.f5463d0a3b162p-22", "0x1.5af19ba36cd8bp-10",
                              (1279, 203)),
    "cube_tiny.mc_lognormal": ([2, 2, 2], "0x1.2f3d95cc9c6a3p-22", "0x1.25ea84ff01588p-11",
                               (223, 27)),
    "net_tiny.loadcases_f64": ([58, 57, 56], "0x1.1633f5166937ep-50", "0x1.1bcbc2c40f4c6p-22",
                               (1279, 203)),
}


@pytest.mark.parametrize("cell", CELLS)
def test_the_problem_module_reads_as_before(tiny_root, cell):
    """The Poisson problem gives the same iterations, answers, ``u_err``
    (bitwise), control reading and work as the harness gave before it
    named problems."""
    c = load_cell(tiny_root, cell)
    problem = problems.of(c.config)
    assert problem is problems.poisson_p1 and "problem_kind" not in c.config
    prog = build_program(tiny_root, c, SEED, "cpu")
    its, answers = [], []
    for i in range(3):
        _set_fields(prog.forms, prog.specs, SEED, i)
        u, iterations, _ = prog.request()
        its.append(int(iterations))
        answers.append((i, problem.answer(c, prog.basis, u)))
    numbers, count = problem.compare(c, prog.inputs, prog.specs, answers, SEED, "cpu")
    controlled = problem.compare(c, prog.inputs, prog.specs, answers, SEED, "cpu",
                                 control=problem.control_for(c))[0]
    pinned_its, u_err, control_u_err, (nnz, rows) = PINNED[cell]
    assert its == pinned_its
    assert numbers["u_err"].hex() == u_err and controlled["u_err"].hex() == control_u_err
    assert count() == {"nnz": nnz, "rows": rows}


@pytest.mark.cuda
def test_one_short_run_on_the_card(tiny_root, card):
    r = run_cell(tiny_root, CELLS[1], SEED, 1.0, True, device=card)
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert r["device"]["busy_s"] > 0 and "spmv_roofline" in r["metrics"]
    assert 0 < r["metrics"]["spmv_roofline"]["value"] <= 105
