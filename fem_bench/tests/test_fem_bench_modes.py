"""The modal problem (``problems/elasticity_modes_p1.py``) in a tiny cell,
``cube_modes.mc_lognormal_k6``: the repository's ``cube48_modes_p1``
configuration on ``kuhn_cube(4)`` under the ``mc_lognormal_k6`` traffic with
the limits of ``cube48_modes_p1.mc_lognormal_k6``, added to a checkout from
files alone and run end to end there on the CPU; perturbed answers and the
TF32 control coming out as not correct; the byte count of
``block_spmv_roofline`` against a count by hand; and the five readers of the
eigensolver's spans and counters on made-up records."""

import json
import os
import subprocess
import sys

import pytest
import torch

import fem_bench.entries.compiled_eigsh
from fem_bench import problems
from fem_bench.metrics import (block_spmv_roofline, eigsh_idle_share, eigsh_products_ms_per_solve,
                               eigsh_rounds_mean, rayleigh_ritz_ms_per_solve)
from fem_bench.run import RunRecord, _set_fields, build_program, load_cell, run_cell
from fem_bench.tests.conftest import REPO
from fem_bench.tests.test_fem_bench_run import SEED, _checkout
from fem_bench.trace import DeviceEvent
from pytorch_fem_solver_tpu_torch.utils import profiling
from pytorch_fem_solver_tpu_torch.utils.profiling import Recording, Span

CELL = "cube_modes.mc_lognormal_k6"
REAL = "cube48_modes_p1.mc_lognormal_k6"
N = 4
READERS = (eigsh_rounds_mean, eigsh_products_ms_per_solve, block_spmv_roofline,
           rayleigh_ritz_ms_per_solve, eigsh_idle_share)

#: run in the checkout's own directory, so that ``fem_bench`` is its copy
IN_CHECKOUT = """
import json, sys
from pathlib import Path
import fem_bench
from fem_bench.run import run_cell

print(json.dumps({"harness": str(Path(fem_bench.__file__).parent),
                  "result": run_cell(Path.cwd(), sys.argv[1], 7, 0.5, True, device="cpu")}))
"""


def _add_modal_cell(root):
    cfg = json.loads((REPO / "fem_bench/configs/cube48_modes_p1.json").read_text())
    cfg.update(name="cube_modes", mesh={"kind": "kuhn_cube", "n": N})
    (root / "fem_bench/configs/cube_modes.json").write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "cube_modes", "source": "a test", "reduced": [],
                             "file": "fem_bench/configs/cube_modes.json", "why": "a test"})
    bench["workloads"].append({"name": CELL, "config": "cube_modes", "traffic": "mc_lognormal_k6",
                               "chips": 1, "why": "a test cell"})
    for m in bench["per_layer"]:
        if REAL in m.get("workloads", ()):
            m["workloads"] = [CELL]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    checks = json.loads((REPO / f"fem_bench/checks/{REAL}.json").read_text())
    (root / f"fem_bench/checks/{CELL}.json").write_text(
        json.dumps({"share": 0.5, "limits": checks["limits"]}))


@pytest.fixture(scope="module")
def modal_root(tiny_root, tmp_path_factory):
    root = _checkout(tiny_root, tmp_path_factory.mktemp("modes"))
    _add_modal_cell(root)
    return root


def test_the_modal_cell_runs_from_files(modal_root):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    out = subprocess.run([sys.executable, "-c", IN_CHECKOUT, CELL], cwd=modal_root, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    r = line["result"]
    assert line["harness"] == str(modal_root / "fem_bench")
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert r["correct"], r["compared"]
    for name in ("lam_err", "res_err"):
        assert 0 < r["compared"][name]["value"] <= r["compared"][name]["limit"]
    # off the card only the counter is read; the event pairs and the trace are the card's
    assert set(r["metrics"]) <= {"eigsh_rounds_mean"}


def _perturbed(kind):
    """Every answer's eigenvalues moved up by 1e-3 relative, or its modes
    handed to the eigenvalues one place over (the last mode to the first)."""
    def wrap(build):
        def wrapped(basis, forms, kwargs):
            request = build(basis, forms, kwargs)

            def perturbed():
                (vals, vecs), rounds, conv = request()
                if kind == "values":
                    vals = vals * (1.0 + 1e-3)
                else:
                    vecs = torch.roll(vecs, 1, dims=1)
                return (vals, vecs), rounds, conv
            return perturbed
        return wrapped
    return wrap


@pytest.mark.parametrize("kind", ["values", "modes"])
def test_perturbed_answers_are_not_correct(modal_root, monkeypatch, kind):
    mod = fem_bench.entries.compiled_eigsh
    monkeypatch.setattr(mod, "build", _perturbed(kind)(mod.build))
    r = run_cell(modal_root, CELL, SEED, 1.0, False, device="cpu")
    assert not r["correct"], r["compared"]
    name = "lam_err" if kind == "values" else "res_err"
    assert r["compared"][name]["value"] > r["compared"][name]["limit"]


def test_the_control_is_not_correct(modal_root):
    """The reference with K and M rounded to TF32, in the program's place,
    fails ``lam_err``; the program itself passes both limits."""
    c = load_cell(modal_root, CELL)
    problem = problems.of(c.config)
    assert problem is problems.elasticity_modes_p1 and problem.control_for(c) == "tf32"
    prog = build_program(modal_root, c, SEED, "cpu")
    assert prog.basis.n_components == 3
    answers = []
    for i in range(2):
        _set_fields(prog.forms, prog.specs, SEED, i)
        u, _, converged = prog.request()
        assert bool(converged)
        answers.append((i, problem.answer(c, prog.basis, u)))
    assert answers[0][1].modes.shape == ((N + 1) ** 3, 3, 6)
    limits = c.checks["limits"]
    bad = problem.compare(c, prog.inputs, prog.specs, answers, SEED, "cpu", control="tf32")[0]
    assert bad["lam_err"] > limits["lam_err"]
    sound, work = problem.compare(c, prog.inputs, prog.specs, answers, SEED, "cpu")
    assert all(sound[k] <= limits[k] for k in problem.COMPARED)
    assert work()["rows"] == 3 * (N - 1) ** 3 and work()["value_bytes"] == 4


def test_block_bytes_match_a_count_by_hand(modal_root):
    """The reduced operator of ``kuhn_cube(3)``: 8 interior vertices, each
    pair of them that shares a tetrahedron a 3 x 3 block, counted here in
    plain Python; a block product moves its values and column indices, the
    row pointer, and an input and an output vector a column."""
    from fem_bench.meshes.kuhn_cube import kuhn_cube
    from fem_bench.reference.kuhn_cube import glue

    g = glue(dict(zip(("vertices", "tetrahedra"), kuhn_cube(3))))
    c = load_cell(modal_root, CELL)
    c = c._replace(config=dict(c.config, mesh={"kind": "kuhn_cube", "n": 3}))
    inputs = dict(zip(("vertices", "tetrahedra"), kuhn_cube(3)))
    _, work = problems.of(c.config).compare(c, inputs, {}, [], SEED, "cpu")
    pairs = {(int(a), int(b)) for cell in g.cells for a in cell for b in cell
             if not g.dirichlet[a] and not g.dirichlet[b]}
    nnz, rows = 9 * len(pairs), 3 * int((~g.dirichlet).sum())
    assert work() == {"nnz": nnz, "rows": rows, "value_bytes": 4}
    products, columns = 7, 2 * 9 + 6 * 9
    by_hand = products * (nnz * 4 + nnz * 4 + (rows + 1) * 4) + columns * (rows * 4 + rows * 4)
    assert block_spmv_roofline.least_bytes(nnz, rows, products, columns) == by_hand


def _eigsh_request(request, t0, first, rounds=2):
    """One request's spans from ``t0`` (ns), at indices from ``first``: the
    assembly, the M's set-up, and the eigensolver: a seed step (2 products,
    1 Rayleigh-Ritz), then each round 5 products, 1 preconditioner
    application, 3 Rayleigh-Ritz steps and a stop test."""
    solve, loop = first, first + 3
    spans = [Span("fem.solve", request, None, t0, t0 + 10_000),
             Span("fem.assemble", request, solve, t0 + 10, t0 + 100, 0.05),
             Span("fem.precond_setup", request, solve, t0 + 100, t0 + 200, 0.03),
             Span("fem.eigsh", request, solve, t0 + 1000, t0 + 9000)]
    at = t0 + 1000
    for kind in ["p", "p", "r"] + ["p", "p", "t", "p", "r", "p", "r", "p", "r", "h"] * rounds:
        name = {"p": "fem.eigsh.product", "r": "fem.eigsh.rr", "t": "fem.eigsh.precond",
                "h": "fem.host_read"}[kind]
        ms = {"p": 0.2, "r": 0.1, "t": 0.05, "h": None}[kind]
        spans.append(Span(name, request, loop, at, at + 100, ms))
        at += 200
    return spans


def _recording(requests=2, rounds=2):
    out = []
    for r in range(requests):
        out += _eigsh_request(r + 1, 20_000 * r, len(out), rounds)
    m = 9
    counters = {"eigsh_rounds": requests * rounds,
                "eigsh_products": requests * (2 + 5 * rounds),
                "eigsh_product_columns": requests * (2 * m + 6 * m * rounds),
                "host_reads": requests * (rounds + 1)}
    return Recording(out, counters)


def _record(**kw):
    #: busy [0, 5000) and [20_000, 21_000): the first eigsh window [1000, 9000)
    #: is busy 4000 ns of 8000, the second [21_000, 29_000) not at all
    base = dict(setup_s=1.0, tables_s=0.5, window_s=1e-6, latencies_s=[1e-3, 1e-3],
                iterations=[2, 2], converged=[True, True], peak_window_bytes=0,
                events=[DeviceEvent("k", 0, 5000), DeviceEvent("k", 20_000, 21_000)],
                work={"nnz": 13_544_019, "rows": 311_469, "value_bytes": 4})
    base.update(kw)
    return RunRecord(**base)


@pytest.fixture
def program(monkeypatch):
    """Make ``recorded()`` return what the test sets."""
    box = {"rec": _recording()}
    monkeypatch.setattr(profiling, "recorded", lambda: box["rec"])
    return box


def test_the_five_readers(program):
    run = _record()
    assert eigsh_rounds_mean.read(run) == 2.0
    # 12 products of 0.2 ms and 7 Rayleigh-Ritz steps of 0.1 ms a request
    assert eigsh_products_ms_per_solve.read(run) == pytest.approx(12 * 0.2)
    assert rayleigh_ritz_ms_per_solve.read(run) == pytest.approx(7 * 0.1)
    assert eigsh_idle_share.read(run) == pytest.approx(100.0 * (1 - 4000 / 16_000))
    products, columns = 2 * 12, 2 * (18 + 2 * 54)
    least = block_spmv_roofline.least_bytes(13_544_019, 311_469, products, columns) / 3.35e12
    share = block_spmv_roofline.read(run)
    assert share == pytest.approx(100.0 * least / (products * 0.2e-3))
    assert 0 < share <= 100


def test_nothing_to_read_from_a_program_without_the_eigensolvers_spans(program):
    """A solve that records no eigensolver (the parent's ``compiled_eigsh``
    records no ``fem.solve``, a linear solve no ``fem.eigsh``): every reader
    finds nothing, and none raises."""
    run = _record()
    program["rec"] = Recording([], {})
    assert all(r.read(run) is None for r in READERS)
    program["rec"] = Recording([Span("fem.solve", 1, None, 0, 10), Span("fem.solve", 2, None, 20, 30)],
                               {"host_reads": 4})
    assert all(r.read(run) is None for r in READERS)


def test_nothing_to_read_off_the_card(program):
    """Off the card the spans have no event pairs and the window no events:
    only the counter is read."""
    program["rec"] = Recording([s._replace(device_ms=None) for s in _recording().spans],
                               _recording().counters)
    run = _record(events=[])
    assert eigsh_rounds_mean.read(run) == 2.0
    assert all(r.read(run) is None for r in READERS[1:])


def test_nothing_to_read_when_the_requests_differ(program):
    run = _record(latencies_s=[1e-3] * 3)
    assert all(r.read(run) is None for r in READERS)
