"""The elasticity problem (``problems/elasticity_p1.py``) in a tiny cell,
``cube_elast.mc_lognormal``: the repository's ``cube64_elast_p1``
configuration on ``kuhn_cube(5)`` under the ``mc_lognormal`` traffic with
the limits of ``cube64_elast_p1.mc_lognormal``, added to a checkout from
files alone and run end to end there on the CPU; and its TF32 control,
which must come out not correct, on the same six requests whatever the
host's speed (9.2e-4 against the limit 5e-4 at this size; 4.9e-3 and
more at the cell's)."""

import json
import os
import subprocess
import sys

from fem_bench import problems
from fem_bench.run import _set_fields, build_program, load_cell
from fem_bench.tests.conftest import REPO, write_cell
from fem_bench.tests.test_fem_bench_run import IN_CHECKOUT, SEED, _checkout

CELL = "cube_elast.mc_lognormal"
N = 5


def _add_elasticity_cell(root):
    cfg = json.loads((REPO / "fem_bench/configs/cube64_elast_p1.json").read_text())
    cfg.update(name="cube_elast", mesh={"kind": "kuhn_cube", "n": N})
    (root / "fem_bench/configs/cube_elast.json").write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "cube_elast", "source": "a test", "reduced": [],
                             "file": "fem_bench/configs/cube_elast.json", "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    limits = json.loads(
        (REPO / "fem_bench/checks/cube64_elast_p1.mc_lognormal.json").read_text())["limits"]
    write_cell(root, CELL, "cube_elast", "mc_lognormal", limits)


def test_the_elasticity_cell_runs_from_files(tiny_root, tmp_path):
    root = _checkout(tiny_root, tmp_path)
    before = {p.relative_to(root): p.read_bytes() for p in (root / "fem_bench").rglob("*.py")}
    _add_elasticity_cell(root)
    assert all((root / p).read_bytes() == b for p, b in before.items())
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    out = subprocess.run([sys.executable, "-c", IN_CHECKOUT, CELL, "0"], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    r = line["result"]
    assert line["harness"] == str(root / "fem_bench")
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert line["shapes"] and all(s == [(N + 1) ** 3, 3] for s in line["shapes"])
    assert r["correct"], r["compared"]
    assert 0 < r["compared"]["u_err"]["value"] <= r["compared"]["u_err"]["limit"]


def test_the_elasticity_control_is_not_correct(tiny_root, tmp_path):
    root = _checkout(tiny_root, tmp_path)
    _add_elasticity_cell(root)
    c = load_cell(root, CELL)
    problem = problems.of(c.config)
    assert problem is problems.elasticity_p1 and problem.control_for(c) == "tf32"
    prog = build_program(root, c, SEED, "cpu")
    assert prog.basis.n_components == 3
    answers = []
    for i in range(6):
        _set_fields(prog.forms, prog.specs, SEED, i)
        u, _, converged = prog.request()
        assert bool(converged)
        answers.append((i, problem.answer(c, prog.basis, u)))
    limit = c.checks["limits"]["u_err"]
    bad = problem.compare(c, prog.inputs, prog.specs, answers, SEED, "cpu", control="tf32")[0]
    assert bad["u_err"] > limit
    sound, work = problem.compare(c, prog.inputs, prog.specs, answers, SEED, "cpu")
    assert sound["u_err"] <= limit
    assert work()["rows"] == 3 * (N - 1) ** 3
