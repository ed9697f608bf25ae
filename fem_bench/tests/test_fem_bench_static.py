"""Checks that need no run: BENCHMARK.json against the benchmark's
contract, every name it holds found as a file, and the imports of every
module under fem_bench/."""

import ast
import json
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert BENCH["paths"] == ["fem_bench"] and len(BENCH["command"]) <= 32
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("group", list(KEYS))
def test_entries(group):
    names = [e["name"] for e in BENCH[group]]
    assert len(names) == len(set(names))
    for e in BENCH[group]:
        extra = {"workloads"} if group in ("end_to_end", "per_layer") else set()
        assert KEYS[group] <= set(e) <= KEYS[group] | extra, e
        assert NAME.match(e["name"])
        for text in (e.get("why"), e.get("layer"), e.get("source")):
            if text is not None:
                assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")


def test_metrics_and_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    cells = [w["name"] for w in BENCH["workloads"]]
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(cells)
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    assert {"host tables", "PCG loop", "SpMV kernel K2", "device"} == set(layers)


def test_every_name_is_a_file():
    from fem_bench import problems

    configs = {c["name"]: c for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        cfg = json.loads((REPO / configs[w["config"]]["file"]).read_text())
        kind = cfg.get("problem_kind", problems.DEFAULT)
        assert (REPO / f"fem_bench/problems/{kind}.py").exists()
        assert cfg["name"] == w["config"] and cfg["reduced"] == configs[w["config"]]["reduced"]
        traffic = json.loads((REPO / f"fem_bench/traffic/{w['traffic']}.json").read_text())
        # the precision is stated once, by the traffic's entry
        assert traffic["dtype"] in ("float32", "float64") and "dtype" not in cfg
        assert isinstance(traffic["keywords"], dict) and "entries" not in cfg
        assert (REPO / f"fem_bench/entries/{traffic['entry']}.py").exists()
        assert (REPO / f"fem_bench/loads/{cfg['load']}.py").exists()
        assert (REPO / f"fem_bench/meshes/{cfg['mesh']['kind']}.py").exists()
        assert (REPO / f"fem_bench/reference/{cfg['mesh']['kind']}.py").exists()
        checks = json.loads((REPO / f"fem_bench/checks/{w['name']}.json").read_text())
        assert set(checks["limits"]) == set(problems.of(cfg).COMPARED)
        assert 0 < checks["share"] <= 1
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (REPO / f"fem_bench/metrics/{m['name']}.py").exists()


@pytest.mark.parametrize("name", ["run.py", "calibrate.py"])
def test_the_harness_names_no_problem(name):
    """What a cell solves and how it is judged lives in ``problems/``."""
    text = (REPO / "fem_bench" / name).read_text()
    for word in ("p1", "u_err", "reduced_nonzeros", "port_vertex_dofs"):
        assert word not in text, word


def _imports(path: Path) -> set:
    """Top-level names of every absolute import in a module."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


MODULES = sorted((REPO / "fem_bench").rglob("*.py"))


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_anywhere(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "pytorch_fem_solver_tpu"}


@pytest.mark.parametrize("path", sorted((REPO / "fem_bench").rglob("reference/*.py")),
                         ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_program(path):
    assert "pytorch_fem_solver_tpu_torch" not in _imports(path)
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.level:
            assert node.level == 1  # only its own siblings


def test_network_file_is_the_configured_one():
    import hashlib

    cfg = json.loads((REPO / "fem_bench/configs/dfn2_p1.json").read_text())
    data = (REPO / cfg["mesh"]["file"]).read_bytes()
    assert len(data) == cfg["mesh"]["bytes"]
    assert hashlib.sha256(data).hexdigest() == cfg["mesh"]["sha256"]
