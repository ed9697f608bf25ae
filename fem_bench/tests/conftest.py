"""Fixtures of the benchmark's own tests: a checkout-like directory with
tiny cells of both mesh inputs and both entry points, built from files
only, and the card, decided inside a fixture."""

from __future__ import annotations

import hashlib
import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
#: the tiny cells: (name, configuration, traffic)
TINY = (
    ("net_tiny.mc_lognormal", "net_tiny", "mc_lognormal"),
    ("cube_tiny.mc_lognormal", "cube_tiny", "mc_lognormal"),
    ("net_tiny.loadcases_f64", "net_tiny", "loadcases_f64"),
)
#: the repository's cell whose limits each tiny cell takes, or the limits
#: themselves where the repository has no such cell (the load-case cell's,
#: set from the card's readings: section 2 of PERF.md)
REAL = {
    "net_tiny.mc_lognormal": "dfn2_p1.mc_lognormal",
    "cube_tiny.mc_lognormal": "cube64_p1.mc_lognormal",
    "net_tiny.loadcases_f64": {"u_err": 5e-10},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: runs on the CUDA card; skips unless torch.cuda.is_available()")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return "cuda"


def write_cell(root: Path, name: str, config: str, traffic: str, limits: dict,
               share: float = 0.5) -> None:
    """Add one cell to ``root/BENCHMARK.json`` with its checks file."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": name, "config": config, "traffic": traffic, "chips": 1,
                               "why": "a test cell"})
    for m in bench["per_layer"]:
        m.setdefault("workloads", []).append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    (root / "fem_bench" / "checks" / f"{name}.json").write_text(
        json.dumps({"share": share, "limits": limits}))


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    """A directory holding a BENCHMARK.json whose cells are tiny copies of
    the repository's, on its network meshed at h = 0.125 and ``kuhn_cube(4)``,
    with the repository's traffic files and limits."""
    from fem_bench import make_network_data

    root = tmp_path_factory.mktemp("bench")
    for sub in ("configs", "traffic", "checks", "data"):
        (root / "fem_bench" / sub).mkdir(parents=True)
    net = root / "fem_bench" / "data" / "net.npz"
    cfg = json.loads((REPO / "fem_bench/configs/dfn2_p1.json").read_text())
    make_network_data.write(cfg["geometry"], 0.125, net)
    cfg.update(name="net_tiny", h=0.125)
    cfg["mesh"].update(file="fem_bench/data/net.npz",
                       sha256=hashlib.sha256(net.read_bytes()).hexdigest())
    (root / "fem_bench/configs/net_tiny.json").write_text(json.dumps(cfg))
    cfg = json.loads((REPO / "fem_bench/configs/cube64_p1.json").read_text())
    cfg["name"] = "cube_tiny"
    cfg["mesh"]["n"] = 4
    (root / "fem_bench/configs/cube_tiny.json").write_text(json.dumps(cfg))
    for t in ("mc_lognormal", "loadcases_f64"):
        shutil.copy(REPO / f"fem_bench/traffic/{t}.json", root / f"fem_bench/traffic/{t}.json")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [
        {"name": n, "source": "a test", "file": f"fem_bench/configs/{n}.json", "reduced": [],
         "why": "a test configuration"} for n in ("net_tiny", "cube_tiny")]
    bench["workloads"] = []
    for m in bench["per_layer"]:
        m["workloads"] = []
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for name, config, traffic in TINY:
        limits = REAL[name] if isinstance(REAL[name], dict) else json.loads(
            (REPO / f"fem_bench/checks/{REAL[name]}.json").read_text())["limits"]
        write_cell(root, name, config, traffic, limits)
    return root
