"""PyTorch port, host layer: guards, device rule, native kernels, meshes.

The port's host code is its own copy of the JAX package's NumPy code, so
its outputs must be byte-identical on the same inputs: the native C++
helpers, the DFN builder and every array of the frozen mesh.
"""

import ast
import pathlib
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import pytorch_fem_solver_tpu as fem
import pytorch_fem_solver_tpu_torch as pt
from pytorch_fem_solver_tpu import native as jnative
from pytorch_fem_solver_tpu.mesh.topology import build_tri_topology as jax_topology
from pytorch_fem_solver_tpu.utils import build_benchmark_network as jax_network
from pytorch_fem_solver_tpu_torch import config, interop
from pytorch_fem_solver_tpu_torch import native as pnative
from pytorch_fem_solver_tpu_torch.mesh.topology import build_tri_topology

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "pytorch_fem_solver_tpu"}


@pytest.fixture(scope="module")
def meshes():
    jm = jax_network(h=0.25)
    pm = pt.build_benchmark_network(0.25, device="cpu", dtype=torch.float64)
    return jm, pm


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "pytorch_fem_solver_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    offenders = {
        str(p.relative_to(REPO)): sorted(_imported_roots(p) & FORBIDDEN)
        for p in files
    }
    assert {k: v for k, v in offenders.items() if v} == {}
    # the exact-name rule: the port's own package name is not a match
    assert "pytorch_fem_solver_tpu_torch" not in FORBIDDEN


_BLOCKED_IMPORTS = textwrap.dedent(
    """
    import importlib, importlib.abc, importlib.util, pathlib, sys

    FORBIDDEN = ("jax", "pytorch_fem_solver_tpu")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in FORBIDDEN:
                raise ImportError("blocked import of " + name)
            return None

    sys.meta_path.insert(0, Block())
    root = pathlib.Path("pytorch_fem_solver_tpu_torch")
    names = sorted(
        ".".join(p.with_suffix("").parts).removesuffix(".__init__")
        for p in root.rglob("*.py")
        if "_build" not in p.parts
    )
    for name in names:
        importlib.import_module(name)
    spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    leaked = [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]
    assert not leaked, leaked
    print(len(names))
    """
)


def test_every_port_module_imports_with_jax_blocked():
    """The no-JAX rule, executed: in a fresh interpreter where importing
    ``jax`` or ``pytorch_fem_solver_tpu`` raises, every module of the port
    and ``chip_smoke.py`` import."""
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORTS],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) > 30


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        config.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.build_benchmark_network(0.5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.MeshTri({"vertices": np.eye(3)[:, :2], "triangles": [[0, 1, 2]]})
    from pytorch_fem_solver_tpu_torch.bench_vpinn import (
        make_dfn_rvpinn,
        make_rvpinn,
        make_two_fracture,
    )

    for entry in (
        lambda: pt.FeedForwardNeuralNetwork(2, 1, 1, 4),
        lambda: pt.MeshesTri([pt.unit_square(n=2)]),
        lambda: make_rvpinn(n=2, width=2, depth=1),
        lambda: make_two_fracture(n=2),
        lambda: make_dfn_rvpinn(0.5),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()
    assert config.resolve_device("cpu") == torch.device("cpu")


def test_config_defaults():
    assert config.index_dtype() == torch.int32
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    config.set_default_dtype(None)
    try:
        assert config.default_dtype() == torch.float32
    finally:
        config.set_default_dtype(torch.float64)


@pytest.mark.parametrize("use_native", [True, False])
def test_native_helpers_byte_identical(use_native, monkeypatch):
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 50, size=400)
    cells = np.sort(rng.choice(30, size=(20, 3), replace=True), axis=1)
    cells = cells[(cells[:, 0] != cells[:, 1]) & (cells[:, 1] != cells[:, 2])]
    dofs = rng.integers(0, 40, size=(25, 3))
    new_id = np.where(rng.random(40) < 0.8, rng.permutation(40), -1)
    if not use_native:
        # the port's NumPy fallback must equal the JAX package's native path
        monkeypatch.setattr(pnative, "_lib", None)
        monkeypatch.setattr(pnative, "_tried", True)
        assert pnative.sort_unique(keys) is None
        tri = fem.unit_square(n=5)
        verts = np.asarray(tri["vertices"])
        tris = np.asarray(tri["triangles"])
        ours = build_tri_topology(verts, tris, None)
        ref = jax_topology(verts, tris, None)
        assert set(ours) == set(ref)
        for key in ref:
            np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)
        return
    assert pnative.available() and jnative.available()
    for a, b in zip(pnative.sort_unique(keys), jnative.sort_unique(keys)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(pnative.unique_edges(cells, 30), jnative.unique_edges(cells, 30)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(
        pnative.bsr_pair_ranks(dofs, new_id, 8, 5),
        jnative.bsr_pair_ranks(dofs, new_id, 8, 5),
    ):
        np.testing.assert_array_equal(a, b)


def test_benchmark_mesh_byte_identical(meshes):
    jm, pm = meshes
    assert pm.n_cells == jm.n_cells == 3216
    assert pm.n_global_dofs == jm.n_global_dofs
    jtree = dict(_flatten(jax.tree_util.tree_map(np.asarray, jm._t)))
    ptree = dict(_flatten(pm._t))
    assert set(jtree) == set(ptree)
    for key, j in jtree.items():
        p = ptree[key]
        assert p.device.type == "cpu"
        if j.dtype.kind == "f":
            assert p.dtype == torch.float64, key
        else:
            assert p.dtype == torch.int32, key
        np.testing.assert_array_equal(p.numpy(), j, err_msg=str(key))


def test_mesh_from_numpy_and_dtype_move(meshes):
    jm, pm = meshes
    arrays = jax.tree_util.tree_map(np.asarray, jm._t)
    m = interop.mesh_from_numpy(arrays, device="cpu", dtype=torch.float64)
    assert isinstance(m, pt.FractureNetworkMesh)
    assert m.n_fractures == 7 and m.n_global_dofs == pm.n_global_dofs
    ours = dict(_flatten(pm._t))
    for key, a in _flatten(m._t):
        assert torch.equal(a, ours[key]), key
    m32 = m.to(dtype=torch.float32)
    assert m32.dtype == torch.float32 and m32["cells", "vertices"].dtype == torch.int32
    assert m.dtype == torch.float64  # the original is untouched
    np.testing.assert_array_equal(
        m32["cells", "coordinates_3d"].numpy(),
        m["cells", "coordinates_3d"].numpy().astype(np.float32),
    )


def test_unported_refinement_raises(meshes):
    jm, pm = meshes
    # adaptive refinement is ported: the refined benchmark network is JAX's,
    # every table byte-identical, on the same device and dtype
    marked = np.zeros(pm.n_cells, dtype=bool)
    marked[::7] = True
    fine, ref = pm.refined(marked), jm.refined(marked)
    assert fine.n_cells == ref.n_cells > pm.n_cells and fine.dtype == torch.float64
    ours = dict(_flatten(fine._t))
    for key, value in _flatten(ref._t):
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(value), err_msg=str(key))
    # P2/P3 are ported (tests/test_torch_higher_order.py); P4 raises, as in
    # the JAX package
    with pytest.raises(NotImplementedError, match="Polynomial order"):
        pt.ElementTri(4, 4)
