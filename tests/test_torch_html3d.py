"""PyTorch port, ``utils/html3d.py`` and ``utils/plotting.py`` against the
JAX package in float64.

``viridis_rgb`` equals JAX's. ``export_network_html`` writes a standalone
page (no external URL) whose embedded JSON payload equals the JAX page's,
key by key, in the cases of the JAX package's ``tests/test_html3d.py``:
the h=0.5 seven-fracture network with vertex values in the glued global
numbering, with cell values, geometry only, and a planar
``unit_square(n=4)`` with vertex values; values given as tensors. The
validation errors are JAX's. The plotting helpers run on the Agg backend
on the port's meshes, the twin of ``tests/test_single_fracture.py::
test_plotting_helpers_run``, plus the per-fracture error maps.
"""

import json
import re

import numpy as np
import pytest
import torch

import pytorch_fem_solver_tpu as fem
import pytorch_fem_solver_tpu_torch as pt
from pytorch_fem_solver_tpu.utils import build_benchmark_network
from pytorch_fem_solver_tpu.utils.html3d import export_network_html as jax_export
from pytorch_fem_solver_tpu.utils.html3d import viridis_rgb as jax_viridis
from pytorch_fem_solver_tpu_torch import config
from pytorch_fem_solver_tpu_torch.utils.html3d import export_network_html, viridis_rgb

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)

F1 = [[-1, 0, 0], [1, 0, 0], [1, 1, 0], [-1, 1, 0]]
F2 = [[0, 0, -1], [0, 0, 1], [0, 1, 1], [0, 1, -1]]


def _payload(path):
    text = open(path).read()
    assert "<canvas" in text
    assert "http://" not in text and "https://" not in text
    m = re.search(r"const D=(\{.*?\});\n", text, re.S)
    assert m, "embedded data payload not found"
    return json.loads(m.group(1)), text


def _same_page(ours, ref):
    d, text = _payload(ours)
    d_ref, text_ref = _payload(ref)
    assert d.keys() == d_ref.keys()
    for key in d_ref:
        assert d[key] == d_ref[key], key
    assert text == text_ref
    return d


def test_viridis_rgb_matches_jax():
    t = np.linspace(-0.2, 1.2, 29)
    rgb = viridis_rgb(torch.from_numpy(t))
    np.testing.assert_array_equal(rgb, jax_viridis(t))
    np.testing.assert_allclose(rgb[0], [0.267004, 0.004874, 0.329415])


@pytest.fixture(scope="module")
def networks():
    return build_benchmark_network(h=0.5), pt.build_benchmark_network(0.5, device="cpu")


def test_export_dfn_vertex_mode(networks, tmp_path):
    jmesh, pmesh = networks
    n_global = np.asarray(jmesh["global", "vertices_3d"]).shape[0]
    u = np.sin(np.arange(n_global, dtype=np.float64))
    ref = jax_export(jmesh, str(tmp_path / "ref.html"), vertex_values=u, title="u")
    ours = export_network_html(pmesh, str(tmp_path / "sol.html"),
                               vertex_values=torch.from_numpy(u), title="u")
    d = _same_page(ours, ref)
    assert len(d["lines"]) > 0 and d["vmax"] > d["vmin"]


def test_export_dfn_cell_and_geometry_modes(networks, tmp_path):
    jmesh, pmesh = networks
    err = np.abs(np.cos(np.arange(int(jmesh.n_cells), dtype=np.float64)))
    ref = jax_export(jmesh, str(tmp_path / "ref.html"), cell_values=err, title="err")
    ours = export_network_html(pmesh, str(tmp_path / "err.html"),
                               cell_values=torch.from_numpy(err), title="err")
    d = _same_page(ours, ref)
    assert len(d["positions"]) == 9 * int(jmesh.n_cells)  # flat shading
    ref = jax_export(jmesh, str(tmp_path / "geo_ref.html"), clim=(0.0, 1.0))
    _same_page(export_network_html(pmesh, str(tmp_path / "geo.html"), clim=(0.0, 1.0)), ref)


def test_export_planar_mesh_and_validation(tmp_path):
    jmesh = fem.MeshTri(fem.unit_square(n=4))
    pmesh = pt.MeshTri(pt.unit_square(n=4), device="cpu")
    n_verts = np.asarray(jmesh["vertices", "coordinates"]).shape[0]
    vals = np.arange(n_verts, dtype=np.float64)
    ref = jax_export(jmesh, str(tmp_path / "ref.html"), vertex_values=vals)
    _same_page(export_network_html(pmesh, str(tmp_path / "sq.html"),
                                   vertex_values=torch.from_numpy(vals)), ref)
    with pytest.raises(ValueError, match="not both"):
        export_network_html(pmesh, str(tmp_path / "x.html"), vertex_values=np.zeros(n_verts),
                            cell_values=np.zeros(int(pmesh.n_cells)))
    with pytest.raises(ValueError, match="entries"):
        export_network_html(pmesh, str(tmp_path / "y.html"), vertex_values=np.zeros(3))
    with pytest.raises(ValueError, match="entries"):
        export_network_html(pmesh, str(tmp_path / "z.html"), cell_values=np.zeros(3))


def test_plotting_helpers_run():
    """The helpers run headless on 2D and network meshes, with tensor
    values."""
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from pytorch_fem_solver_tpu_torch.utils.plotting import (
        plot_cellwise,
        plot_error_maps_per_fracture,
        plot_network_3d,
        plot_trace_profile,
    )

    mesh2 = pt.MeshTri(pt.unit_square(n=3), device="cpu")
    ax = plot_cellwise(mesh2, torch.arange(mesh2.n_cells, dtype=torch.float64), "test")
    assert len(ax.collections) == 1
    net = pt.build_fracture_network([F1, F2], h=0.5, device="cpu")
    y = net["vertices", "coordinates_3d"][:, 1]
    ax3 = plot_network_3d(net, vertex_values=y)
    assert len(ax3.lines) > 0  # the trace segments
    n_edges = net["interior_edges", "vertices"].shape[0]
    ax_t = plot_trace_profile(net, torch.ones(n_edges), "jump")
    assert len(ax_t.lines) >= 1
    axes = plot_error_maps_per_fracture(net, torch.rand(int(net.n_cells), dtype=torch.float64),
                                        title="err")
    assert len(axes) == 2
    plt.close("all")
