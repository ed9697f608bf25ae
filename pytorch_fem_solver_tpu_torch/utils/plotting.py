"""Visualization helpers (matplotlib, no pyvista dependency).

Counterpart of ``pytorch_fem_solver_tpu/utils/plotting.py``: per-cell
scalar maps on 2D meshes, 3D fracture-network renders with per-cell
solution coloring, trace-line plots and per-fracture error maps. Meshes are
read through host copies of their tables and values may be tensors on any
device, so the helpers plot a solve made on the card. matplotlib is
imported only when a helper runs.
"""

from __future__ import annotations

import numpy as np

from ..basis.abstract_basis import host


def _plt():
    import matplotlib

    try:
        import matplotlib.pyplot as plt

        return plt
    except Exception:  # pragma: no cover
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt


def plot_cellwise(mesh, values, label: str = "", ax=None):
    """Per-cell scalar map on a 2D triangle mesh (PolyCollection)."""
    from matplotlib.collections import PolyCollection

    plt = _plt()
    if ax is None:
        _, ax = plt.subplots()
    coords = host(mesh["cells", "coordinates"])
    collection = PolyCollection(
        coords,
        array=host(values).reshape(-1),
        cmap="viridis",
        edgecolors="black",
        linewidths=0.2,
    )
    ax.add_collection(collection)
    ax.autoscale_view()
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.figure.colorbar(collection, ax=ax, label=label)
    return ax


def plot_network_3d(mesh, vertex_values=None, show_traces: bool = True, ax=None):
    """3D render of a fracture network with optional nodal coloring.

    Works with :class:`FractureNetworkMesh` (flat) meshes; each fracture's
    triangles are drawn via plot_trisurf, traces highlighted as black lines.
    """
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    plt = _plt()
    if ax is None:
        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")

    verts3d = host(mesh["vertices", "coordinates_3d"])
    cells = host(mesh["cells", "vertices"])
    polys = verts3d[cells]

    if vertex_values is not None:
        vals = host(vertex_values).reshape(-1)
        cell_vals = vals[cells].mean(axis=1)
        normed = (cell_vals - cell_vals.min()) / max(
            cell_vals.max() - cell_vals.min(), 1e-300
        )
        import matplotlib.cm as cm

        facecolors = cm.viridis(normed)
    else:
        facecolors = (0.4, 0.6, 0.9, 0.4)

    collection = Poly3DCollection(
        polys, facecolors=facecolors, edgecolors="gray", linewidths=0.1
    )
    ax.add_collection3d(collection)

    if show_traces and ("interior_edges", "trace_mask") in mesh:
        tm = host(mesh["interior_edges", "trace_mask"])[:, 0].astype(bool)
        trace_coords = host(mesh["interior_edges", "coordinates_3d"])[tm]
        for seg in trace_coords:
            ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], "k-", linewidth=1.5)

    lo = verts3d.min(axis=0)
    hi = verts3d.max(axis=0)
    ax.set_xlim(lo[0], hi[0])
    ax.set_ylim(lo[1], hi[1])
    ax.set_zlim(lo[2], hi[2])
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    return ax


def plot_trace_profile(mesh, edge_values, label: str = "", ax=None):
    """Values along trace edges, one polyline per trace line (jump plots).

    Trace edges of different traces must not be interleaved into one sorted
    sequence: edges are grouped by the straight 3D line they lie on
    (quantized direction + anchor point), then each group is plotted against
    its own arc-length parameter.
    """
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots()
    tm = host(mesh["interior_edges", "trace_mask"])[:, 0].astype(bool)
    coords = host(mesh["interior_edges", "coordinates_3d"])[tm]
    mids = coords.mean(axis=1)
    vals = host(edge_values).reshape(-1)[tm]

    vec = coords[:, 1] - coords[:, 0]
    d = vec / np.maximum(np.linalg.norm(vec, axis=-1, keepdims=True), 1e-300)
    # canonical sign: first nonzero component positive
    lead = np.argmax(np.abs(d) > 1e-9, axis=-1)
    sign = np.sign(d[np.arange(len(d)), lead])
    d = d * sign[:, None]
    anchor = mids - (mids * d).sum(-1, keepdims=True) * d
    scale = max(float(np.abs(coords).max()), 1.0)
    key = np.round(np.concatenate([d, anchor / scale], axis=1) / 1e-6)
    _, group = np.unique(key, axis=0, return_inverse=True)

    for gid in np.unique(group):
        sel = group == gid
        t = (mids[sel] * d[sel]).sum(-1)
        order = np.argsort(t)
        lbl = label or None
        if label and np.unique(group).size > 1:
            lbl = f"{label} (trace {gid})"
        ax.plot(t[order], vals[sel][order], "o-", label=lbl)
    ax.set_xlabel("arc position along trace")
    if label:
        ax.legend()
    return ax


def plot_error_maps_per_fracture(mesh, cell_errors, title: str = "", axes=None):
    """Per-fracture per-element error maps with one shared colorbar.

    Matplotlib parity for the upstream fracture VPINN example's
    relative-error figure: one PolyCollection per fracture in LOCAL 2D
    coordinates, face colors from a single Normalize over all fractures,
    shared vertical colorbar.

    Works for flat :class:`FractureNetworkMesh` (per-cell fracture ids) and,
    trivially, single-fracture 2D meshes.
    """
    from matplotlib import cm, colors
    from matplotlib.collections import PolyCollection

    plt = _plt()
    errs = host(cell_errors).reshape(-1)
    coords = host(mesh["cells", "coordinates"])  # (T, 3, 2) local
    try:
        frac = host(mesh["cells", "fracture"]).reshape(-1)
    except Exception:
        frac = np.zeros(coords.shape[0], dtype=int)
    frac_ids = np.unique(frac)

    norm = colors.Normalize(vmin=float(errs.min()), vmax=float(errs.max()))
    cmap = plt.get_cmap("viridis")
    if axes is None:
        fig, axes = plt.subplots(
            1, len(frac_ids), figsize=(6 * len(frac_ids), 3), dpi=200,
            squeeze=False,
        )
        axes = axes[0]
    else:
        fig = axes[0].figure
    if title:
        fig.suptitle(title, fontsize=14)
    for ax, fid in zip(axes, frac_ids):
        sel = frac == fid
        ax.add_collection(
            PolyCollection(
                coords[sel],
                facecolors=cmap(norm(errs[sel])),
                edgecolors="black",
                linewidths=0.2,
            )
        )
        ax.autoscale()
        ax.set_aspect("equal")
        ax.set_title(f"Fracture {int(fid) + 1}")
    sm = cm.ScalarMappable(cmap=cmap, norm=norm)
    sm.set_array(errs)
    fig.colorbar(
        sm, ax=list(axes), orientation="vertical", label="error"
    )
    return axes
