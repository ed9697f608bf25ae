"""A fracture network from its stored per-fracture triangulations.

The file (``spec["file"]``, relative to the checkout, with its
``spec["sha256"]`` checked at load) holds, for F fractures: ``vertices``
(2D chart coordinates, fracture after fracture), ``labels`` (a vertex's
boundary label, > 0 on a fracture's border), ``triangles`` (local vertex
ids), ``vertex_counts`` and ``triangle_counts`` (F,), ``corners_3d`` (F, 3,
3) and ``anchors_2d`` (F, 3, 2), the three points that fix each chart's
affine map to 3D. ``fem_bench/make_network_data.py`` wrote it.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np


def inputs(spec: dict, root: Path) -> dict:
    path = Path(root) / spec["file"]
    data = path.read_bytes()
    digest = hashlib.sha256(data).hexdigest()
    if digest != spec["sha256"]:
        raise ValueError(f"{path}: sha256 {digest} is not the configuration's {spec['sha256']}")
    with np.load(path) as z:
        out = {k: z[k] for k in z.files}
    vc, tc = out["vertex_counts"], out["triangle_counts"]
    v_off = np.concatenate([[0], np.cumsum(vc)])
    t_off = np.concatenate([[0], np.cumsum(tc)])
    out["triangulations"] = [
        {
            "vertices": out["vertices"][v_off[f]:v_off[f + 1]],
            "triangles": out["triangles"][t_off[f]:t_off[f + 1]].astype(np.int64),
            "vertex_labels": out["labels"][v_off[f]:v_off[f + 1]].astype(np.int64).reshape(-1, 1),
        }
        for f in range(len(vc))
    ]
    out["glue_tol"] = float(spec.get("glue_tol", 1e-9))
    return out


def port_basis(inp: dict, element: dict, device, dtype):
    from pytorch_fem_solver_tpu_torch import ElementTri, FractureNetworkBasis, FractureNetworkMesh

    mesh = FractureNetworkMesh(
        inp["triangulations"], inp["corners_3d"], anchor_vertices_2d=inp["anchors_2d"],
        tol=inp["glue_tol"], device=device, dtype=dtype,
    )
    return FractureNetworkBasis(mesh, ElementTri(element["order"], element["quadrature_degree"]))


def port_vertex_dofs(basis) -> np.ndarray:
    """The program's glued id of each input vertex, in the file's order."""
    return basis.mesh["global", "ids"][:, 0].cpu().numpy().astype(np.int64)
