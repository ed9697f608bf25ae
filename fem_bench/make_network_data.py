"""Write a fracture network's triangulations to a compressed file.

The benchmark hands the same host triangulations to the program and to its
reference, so the network's mesher (seconds of host time, not what the
benchmark measures) runs once, here, and its output is kept in the
repository:

    python3 -m fem_bench.make_network_data fem_bench/configs/dfn2_p1.json

It meshes the configuration's ``geometry`` (the corners of each
rectangular fracture) at its ``h`` with the PyTorch port's
``build_fracture_network`` on the CPU, and writes to the configuration's
``mesh.file``, per fracture, the 2D chart vertices, their boundary labels
and the triangles (local vertex ids), with the 3D corners and 2D anchors of
each chart. It prints the file's size and sha256, which the configuration
records and the loader checks.
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import numpy as np


def write(fractures: list, h: float, out: Path) -> dict:
    """Mesh ``fractures`` at ``h`` into ``out``; returns its size, sha256
    and counts."""
    from pytorch_fem_solver_tpu_torch.mesh.dfn import build_fracture_network

    mesh = build_fracture_network(fractures, h=h, device="cpu")
    src = mesh._sources
    tris = src["triangulations"]
    np.savez_compressed(
        out,
        vertices=np.concatenate([t["vertices"] for t in tris]).astype(np.float64),
        labels=np.concatenate([t["vertex_labels"].reshape(-1) for t in tris]).astype(np.int8),
        triangles=np.concatenate([t["triangles"] for t in tris]).astype(np.int32),
        vertex_counts=np.array([len(t["vertices"]) for t in tris], dtype=np.int64),
        triangle_counts=np.array([len(t["triangles"]) for t in tris], dtype=np.int64),
        corners_3d=np.asarray(src["corners_3d"], dtype=np.float64),
        anchors_2d=np.asarray(src["anchors_2d"], dtype=np.float64),
        h=np.float64(h),
    )
    data = Path(out).read_bytes()
    return {"bytes": len(data), "sha256": hashlib.sha256(data).hexdigest(),
            "cells": int(mesh["cells", "vertices"].shape[0]),
            "glued_vertices": int(mesh["global", "vertices_3d"].shape[0])}


def main(argv: list[str]) -> None:
    path = Path(argv[0])
    cfg = json.loads(path.read_text())
    root = path.resolve().parents[2]
    out = root / cfg["mesh"]["file"]
    print(f"{cfg['mesh']['file']}: {json.dumps(write(cfg['geometry'], cfg['h'], out))}")


if __name__ == "__main__":
    main(sys.argv[1:])
