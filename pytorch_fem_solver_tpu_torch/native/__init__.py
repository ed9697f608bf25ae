"""Native (C++) host-side structure kernels with a NumPy fallback.

The port's own copy of ``pytorch_fem_solver_tpu/native``: the same
``src/fem_native.cpp``, built on first use with the system ``g++`` into this
directory and loaded with ctypes. This is host code for construction-time
tables (mesh topology, BSR layout), not a device kernel. If the toolchain is
missing, or ``FEM_NATIVE=0`` is set, callers take their NumPy paths, which
produce byte-identical outputs.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

__all__ = [
    "available",
    "radix_argsort",
    "sort_unique",
    "bsr_pair_ranks",
    "tet_face_edge_keys",
    "unique_edges",
]

_SRC = Path(__file__).parent / "src" / "fem_native.cpp"
_LIB_NAME = "_fem_native.so"

_lib = None
_tried = False


def _build_and_load():
    """Compile (if stale) and dlopen the native library; None on failure."""
    lib_path = Path(__file__).parent / _LIB_NAME
    tmp_path = None
    try:
        if (
            not lib_path.exists()
            or lib_path.stat().st_mtime < _SRC.stat().st_mtime
        ):
            # build to a temp file then rename: atomic for concurrent imports
            with tempfile.NamedTemporaryFile(
                dir=lib_path.parent, suffix=".so", delete=False
            ) as tmp:
                tmp_path = Path(tmp.name)
            cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                   "-o", str(tmp_path), str(_SRC)]
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            tmp_path.replace(lib_path)
            tmp_path = None
        lib = ctypes.CDLL(str(lib_path))
    except (OSError, subprocess.SubprocessError, ValueError):
        return None
    finally:
        if tmp_path is not None:
            tmp_path.unlink(missing_ok=True)

    i64, i64p = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
    lib.fem_radix_argsort.argtypes = [i64p, i64, i64p]
    lib.fem_radix_argsort.restype = None
    lib.fem_sort_unique.argtypes = [i64p, i64] + [i64p] * 4
    lib.fem_sort_unique.restype = i64
    lib.fem_unique_edges.argtypes = [i64p, i64, i64] + [i64p] * 4
    lib.fem_unique_edges.restype = i64
    lib.fem_bsr_pair_ranks.argtypes = [i64p, i64, i64, i64p, i64, i64] + [
        i64p
    ] * 5
    lib.fem_bsr_pair_ranks.restype = i64
    lib.fem_tet_face_edge_keys.argtypes = [i64p, i64, i64, i64p, i64p]
    lib.fem_tet_face_edge_keys.restype = None
    return lib


def _get_lib():
    global _lib, _tried
    if not _tried:
        _tried = True
        if os.environ.get("FEM_NATIVE", "1") != "0":
            _lib = _build_and_load()
    return _lib


def available() -> bool:
    """Whether the native library is compiled and loaded."""
    return _get_lib() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _as_i64(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a), dtype=np.int64)


def radix_argsort(keys) -> np.ndarray | None:
    """Stable ascending argsort of int64 keys; None if native unavailable."""
    lib = _get_lib()
    if lib is None:
        return None
    keys = _as_i64(keys)
    order = np.empty(keys.size, dtype=np.int64)
    lib.fem_radix_argsort(_ptr(keys), keys.size, _ptr(order))
    return order


def sort_unique(keys):
    """(order, unique, inverse, counts) of int64 keys; None if unavailable.

    Matches ``np.unique(keys, return_inverse=True, return_counts=True)``
    plus the stable argsort that NumPy computes internally.
    """
    lib = _get_lib()
    if lib is None:
        return None
    keys = _as_i64(keys)
    n = keys.size
    order = np.empty(n, dtype=np.int64)
    uniq = np.empty(n, dtype=np.int64)
    inverse = np.empty(n, dtype=np.int64)
    counts = np.empty(n, dtype=np.int64)
    nu = lib.fem_sort_unique(
        _ptr(keys), n, _ptr(order), _ptr(uniq), _ptr(inverse), _ptr(counts)
    )
    return order, uniq[:nu].copy(), inverse, counts[:nu].copy()


def unique_edges(cells, n_vertices: int):
    """(edges (E,2), inverse (3T,), counts (E,), order (3T,)) or None.

    Raises ValueError on non-manifold input (edge shared by >2 triangles),
    mirroring the NumPy path in ``mesh.topology.build_tri_topology``.
    """
    lib = _get_lib()
    if lib is None:
        return None
    cells = _as_i64(cells)
    T = cells.shape[0]
    edges = np.empty((3 * T, 2), dtype=np.int64)
    inverse = np.empty(3 * T, dtype=np.int64)
    counts = np.empty(3 * T, dtype=np.int64)
    order = np.empty(3 * T, dtype=np.int64)
    E = lib.fem_unique_edges(
        _ptr(cells), T, int(n_vertices),
        _ptr(edges), _ptr(inverse), _ptr(counts), _ptr(order),
    )
    if E < 0:
        raise ValueError("non-manifold mesh: an edge is shared by >2 triangles")
    return edges[:E].copy(), inverse, counts[:E].copy(), order


def bsr_pair_ranks(dofs, new_id, block: int, nb: int):
    """Fused BSR entry expansion + block-pair dedup; None if unavailable.

    Returns ``(rank_all, in_block, bkeys, rank_sym, in_block_sym)``: per
    ORIGINAL flat entry the ascending-unique-block rank (-1 =
    Dirichlet-dropped) and in-block position, the ascending unique block
    keys (brow * nb + bcol), and the same rank/in-block data for the
    canonical representative of each unordered DOF pair in
    ``np.triu_indices`` order. Byte-identical to the NumPy fallback in
    ``ops.bsr.build_bsr_structure``.
    """
    lib = _get_lib()
    if lib is None:
        return None
    dofs = _as_i64(dofs)
    new_id = _as_i64(new_id)
    T, n_loc = dofs.shape
    n_entries = T * n_loc * n_loc
    n_pairs = T * n_loc * (n_loc + 1) // 2
    rank_all = np.empty(n_entries, dtype=np.int64)
    in_block = np.empty(n_entries, dtype=np.int64)
    bkeys = np.empty(max(n_entries, 1), dtype=np.int64)
    rank_sym = np.empty(n_pairs, dtype=np.int64)
    in_block_sym = np.empty(n_pairs, dtype=np.int64)
    nu = lib.fem_bsr_pair_ranks(
        _ptr(dofs), T, n_loc, _ptr(new_id), int(block), int(nb),
        _ptr(rank_all), _ptr(in_block), _ptr(bkeys),
        _ptr(rank_sym), _ptr(in_block_sym),
    )
    return rank_all, in_block, bkeys[:nu].copy(), rank_sym, in_block_sym


def tet_face_edge_keys(tets, n_vertices: int):
    """Sorted scalar face/edge codes of a tet mesh; None if unavailable.

    Face order matches ``TET_FACE_PERMUTATIONS``, edge order
    ``TET_EDGE_PERMUTATIONS`` (``mesh.topology``).
    """
    lib = _get_lib()
    if lib is None:
        return None
    tets = _as_i64(tets)
    T = tets.shape[0]
    face_codes = np.empty(4 * T, dtype=np.int64)
    edge_codes = np.empty(6 * T, dtype=np.int64)
    lib.fem_tet_face_edge_keys(
        _ptr(tets), T, int(n_vertices), _ptr(face_codes), _ptr(edge_codes)
    )
    return face_codes, edge_codes
