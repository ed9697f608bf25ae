"""The DFN benchmark's assemble+solve path on the port.

Counterpart of the repo-root ``bench.py:tpu_run_bsr`` with its defaults
``BENCH_SOA=1``, ``BENCH_PRECOND=aggblock`` and ``BENCH_MAX_B=8``: P1
``FractureNetworkBasis`` with ``ElementTri(1, 2)``, canonical-pair assembly
into the hybrid 8x8 BSR layout, the aggregate-block two-level preconditioner
and PCG to a relative residual of ``tol``.

Where the JAX harness builds the (6, T) canonical-pair entries from
``v_grad`` and ``dx`` and the (3, T) load from ``v`` and ``dx`` with XLA, this
path takes both from the output rows of the P1 element kernel K1
(``ops.kernels.p1_element_3d``): the same numbers to roundoff (the JAX
package asserts it), computed by the kernel the port carries over from the
TPU. The per-iteration SpMV is kernel K2 (``ops.bsr.bsr_spmv``).

``make_fused_pcg`` is the counterpart of ``tools/exp_pallas_fused_pcg.py``
on the same assembled system: the stock iteration and the one whose tail
runs through kernels K3/K4 (``ops.fused_pcg``), each as a fixed-length loop
captured as a CUDA graph, and the fused iteration to tolerance.

``adaptive_dfn_level`` is the counterpart of
``examples/example_adaptive_dfn.py:solve_and_estimate``, one level of the
estimator-driven refinement loop on a fracture network: the P1 solve of
``-Δu = 1`` by ``solve_iterative`` (canonical-pair BSR operator, whose SpMV
is K2 on every PCG iteration, and the aggregate two-level M), then the
residual estimator per cell, ``h_T^2 ||f||^2`` plus half of each adjacent
interior edge's flux jump ``h_E ||[du_h/dn]||^2`` from the two-sided traces
onto ``InteriorEdgesNetworkBasis``. ``adaptive_dfn`` runs the loop:
Dörfler marking and ``FractureNetworkMesh.refined`` between the levels.

``tet_poisson`` is the counterpart of ``tools/exp_tet_scale.py``: the sine
Poisson problem on ``unit_cube(n)`` with ``ElementTet(order, 2 order)``
through ``compiled_solver`` (250,047 inner DOFs at its n=64), and
``tet_solve`` the same on a built mesh.
``adaptive_tet`` is the loop of ``examples/example_adaptive_3d.py`` on the
Fichera corner: the P1 solve by ``solve_iterative``, the bulk term plus the
face normal-gradient jumps from the two-sided traces onto
``InteriorFacesBasis``, Dörfler marking and ``MeshTet.refined``. Both run K2
once per PCG iteration, on a 24-wide tier 1.

``p3_poisson`` is the counterpart of the "p3" phase of
``tools/exp_solver_tier.py``: ``Basis(MeshTri(rectangle(n, n)),
ElementTri(3, 5)).compiled_solver`` on the sine Poisson problem, 99,856
DOFs at its n=105. ``dfn_p2_solve`` is the same compiled solve at P2 on a
fracture network (``ElementTri(2, 4)``, the DFN stiffness and unit load of
``adaptive_dfn_level``). Both run K2 on every PCG iteration, on structures
whose block-rows mostly spill into the second tier.
"""

from __future__ import annotations

import time
from typing import Callable, Iterator, NamedTuple

import numpy as np
import torch

from . import config
from .basis import Basis, FractureNetworkBasis, InteriorEdgesNetworkBasis, InteriorFacesBasis
from .element import ElementLine, ElementTet, ElementTri, ElementTriSurface
from .mesh import MeshTet, MeshTri, rectangle, unit_cube
from .mesh.refinement import dorfler_mark
from .ops.bsr import (
    BSRStructure,
    _scatter_drop,
    bsr_complete_symmetric,
    bsr_matvec,
    default_max_b,
    get_bsr_structure,
    inverse_inner_perm,
)
from .ops.compiled import aggblock_setup, bsr_pcg
from .ops.fused_pcg import fused_pcg, fused_pcg_steps, fused_shape
from .ops.kernels import p1_element_3d
from .ops.precondition import AggBlockTwoLevel
from .ops.solvers import PCGInfo, pcg_steps

#: K1 rows of the canonical pairs (0,0) (0,1) (0,2) (1,1) (1,2) (2,2)
SYM_ROWS = (0, 1, 2, 4, 5, 8)
#: K1 rows of the f=1 load
LOAD_ROWS = slice(9, 12)


def benchmark_basis(mesh) -> FractureNetworkBasis:
    """The benchmark's basis: P1 with the order-2 triangle rule."""
    return FractureNetworkBasis(mesh, ElementTri(1, 2))


def _assembly(basis, st):
    """Build the host tables once; return ``assemble() -> (values, b_pad)``:
    K1's rows scattered into the canonical-pair BSR values and the padded
    reduced load vector of the structure ``st``."""
    device = basis.device
    n_cells = int(basis._global_dofs4elements.shape[0])
    coords = basis.mesh["cells", "coordinates_3d"].contiguous()  # (T, 3, 3)

    # (6, T) canonical-pair slots and (3, T) padded rhs slots, transposed
    # on the host so the scatters consume K1's rows as they come
    slots_T = torch.as_tensor(
        basis._as_host_index(st.entry_slot_sym).reshape(n_cells, 6).T.reshape(-1),
        device=device,
    )
    dofs = basis._as_host_index(basis._global_dofs4elements)
    dofs_pad_T = torch.as_tensor(
        inverse_inner_perm(st, basis.n_dofs)[dofs.T.reshape(-1)], device=device
    )
    iu, ju = np.triu_indices(3)
    w6 = torch.as_tensor(
        np.where(iu == ju, 0.5, 1.0), dtype=coords.dtype, device=device
    )[:, None]
    sym_rows = torch.as_tensor(SYM_ROWS, device=device)

    def assemble():
        out = p1_element_3d(coords)  # (13, T)
        e6 = out[sym_rows] * w6  # diagonal pairs pre-halved
        values = bsr_complete_symmetric(
            st, _scatter_drop(slots_T, e6.reshape(-1), st.n_values)
        )
        b_pad = _scatter_drop(dofs_pad_T, out[LOAD_ROWS].reshape(-1), st.n_pad)
        return values, b_pad

    return assemble


def make_bsr_solve(basis, *, max_b: int = 8, tol: float = 1e-6, maxiter: int = 600):
    """Build the host tables once; return ``solve() -> (x_pad, iterations,
    rel_res)``.

    ``x_pad`` is the permuted padded solution (``n_pad``,) of the structure
    ``get_bsr_structure(basis, max_b=max_b)`` (cached on the basis), and
    ``rel_res`` the final residual norm over ``||b||`` as a tensor.
    """
    st = get_bsr_structure(basis, max_b=max_b, want_entry_slot=False)
    assemble = _assembly(basis, st)
    solve_padded = bsr_pcg(st, "auto", tol=tol, maxiter=maxiter)

    def solve():
        values, b_pad = assemble()
        x, info = solve_padded(values, b_pad)
        rel = info.residual_norm / torch.sqrt(torch.dot(b_pad, b_pad))
        return x, info.iterations, rel

    return solve


class FusedPCG(NamedTuple):
    """The assembled benchmark system and its three PCG entry points (see
    ``make_fused_pcg``)."""

    structure: BSRStructure
    values: tuple
    b_pad: torch.Tensor
    precond: AggBlockTwoLevel
    run_stock: Callable  # iters -> (x_pad, r_pad)
    run_fused: Callable  # iters -> (x_pad, r_pad)
    solve_fused: Callable  # tol, maxiter=600 -> (x_pad, iterations, rel_res)


def _capture(loop, b):
    """Capture ``loop(b)`` once as a CUDA graph; returns ``(graph, static_b,
    outputs)``. One warm-up run on a side stream first, as capture needs
    (library handles, kernel loading, the allocator's pool)."""
    static_b = b.clone()
    current = torch.cuda.current_stream(b.device)
    side = torch.cuda.Stream(device=b.device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        loop(static_b)
    current.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = loop(static_b)
    return graph, static_b, out


def _fixed_length(loop, matvec, precond, b):
    """``run(iters) -> (x, r)`` of a fixed-length loop on ``b``: eager on the
    CPU; on the card captured once per ``iters`` as a CUDA graph and
    replayed (the port's ``jax.jit(..., static_argnames=("iters",))`` over
    ``lax.scan``). Launch counts rise at capture (warm-up and capture runs),
    not at replay."""
    graphs = {}

    def run(iters: int):
        if b.device.type == "cpu":
            return loop(matvec, precond, b, iters)
        if iters not in graphs:
            graphs[iters] = _capture(lambda v: loop(matvec, precond, v, iters), b)
        graph, static_b, out = graphs[iters]
        static_b.copy_(b)
        graph.replay()
        return tuple(t.clone() for t in out)

    return run


def make_fused_pcg(basis, *, max_b: int = 8) -> FusedPCG:
    """Assemble the benchmark system once and set up its aggblock
    preconditioner; return the entry points of ``tools/exp_pallas_fused_pcg.py``:

    * ``run_stock(iters)``: ``ops.solvers.pcg_steps``, the stock iteration;
    * ``run_fused(iters)``: ``ops.fused_pcg.fused_pcg_steps``, the same
      iteration with the tail through K3/K4;
    * ``solve_fused(tol, maxiter=600)``: ``ops.fused_pcg.fused_pcg`` to
      tolerance, ``(x_pad, iterations, rel_res)`` as ``make_bsr_solve``.

    The fixed-length runs start from r0 = b (as the tool does) and return
    ``(x_pad, r_pad)``; on the card each is a CUDA graph per ``iters``.
    Raises ``ValueError`` unless the aggregates satisfy the fused algebra
    (``g == gs``).
    """
    st = get_bsr_structure(basis, max_b=max_b, want_entry_slot=False)
    values, b_pad = _assembly(basis, st)()
    precond = aggblock_setup(st)(values)
    fused_shape(precond, st.n_pad)

    def matvec(v):
        return bsr_matvec(st, values, v)

    def solve_fused(tol: float, maxiter: int = 600):
        x, info = fused_pcg(matvec, b_pad, precond, tol=tol, maxiter=maxiter)
        rel = info.residual_norm / torch.sqrt(torch.dot(b_pad, b_pad))
        return x, info.iterations, rel

    return FusedPCG(
        structure=st,
        values=values,
        b_pad=b_pad,
        precond=precond,
        run_stock=_fixed_length(pcg_steps, matvec, precond, b_pad),
        run_fused=_fixed_length(fused_pcg_steps, matvec, precond, b_pad),
        solve_fused=solve_fused,
    )


# -- one level of the adaptive DFN loop ----------------------------------------


class AdaptiveLevel(NamedTuple):
    """One level of ``adaptive_dfn`` or ``adaptive_tet``: what
    ``solve_and_estimate`` returns (``n_dofs``, ``energy`` ``u . b``,
    ``eta`` per cell as float64 NumPy), the solution ``u`` (n_dofs, 1), the
    PCG record, the level's mesh and basis, and the host seconds of its
    parts: ``tables`` (the bases and the BSR structure), ``solve``
    (assembly, preconditioner set-up and PCG), ``estimator``, and in the
    loops also ``refine`` (the refinement that made this level's mesh,
    with its marking in ``adaptive_dfn``; 0 at the first level). ``adaptive_tet`` also gives the level's Dörfler
    marks (``marked``: the cells its refinement bisects) and, at its first
    level, ``seconds["mesh"]`` (the host's ``MeshTet``)."""

    n_dofs: int
    energy: float
    eta: np.ndarray
    u: torch.Tensor
    info: PCGInfo
    mesh: object
    basis: object
    seconds: dict
    marked: np.ndarray | None = None


def _now(device) -> float:
    """Host clock after the device's queued work has finished."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _stiffness(basis):
    return basis.v_grad @ basis.v_grad.mT


def _unit_load(basis):
    return basis.v


def adaptive_dfn_level(mesh, *, tol: float = 1e-10) -> AdaptiveLevel:
    """Solve ``-Δu = 1`` on the network ``mesh`` (P1, ``ElementTri(1, 2)``)
    to the relative residual ``tol`` and estimate the error per cell.

    The indicator of cell T is ``eta_T^2 = 3 h_T^2 |T| + sum_E h_E / 2
    ||[du_h/dn]||^2_E`` over its interior edges E, as the example computes
    it (its bulk term sums the three shape functions' weights); ``h_E`` is
    the lifted 3D edge length and ``n`` the lifted unit normal.
    """
    t0 = _now(mesh.device)
    V = FractureNetworkBasis(mesh, ElementTri(1, 2))
    V_edges = InteriorEdgesNetworkBasis(mesh, ElementLine(1, 2))
    get_bsr_structure(V, max_b=default_max_b(V), want_entry_slot=False)  # cached on V
    t1 = _now(mesh.device)
    b = V.integrate_linear_form(_unit_load)
    u, info = V.solve_iterative(
        V.integrate_bilinear_form_local(_stiffness), b, tol=tol,
        precondition="two_level", symmetric_form=True, return_info=True,
    )
    t2 = _now(mesh.device)
    h_T = mesh["cells", "length"]
    bulk = V.integrate_functional(lambda basis: h_T**2 * 1.0**2 * basis.v**0).reshape(-1)
    _, ug_edges = V.interpolate(V_edges, u)
    n_E = mesh["interior_edges", "normals_3d"][..., None, :, :]
    ec = mesh["interior_edges", "coordinates_3d"]
    h_E = torch.linalg.vector_norm(ec[:, 1] - ec[:, 0], dim=-1)[:, None, None, None]

    def edge_term(basis):
        jump = (ug_edges[:, 0] * n_E).sum(-1, keepdim=True) + (
            ug_edges[:, 1] * -n_E
        ).sum(-1, keepdim=True)
        return h_E * jump**2

    half = 0.5 * V_edges.integrate_functional(edge_term).reshape(-1)
    cells = V_edges._adjacent_cells()
    eta2 = bulk.index_add(0, cells[:, 0], half).index_add(0, cells[:, 1], half)
    eta = torch.sqrt(eta2).to(torch.float64).cpu().numpy()
    energy = float(torch.dot(u[:, 0], b[:, 0]))
    t3 = _now(mesh.device)
    return AdaptiveLevel(
        V.n_dofs, energy, eta, u, info, mesh, V,
        {"tables": t1 - t0, "solve": t2 - t1, "estimator": t3 - t2},
    )


def adaptive_dfn(
    mesh, levels: int = 3, theta: float = 0.5, *, tol: float = 1e-10
) -> Iterator[AdaptiveLevel]:
    """Yield ``levels`` levels of the estimator-driven loop from ``mesh``:
    solve and estimate, then refine the Dörfler set of ``theta``
    (``dorfler_mark``, ``FractureNetworkMesh.refined``) before the next
    level. Each level is yielded before the next mesh is made."""
    refine = 0.0
    for level in range(levels):
        lv = adaptive_dfn_level(mesh, tol=tol)
        lv.seconds["refine"] = refine
        yield lv
        if level + 1 < levels:
            t0 = _now(mesh.device)
            mesh = mesh.refined(dorfler_mark(lv.eta, theta))
            refine = _now(mesh.device) - t0


def adaptive_tet_level(mesh, *, tol: float = 1e-6) -> AdaptiveLevel:
    """Solve ``-Δu = 1`` on the tet ``mesh`` (P1, ``ElementTet(1, 2)``) to
    the relative residual ``tol`` and estimate the error per cell, as
    ``examples/example_adaptive_3d.py:solve_and_estimate``: ``eta_T^2 =
    h_T^2 |T| + sum_F h_F / 2 ||[du_h/dn]||^2_F`` over the interior faces F
    of T, with ``h_F`` the square root of the face's area."""
    t0 = _now(mesh.device)
    V = Basis(mesh, ElementTet(1, 2))
    V_faces = InteriorFacesBasis(mesh, ElementTriSurface(1, 2))
    get_bsr_structure(V, max_b=default_max_b(V), want_entry_slot=False)  # cached on V
    t1 = _now(mesh.device)
    b = V.integrate_linear_form(_unit_load)
    u, info = V.solve_iterative(
        V.integrate_bilinear_form_local(_stiffness), b, tol=tol,
        precondition="two_level", symmetric_form=True, return_info=True,
    )
    t2 = _now(mesh.device)
    h_T = mesh["cells", "length"]
    bulk = V.integrate_functional(lambda basis: h_T**2).reshape(-1)
    _, ug_faces = V.interpolate(V_faces, u)
    n_F = mesh["interior_faces", "normals"][..., None, :, :]
    h_F = torch.sqrt(mesh["interior_faces", "area"])[..., None, :, :]

    def face_term(basis):
        jump = (ug_faces[:, 0] * n_F).sum(-1, keepdim=True) - (
            ug_faces[:, 1] * n_F
        ).sum(-1, keepdim=True)
        return h_F * jump**2

    half = 0.5 * V_faces.integrate_functional(face_term).reshape(-1)
    cells = V_faces._adjacent_cells()
    eta2 = bulk.index_add(0, cells[:, 0], half).index_add(0, cells[:, 1], half)
    eta = torch.sqrt(eta2).to(torch.float64).cpu().numpy()
    energy = float(torch.dot(b[:, 0], u[:, 0]))
    t3 = _now(mesh.device)
    return AdaptiveLevel(
        V.n_dofs, energy, eta, u, info, mesh, V,
        {"tables": t1 - t0, "solve": t2 - t1, "estimator": t3 - t2},
    )


def adaptive_tet(
    tri: dict, levels: int, theta: float = 0.4, *, tol: float = 1e-6,
    device=None, dtype: torch.dtype | None = None,
) -> Iterator[AdaptiveLevel]:
    """Yield ``levels`` levels of the estimator-driven tet loop from the
    triangulation ``tri`` (``fichera_corner(n)``, say): ``MeshTet`` on
    ``device`` (default the card) in ``dtype``, solve and estimate
    (``adaptive_tet_level``), Dörfler-mark ``theta`` of the estimate, then
    bisect the marked cells (``MeshTet.refined``) for the next level. Each
    level is yielded with its marks before the next mesh is made."""
    device = config.resolve_device(device)
    t0 = _now(device)
    mesh = MeshTet(tri, device=device, dtype=dtype)
    seconds = {"mesh": _now(device) - t0, "refine": 0.0}
    for level in range(levels):
        lv = adaptive_tet_level(mesh, tol=tol)
        lv.seconds.update(seconds)
        marked = dorfler_mark(lv.eta, theta)
        yield lv._replace(marked=marked)
        if level + 1 < levels:
            t0 = _now(device)
            mesh = mesh.refined(marked)
            seconds = {"refine": _now(device) - t0}


# -- the higher-order compiled solves ------------------------------------------


class HigherOrderSolve(NamedTuple):
    """A compiled higher-order solve: the solution ``u`` (n_dofs, 1), the
    PCG record, the host seconds of its parts (``basis``, ``tables``: the
    BSR structure and the aggregate table that ``compiled_solver`` builds,
    ``solve``: the first solve), the basis and ``solve() -> (u, info)`` for
    further solves on the built tables."""

    u: torch.Tensor
    info: PCGInfo
    seconds: dict
    basis: object
    solve: Callable


def _compiled(make_basis, a_form, l_form, device, tol) -> HigherOrderSolve:
    t0 = _now(device)
    V = make_basis()
    t1 = _now(device)
    solve = V.compiled_solver(a_form, l_form, tol=tol)
    t2 = _now(device)
    u, info = solve()
    t3 = _now(device)
    return HigherOrderSolve(
        u, info, {"basis": t1 - t0, "tables": t2 - t1, "solve": t3 - t2}, V, solve
    )


def _sine_load(basis):
    x, y = basis.integration_points[..., 0:1], basis.integration_points[..., 1:2]
    return 2 * np.pi**2 * torch.sin(np.pi * x) * torch.sin(np.pi * y) * basis.v


def p3_poisson(
    n: int = 105, *, tol: float = 1e-6, device=None, dtype: torch.dtype | None = None
) -> HigherOrderSolve:
    """``-Δu = 2 π^2 sin(π x) sin(π y)`` on ``rectangle(n, n)`` with zero
    Dirichlet data, P3 (``ElementTri(3, 5)``), through
    ``Basis.compiled_solver`` (canonical-pair BSR assembly, aggregate-block
    two-level M, PCG to the relative residual ``tol``). ``device``
    defaults to the card, ``dtype`` to ``config.default_dtype()``."""
    device = config.resolve_device(device)
    dtype = dtype or config.default_dtype()

    def make_basis():
        return Basis(MeshTri(rectangle(n, n), device=device, dtype=dtype), ElementTri(3, 5))

    return _compiled(make_basis, _stiffness, _sine_load, device, tol)


def _sine_load_3d(basis):
    p = basis.integration_points
    return (
        3 * np.pi**2 * torch.sin(np.pi * p[..., 0:1]) * torch.sin(np.pi * p[..., 1:2])
        * torch.sin(np.pi * p[..., 2:3]) * basis.v
    )


def tet_poisson(
    n: int, order: int = 1, *, tol: float = 1e-6, device=None,
    dtype: torch.dtype | None = None,
) -> HigherOrderSolve:
    """``-Δu = 3 π^2 sin(π x) sin(π y) sin(π z)`` on ``unit_cube(n)`` (6 n^3
    tets) with zero Dirichlet data, P1 or P2 (``ElementTet(order, 2
    order)``), through ``Basis.compiled_solver``: canonical-pair assembly
    into the BSR layout with a 24-wide tier 1, the aggregate-block
    two-level M, PCG to the relative residual ``tol``.
    ``seconds["mesh"]`` is the host's ``MeshTet``; ``device`` defaults to
    the card, ``dtype`` to ``config.default_dtype()``."""
    device = config.resolve_device(device)
    t0 = _now(device)
    mesh = MeshTet(unit_cube(n), device=device, dtype=dtype)
    t_mesh = _now(device) - t0
    r = tet_solve(mesh, order, tol=tol)
    r.seconds["mesh"] = t_mesh
    return r


def tet_solve(mesh, order: int = 1, *, tol: float = 1e-6) -> HigherOrderSolve:
    """``tet_poisson``'s problem and solve on a built ``MeshTet`` of the
    unit cube, on the mesh's device and in its dtype."""
    return _compiled(
        lambda: Basis(mesh, ElementTet(order, 2 * order)), _stiffness, _sine_load_3d,
        mesh.device, tol,
    )


def dfn_p2_solve(mesh, *, tol: float = 1e-6) -> HigherOrderSolve:
    """``-Δu = 1`` on the fracture network ``mesh`` at P2
    (``FractureNetworkBasis(mesh, ElementTri(2, 4))``) through
    ``compiled_solver``, on the mesh's device and in its dtype."""
    return _compiled(
        lambda: FractureNetworkBasis(mesh, ElementTri(2, 4)),
        _stiffness, _unit_load, mesh.device, tol,
    )
