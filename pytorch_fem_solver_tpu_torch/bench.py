"""The DFN benchmark's assemble+solve path on the port.

Counterpart of the repo-root ``bench.py:tpu_run_bsr`` with ``BENCH_SOA=1``
and ``BENCH_MAX_B=8``: P1 ``FractureNetworkBasis`` with ``ElementTri(1,
2)``, canonical-pair assembly into the hybrid 8x8 BSR layout, a
preconditioner and PCG to a relative residual of ``tol``.
``make_bsr_solve``'s ``precond`` takes the values of ``BENCH_PRECOND``
(default ``aggblock``, the aggregate-block two-level M) branch by branch,
with ``BENCH_PRECOND_DTYPE``, ``BENCH_AGG``, ``BENCH_AGG_SMOOTH`` and
``BENCH_OMEGA`` as ``operand_dtype``, ``g``, ``gs`` and ``omega``.
``python3 -m pytorch_fem_solver_tpu_torch.bench precond NAME H [bf16]``
solves the network at ``h=H`` that way on the card and prints one JSON
line.

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
``tet_solve`` the same on a built mesh. Above 2M cells (from n=70 at P1,
e.g. the table's n=80 and n=100 rungs) ``compiled_solver`` streams the
assembly over chunks of 2^18 cells by default. Run as a module,
``python3 -m pytorch_fem_solver_tpu_torch.bench tet_poisson N`` solves
``tet_poisson(N)`` on the card in float32 and prints one JSON line: the
sizes, iterations and residual, the walls of three more solves on the
built tables, the peak device memory and the host seconds.
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

``elasticity_2d`` and ``elasticity_3d`` are the linear-elasticity solves of
``examples/example_elasticity.py`` (plane strain on ``unit_square(n=n)``,
``ElementTri(1, 4)``) and ``examples/example_elasticity_3d.py`` (the bubble
displacement on ``unit_cube(n)``, ``ElementTet(1, 2)``, its body force
written out by hand), μ=1 and λ=2, through ``VectorBasis.compiled_solver``:
canonical-pair assembly of the interleaved vector DOFs, the rigid-body-mode
two-level M and PCG on K2. ``python3 -m pytorch_fem_solver_tpu_torch.bench
elasticity_3d N`` prints one JSON line as ``tet_poisson N`` does.
``newton_dfn`` (``examples/example_nonlinear_dfn.py``, k(u) = 0.5 + u^2 on
a fracture network) and ``newton_elasticity`` (the strain-stiffening
elasticity residual of the JAX package's ``tests/test_newton.py``) run
``compiled_newton``: jvp Jacobians, BiCGStab on K2 (two launches per
iteration) and the per-step two-level M.

``refined_dfn`` is ``tools/exp_refine_tpu.py``: the benchmark network's
stiffness and unit load through ``compiled_refined`` on a float64 basis,
float32 two-level PCG stages on K2 in float32 and the true residual on K2
in float64. ``refined_elasticity`` is the explicit-rhs vector case of the
JAX package's ``tests/test_refine.py`` (the vector Laplacian on
``rectangle(n, n)``, the rigid-body-mode M) at a given size.
``eigsh_square`` is the "eigsh" phase of ``tools/exp_solver_tier.py``: the
smallest Dirichlet Laplace modes on ``rectangle(n, n)`` (P1,
``ElementTri(1, 3)``; 100,489 DOFs at its n=316) through
``compiled_eigsh``, LOBPCG or subspace iteration; ``eigsh_dfn`` the same on
a fracture network and ``eigsh_elasticity`` the elastic modes of the JAX
package's ``tests/test_eigen.py`` (μ=1, λ=1.5, the vector mass) on
``unit_square(n=n)``. ``python3 -m pytorch_fem_solver_tpu_torch.bench
refined H`` and ``eigsh N`` print one JSON line each.

``stokes_problem`` is ``tools/exp_stokes_breakdown.py``'s problem
(Taylor-Hood P2-P1 on ``rectangle(n, n)``, the full-gradient viscous form,
``-q div u``, a solenoidal plus gradient load) and ``stokes_solver_of`` its
named configurations through ``compiled_stokes_solver``: every inner
A-solve runs K2 once per PCG iteration (once per column on the scalar
path). ``python3 -m pytorch_fem_solver_tpu_torch.bench stokes N`` solves
the float64 truth and every configuration in float32 and prints one JSON
line.
"""

from __future__ import annotations

import time
from typing import Callable, Iterator, NamedTuple

import numpy as np
import torch

from . import config
from .basis import (
    Basis,
    FractureNetworkBasis,
    InteriorEdgesNetworkBasis,
    InteriorFacesBasis,
    VectorBasis,
)
from .element import ElementLine, ElementTet, ElementTri, ElementTriSurface
from .mesh import MeshTet, MeshTri, rectangle, unit_cube, unit_square
from .ops.refine import RefineInfo
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
from .ops.compiled import PRECONDITIONERS, aggblock_setup, bsr_pcg
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


def make_bsr_solve(
    basis,
    *,
    max_b: int = 8,
    tol: float = 1e-6,
    maxiter: int = 600,
    precond: str = "aggblock",
    operand_dtype=None,
    g: int | None = None,
    gs: int | None = None,
    omega: float = 0.8,
):
    """Build the host tables once; return ``solve() -> (x_pad, iterations,
    rel_res)``.

    ``x_pad`` is the permuted padded solution (``n_pad``,) of the structure
    ``get_bsr_structure(basis, max_b=max_b)`` (cached on the basis), and
    ``rel_res`` the final residual norm over ``||b||`` as a tensor.
    ``precond`` is one of the repo-root ``bench.py``'s ``BENCH_PRECOND``
    names (``aggblock``, ``two_level``, ``mult``, ``mult3``,
    ``three_level``, ``affine``, ``auto``, ``smoothed``, ``jacobi``; see
    ``ops.compiled.preconditioner_setup``), ``operand_dtype`` its
    ``BENCH_PRECOND_DTYPE`` (``torch.bfloat16`` for ``bf16``), ``g`` and
    ``gs`` its ``BENCH_AGG`` and ``BENCH_AGG_SMOOTH`` (None: adaptive) and
    ``omega`` its ``BENCH_OMEGA`` (the smoothed M's damping).
    """
    st = get_bsr_structure(basis, max_b=max_b, want_entry_slot=False)
    assemble = _assembly(basis, st)
    solve_padded = bsr_pcg(
        st, precond, tol=tol, maxiter=maxiter, basis=basis, operand_dtype=operand_dtype,
        g=g, gs=gs, omega=omega,
    )

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


# -- linear elasticity and Newton ----------------------------------------------

#: Lamé parameters of the elasticity workloads (the examples' defaults)
MU, LAM = 1.0, 2.0
#: base conductivity of ``newton_dfn`` (``example_nonlinear_dfn.py``'s K0)
K0 = 0.5


def _swap(g):
    return g.transpose(-1, -2)


def _trace(g):
    return g.diagonal(dim1=-2, dim2=-1).sum(-1)


def elasticity_form(basis):
    """The Lamé form ∫ 2 μ ε(u):ε(v) + λ div u div v of a vector basis."""
    g = basis.v_grad  # (T, q|1, n_vloc, nc, d)
    eps = 0.5 * (g + _swap(g))
    div = _trace(g)
    return (
        2 * MU * torch.einsum("...icd,...jcd->...ij", eps, eps)
        + LAM * div[..., :, None] * div[..., None, :]
    )


def plate_exact(x, y):
    """``example_elasticity.py``'s displacement: (sin πx sin πy, x(1-x)y(1-y))."""
    return torch.stack(
        [torch.sin(np.pi * x) * torch.sin(np.pi * y), x * (1 - x) * y * (1 - y)], dim=-1
    )


def _plate_load(basis):
    x = basis.integration_points[..., 0]
    y = basis.integration_points[..., 1]
    s, c, pi = torch.sin, torch.cos, np.pi
    f1 = MU * 2 * pi**2 * s(pi * x) * s(pi * y) + (MU + LAM) * (
        pi**2 * s(pi * x) * s(pi * y) - (1 - 2 * x) * (1 - 2 * y)
    )
    f2 = MU * (2 * y * (1 - y) + 2 * x * (1 - x)) - (MU + LAM) * (
        pi**2 * c(pi * x) * c(pi * y) - 2 * x * (1 - x)
    )
    return (basis.v * torch.stack([f1, f2], dim=-1)).sum(-1, keepdim=True)


def bubble_body_force(p):
    """f = -div σ(u) of ``example_elasticity_3d.py``'s u = w (1, 2, -1),
    w = x(1-x) y(1-y) z(1-z), written out: f_i = -(μ a_i Δw + (μ+λ)
    Σ_j a_j ∂_i∂_j w) with a = (1, 2, -1). ``p`` is (..., 3)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    X, Y, Z = x * (1 - x), y * (1 - y), z * (1 - z)
    dX, dY, dZ = 1 - 2 * x, 1 - 2 * y, 1 - 2 * z
    hxx, hyy, hzz = -2 * Y * Z, -2 * X * Z, -2 * X * Y
    hxy, hxz, hyz = dX * dY * Z, dX * Y * dZ, X * dY * dZ
    lap = hxx + hyy + hzz
    a = (1.0, 2.0, -1.0)
    hess = ((hxx, hxy, hxz), (hxy, hyy, hyz), (hxz, hyz, hzz))
    return torch.stack([
        -(MU * a[i] * lap + (MU + LAM) * sum(a[j] * hess[i][j] for j in range(3)))
        for i in range(3)
    ], dim=-1)


def bubble_exact(p):
    """``example_elasticity_3d.py``'s displacement w (1, 2, -1)."""
    w = p[..., 0] * (1 - p[..., 0]) * p[..., 1] * (1 - p[..., 1]) * p[..., 2] * (1 - p[..., 2])
    return torch.stack([w, 2 * w, -w], dim=-1)


def _bubble_load(basis):
    f = bubble_body_force(basis.integration_points[..., 0, :])  # (T, q, 3)
    return (basis.v * f[..., None, :]).sum(-1, keepdim=True)


def l2_error(basis, u, exact):
    """||u_h - u*||_{L2} of a vector solution against ``exact(points)``
    (points (T, q, d), values (T, q, nc))."""
    uh, _ = basis.interpolate(basis, u)
    err2 = ((uh[..., 0, :] - exact(basis.integration_points[..., 0, :])) ** 2).sum(-1)
    return float(torch.sqrt(basis.integrate_functional(lambda b: err2[..., None, None]).sum()))


def elasticity_2d(
    n: int, *, tol: float = 1e-6, device=None, dtype: torch.dtype | None = None
) -> HigherOrderSolve:
    """Plane strain on ``unit_square(n=n)`` (``example_elasticity.py``):
    ``VectorBasis(MeshTri, ElementTri(1, 4))``, the Lamé form and the body
    force of ``plate_exact``, zero Dirichlet data, through
    ``compiled_solver`` (RBM ``"auto"``) to the relative residual ``tol``.
    ``device`` defaults to the card, ``dtype`` to
    ``config.default_dtype()``."""
    device = config.resolve_device(device)

    def make_basis():
        mesh = MeshTri(unit_square(n=n), device=device, dtype=dtype)
        return VectorBasis(mesh, ElementTri(1, 4))

    return _compiled(make_basis, elasticity_form, _plate_load, device, tol)


def elasticity_3d(
    n: int, *, tol: float = 1e-6, device=None, dtype: torch.dtype | None = None
) -> HigherOrderSolve:
    """The bubble problem of ``example_elasticity_3d.py`` on
    ``unit_cube(n)`` (6 n^3 tets): ``VectorBasis(MeshTet, ElementTet(1,
    2))``, the Lamé form and ``bubble_body_force``, through
    ``compiled_solver`` (RBM ``"auto"``, 6 modes per aggregate).
    ``seconds["mesh"]`` is the host's ``MeshTet``."""
    device = config.resolve_device(device)
    t0 = _now(device)
    mesh = MeshTet(unit_cube(n), device=device, dtype=dtype)
    t_mesh = _now(device) - t0
    r = _compiled(
        lambda: VectorBasis(mesh, ElementTet(1, 2)), elasticity_form, _bubble_load, device, tol
    )
    r.seconds["mesh"] = t_mesh
    return r


class NewtonRun(NamedTuple):
    """A compiled Newton solve: the solution, ``(iterations,
    residual_norm, converged)``, the host seconds of its parts (``basis``,
    ``tables``, ``solve``: the first solve), the basis, the residual form
    and ``solve(u0=None) -> (u, info)`` on the built tables."""

    u: torch.Tensor
    info: tuple
    seconds: dict
    basis: object
    residual: Callable
    solve: Callable


def _newton(make_basis, residual, device, tol) -> NewtonRun:
    t0 = _now(device)
    V = make_basis()
    t1 = _now(device)
    solve = V.compiled_newton(residual, tol=tol, precondition="auto")
    t2 = _now(device)
    u, info = solve()
    t3 = _now(device)
    return NewtonRun(
        u, info, {"basis": t1 - t0, "tables": t2 - t1, "solve": t3 - t2}, V, residual, solve
    )


def dfn_residual(basis, u, ug):
    """``example_nonlinear_dfn.py``: -div((K0 + u^2) grad u) = 1."""
    return (K0 + u**2) * (basis.v_grad * ug).sum(-1, keepdim=True) - basis.v


def newton_dfn(mesh, *, tol: float = 1e-5) -> NewtonRun:
    """``example_nonlinear_dfn.py`` on the fracture network ``mesh``
    (``FractureNetworkBasis``, ``ElementTri(1, 2)``, k(u) = 0.5 + u^2, f = 1,
    zero Dirichlet data) through ``compiled_newton`` to ``tol`` (the
    example asks 1e-10, out of float32's reach), on the mesh's device and in
    its dtype; ``build_benchmark_network(h)`` makes the example's mesh."""
    return _newton(
        lambda: FractureNetworkBasis(mesh, ElementTri(1, 2)), dfn_residual, mesh.device, tol
    )


def stiffening_residual(basis, u, ug):
    """The strain-stiffening elasticity residual of the JAX package's
    ``tests/test_newton.py``: μ(u) = 1 + |u|^2, λ = 1.5 and the body force
    (0, -1)."""
    mu_u = 1.0 + (u**2).sum(-1, keepdim=True)
    eps_u = 0.5 * (ug + _swap(ug))
    eps_v = 0.5 * (basis.v_grad + _swap(basis.v_grad))
    return (
        2 * mu_u * torch.einsum("...ocd,...lcd->...lo", eps_u, eps_v)
        + 1.5 * (_trace(ug)[..., None, :] * _trace(basis.v_grad)[..., :, None])
        + basis.v[..., 1:2]  # minus the body force's work (0, -1) . v
    )


def newton_elasticity(
    n: int, *, tol: float = 1e-5, device=None, dtype: torch.dtype | None = None
) -> NewtonRun:
    """``stiffening_residual`` on ``unit_square(n=n)`` with
    ``VectorBasis(MeshTri, ElementTri(1, 3))`` through ``compiled_newton``
    (``"auto"``: the rigid-body-mode M rebuilt from each step's Jacobian
    values)."""
    device = config.resolve_device(device)

    def make_basis():
        return VectorBasis(MeshTri(unit_square(n=n), device=device, dtype=dtype), ElementTri(1, 3))

    return _newton(make_basis, stiffening_residual, device, tol)


# -- mixed-precision refinement and eigensolves --------------------------------


class RefinedSolve(NamedTuple):
    """A refined solve: the solution, the ``RefineInfo``, the host seconds
    of its parts (``basis``, ``tables``: the float64 assembly and the
    preconditioner's host tables, ``solve``: the first solve), the basis and
    ``solve() -> (u, RefineInfo)`` on the built tables."""

    u: torch.Tensor
    info: RefineInfo
    seconds: dict
    basis: object
    solve: Callable


def _refined(make_basis, a_form, l_form, refine, tol32, explicit_rhs=False) -> RefinedSolve:
    t0 = time.perf_counter()
    V = make_basis()
    t1 = _now(V.device)
    if explicit_rhs:
        b = V.integrate_linear_form(l_form)
        solve_b = V.compiled_refined(a_form, refine=refine, tol32=tol32)

        def solve():
            return solve_b(b)
    else:
        solve = V.compiled_refined(a_form, l_form, refine=refine, tol32=tol32)
    t2 = _now(V.device)
    u, info = solve()
    t3 = _now(V.device)
    return RefinedSolve(
        u, info, {"basis": t1 - t0, "tables": t2 - t1, "solve": t3 - t2}, V, solve
    )


def refined_dfn(mesh, *, refine: int = 2, tol32: float = 1e-6) -> RefinedSolve:
    """``tools/exp_refine_tpu.py``: -Δu = 1 on the float64 fracture network
    ``mesh`` (``FractureNetworkBasis``, ``ElementTri(1, 2)``) through
    ``compiled_refined`` with ``refine`` passes and the float32 inner
    tolerance ``tol32``, on the mesh's device;
    ``build_benchmark_network(h, dtype=torch.float64)`` makes its mesh."""
    return _refined(
        lambda: FractureNetworkBasis(mesh, ElementTri(1, 2)), _stiffness, _unit_load,
        refine, tol32,
    )


def vector_laplacian(basis):
    """The vector Laplacian ∫ ∇u : ∇v of the JAX package's
    ``tests/test_refine.py``."""
    return torch.einsum("...icd,...jcd->...ij", basis.v_grad, basis.v_grad)


def _component_sum_load(basis):
    return basis.v.sum(-1, keepdim=True)


def refined_elasticity(
    n: int, *, refine: int = 2, tol32: float = 1e-5, device=None
) -> RefinedSolve:
    """The explicit-rhs vector case of the JAX package's
    ``tests/test_refine.py`` on ``rectangle(n, n)``: ``VectorBasis``,
    ``ElementTri(1, 2)``, ``vector_laplacian`` and the load Σ_c v_c,
    assembled beforehand in float64 and passed to ``solve(b)`` (the
    rigid-body-mode M). ``device`` defaults to the card."""
    device = config.resolve_device(device)

    def make_basis():
        mesh = MeshTri(rectangle(n, n), device=device, dtype=torch.float64)
        return VectorBasis(mesh, ElementTri(1, 2))

    return _refined(make_basis, vector_laplacian, _component_sum_load, refine, tol32,
                    explicit_rhs=True)


class EigshRun(NamedTuple):
    """A compiled eigensolve: the eigenvalues, the eigenvectors (n_dofs,
    k), ``(rounds, eig_change, converged)``, the host seconds of its parts
    (``basis``, ``tables``, ``solve``: the first solve), the basis, the
    two forms and ``solve()`` on the built tables."""

    vals: torch.Tensor
    vecs: torch.Tensor
    info: tuple
    seconds: dict
    basis: object
    forms: tuple
    solve: Callable


def _mass(basis):
    return basis.v @ basis.v.mT


def _eigsh(make_basis, a_form, m_form, k, **kwargs) -> EigshRun:
    t0 = time.perf_counter()
    V = make_basis()
    t1 = _now(V.device)
    solve = V.compiled_eigsh(a_form, m_form, k=k, **kwargs)
    t2 = _now(V.device)
    vals, vecs, info = solve()
    t3 = _now(V.device)
    return EigshRun(vals, vecs, info, {"basis": t1 - t0, "tables": t2 - t1, "solve": t3 - t2},
                    V, (a_form, m_form), solve)


def eigsh_square(
    n: int = 316, k: int = 6, *, method: str = "lobpcg", tol: float = 1e-5, device=None,
    dtype: torch.dtype | None = None,
) -> EigshRun:
    """The smallest ``k`` Dirichlet Laplace modes on ``rectangle(n, n)``
    (P1, ``ElementTri(1, 3)``) through ``compiled_eigsh`` (the aggregate
    two-level M; subspace iteration's inner solves to 1e-6): the "eigsh"
    phase of ``tools/exp_solver_tier.py`` at its defaults. ``device``
    defaults to the card, ``dtype`` to ``config.default_dtype()``."""
    device = config.resolve_device(device)
    return _eigsh(
        lambda: Basis(MeshTri(rectangle(n, n), device=device, dtype=dtype), ElementTri(1, 3)),
        _stiffness, _mass, k, method=method, tol=tol, solve_tol=1e-6,
    )


def eigsh_dfn(mesh, k: int = 6, *, tol: float = 1e-5) -> EigshRun:
    """The smallest ``k`` modes of the stiffness / mass pencil on the
    fracture network ``mesh`` (``FractureNetworkBasis``, ``ElementTri(1,
    2)``) by LOBPCG, on the mesh's device and in its dtype."""
    return _eigsh(lambda: FractureNetworkBasis(mesh, ElementTri(1, 2)), _stiffness, _mass, k,
                  tol=tol)


def modal_elasticity_form(basis):
    """The Lamé form of the JAX package's ``tests/test_eigen.py`` elastic
    modes: μ=1, λ=1.5."""
    g = basis.v_grad
    eps = 0.5 * (g + _swap(g))
    div = _trace(g)
    return (2.0 * torch.einsum("...icd,...jcd->...ij", eps, eps)
            + 1.5 * div[..., :, None] * div[..., None, :])


def vector_mass(basis):
    return torch.einsum("...ic,...jc->...ij", basis.v, basis.v)


def eigsh_elasticity(
    n: int, k: int = 6, *, method: str = "lobpcg", tol: float = 1e-5,
    solve_tol: float = 1e-6, device=None, dtype: torch.dtype | None = None,
) -> EigshRun:
    """The smallest ``k`` elastic modes (``modal_elasticity_form``,
    ``vector_mass``) on ``unit_square(n=n)``, ``VectorBasis`` with
    ``ElementTri(1, 2)``, through ``compiled_eigsh`` (the rigid-body-mode
    M)."""
    device = config.resolve_device(device)

    def make_basis():
        return VectorBasis(MeshTri(unit_square(n=n), device=device, dtype=dtype), ElementTri(1, 2))

    return _eigsh(make_basis, modal_elasticity_form, vector_mass, k, method=method, tol=tol,
                  solve_tol=solve_tol)


# -- Stokes ---------------------------------------------------------------------


def stokes_viscous(basis):
    """The full-gradient viscous form ∫ ∇u : ∇v, component-decoupled: its
    scalar twin is ``_stiffness``."""
    return torch.einsum("...icd,...jcd->...ij", basis.v_grad, basis.v_grad)


def stokes_div(test_p, trial_u):
    """The Taylor-Hood coupling B[q, u] = -∫ q div u."""
    div = _trace(trial_u.v_grad)
    return -(test_p.v[..., 0][..., :, None] * div[..., None, :])


def _stokes_load(basis):
    """The solenoidal curl of sin(πx) sin(πy) (an O(1) velocity) plus a
    gradient part (a nontrivial pressure)."""
    pts = basis.integration_points[..., 0, :]
    x, y = pts[..., 0], pts[..., 1]
    s, c, pi = torch.sin, torch.cos, np.pi
    fx = pi * s(pi * x) * c(pi * y) + 0.3 * s(pi * x)
    fy = -pi * c(pi * x) * s(pi * y) + 0.3 * y**2
    return (basis.v * torch.stack([fx, fy], dim=-1)[..., None, :]).sum(-1, keepdim=True)


def stokes_problem(n: int = 115, *, device=None, dtype: torch.dtype | None = None):
    """``tools/exp_stokes_breakdown.py:build_problem``: Taylor-Hood P2-P1 on
    ``rectangle(n, n)`` (106,722 velocity and 13,456 pressure DOFs at its
    n=115): ``(Vu, Vp, f)`` with ``VectorBasis(ElementTri(2, 4))``,
    ``Basis(ElementTri(1, 4))`` and the assembled load. ``device`` defaults
    to the card, ``dtype`` to ``config.default_dtype()``."""
    device = config.resolve_device(device)
    mesh = MeshTri(rectangle(n, n), device=device, dtype=dtype)
    Vu = VectorBasis(mesh, ElementTri(2, 4))
    return Vu, Basis(mesh, ElementTri(1, 4)), Vu.integrate_linear_form(_stokes_load)


_REC = {"f_solve_tol": 1e-5, "recovery_tol": 1e-5}
#: the breakdown's named configurations, each with ``inner_maxiter=400``:
#: the default schedule, the campaign's recommended one, the
#: component-decoupled scalar A, the fixed-iteration control and MINRES
STOKES_CONFIGS = {
    "base": {"tol": 1e-5, "inner_tol": 1e-6},
    "aggcomp_floor3max1": {"tol": 1e-5, "inner_tol": 1e-3, "inner_tol_max": 1e-1,
                           "precondition": "agg_comp", **_REC},
    "scalar": {"tol": 1e-5, "inner_tol": 1e-6, "a_scalar_form": _stiffness, **_REC},
    "aggcomp_k8": {"tol": 1e-5, "precondition": "agg_comp", "inner_iters": 8, **_REC},
    "minres": {"tol": 1e-5, "inner_tol": 1e-6, "method": "minres"},
}
STOKES_INNER_MAXITER = 400
#: the breakdown's float64 truth
STOKES_TRUTH = {"tol": 1e-9, "inner_tol": 1e-11, "f_solve_tol": 1e-10, "recovery_tol": 1e-10}


def stokes_solver_of(Vu, Vp, config_name: str):
    """``compiled_stokes_solver`` of a named configuration (``"truth"`` or
    a key of ``STOKES_CONFIGS``) on the problem's bases."""
    from .ops.compiled import compiled_stokes_solver

    if config_name == "truth":
        kw = STOKES_TRUTH
    else:
        kw = {**STOKES_CONFIGS[config_name], "inner_maxiter": STOKES_INNER_MAXITER}
    return compiled_stokes_solver(Vu, Vp, stokes_viscous, stokes_div, **kw)


def _main_stokes(n: int, device) -> dict:
    """``stokes N``: the float64 truth, then every configuration in
    float32: counts, walls and the relative L2 errors against the truth."""
    Vu64, Vp64, f64 = stokes_problem(n, device=device, dtype=torch.float64)
    t0 = _now(device)
    u_t, p_t, info_t = stokes_solver_of(Vu64, Vp64, "truth")(f64)
    truth_s = _now(device) - t0
    Vu, Vp, f = stokes_problem(n, device=device, dtype=torch.float32)
    cases = {"truth": {"outer": info_t.outer_iterations, "inner_total": info_t.inner_total,
                       "converged": bool(info_t.converged), "wall_s": truth_s}}
    for name in STOKES_CONFIGS:
        solve = stokes_solver_of(Vu, Vp, name)
        u, p, info = solve(f)
        walls = _walls(lambda: solve(f), device)
        cases[name] = {
            "outer": info.outer_iterations, "inner_total": info.inner_total,
            "recovery": info.inner_info.iterations, "converged": bool(info.converged),
            "du_rel_l2": float((u.double() - u_t).norm() / u_t.norm()),
            "dp_rel_l2": float((p.double() - p_t).norm() / p_t.norm()),
            "walls_s": walls, "median_wall_s": float(np.median(walls)),
        }
    return {"n": n, "velocity_dofs": Vu.n_dofs, "pressure_dofs": Vp.n_dofs, **cases}


def _coarse_of(basis):
    """(g, na, m) of the basis's cached rigid-body-mode coarse space."""
    (ast,) = basis._affine_two_level_structures.values()
    return ast.g, ast.na, ast.m


def _card_line() -> str:
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _walls(solve, device, repeats: int = 3) -> list:
    walls = []
    for _ in range(repeats):
        t0 = _now(device)
        solve()
        walls.append(_now(device) - t0)
    return walls


def _main_refined(h: float, device) -> dict:
    """``refined H``: the network at ``h`` with 0 and 2 passes, each against
    the float64 ``compiled_bsr_solver`` at tol 1e-12 on the same basis."""
    from .utils import build_benchmark_network

    mesh = build_benchmark_network(h, device=device, dtype=torch.float64)
    cases = {}
    u_ref = None
    for refine in (0, 2):
        r = refined_dfn(mesh, refine=refine)
        if u_ref is None:
            u_ref, _ = r.basis.compiled_solver(_stiffness, _unit_load, tol=1e-12)()
        walls = _walls(r.solve, device)
        cases[f"refine{refine}"] = {
            "inner_iterations": list(r.info.inner_iterations),
            "residuals": r.info.residuals.tolist(), "converged": bool(r.info.converged),
            "rel_err_vs_f64": float((r.u - u_ref).abs().max() / u_ref.abs().max()),
            "walls_s": walls, "median_wall_s": float(np.median(walls)), "host_s": r.seconds,
        }
    return {"h": h, "dofs": r.basis.n_dofs, **cases}


def _main_eigsh(n: int, device) -> dict:
    """``eigsh N``: the square at ``n``, float32, both methods."""
    cases = {}
    for method in ("lobpcg", "subspace"):
        r = eigsh_square(n, method=method, device=device, dtype=torch.float32)
        rounds, change, conv = r.info
        walls = _walls(r.solve, device)
        cases[method] = {
            "rounds": rounds, "eig_change": float(change), "converged": bool(conv),
            "vals": r.vals.tolist(), "finite": bool(torch.isfinite(r.vecs).all()),
            "walls_s": walls, "median_wall_s": float(np.median(walls)), "host_s": r.seconds,
        }
    return {"n": n, "dofs": r.basis.n_dofs, **cases}


def _sharded_rank(h: float, rank: int, world: int, store: str) -> dict:
    """One NCCL rank of ``sharded H``: ``sharded_bsr_solver`` on the network
    at ``h`` (float32, tol 1e-6) on card ``rank``, K2's launches in its
    first solve, the median of 5 timed solves, its distance from
    ``compiled_bsr_solver`` on the same card, ``solve_pcg_sharded_bsr``'s
    count and distance, whether every rank holds the same ``u``, and the
    load vector assembled on ``shard_basis_cells`` against the whole
    basis's."""
    import torch.distributed as dist

    from .ops import cuda_build
    from .ops.compiled import compiled_bsr_solver
    from .parallel import make_device_mesh, shard_basis_cells, sharded_bsr_solver
    from .parallel import solve_pcg_sharded_bsr
    from .parallel.sharding import mesh_device
    from .utils import StepTimer, build_benchmark_network

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        mesh = make_device_mesh(world)
        device = mesh_device(mesh)
        V = benchmark_basis(build_benchmark_network(h, device=device, dtype=torch.float32))
        t0 = time.perf_counter()
        solve = sharded_bsr_solver(V, _stiffness, _unit_load, device_mesh=mesh, tol=1e-6)
        torch.cuda.synchronize()
        tables_s = time.perf_counter() - t0
        cuda_build.reset_launch_counts()
        u, (it, res, conv) = solve()
        torch.cuda.synchronize()
        k2 = cuda_build.launch_counts["bsr_spmv"]
        median = StepTimer().time_fn(solve, warmup=1, reps=5)["median_s"]
        u1, info1 = compiled_bsr_solver(V, _stiffness, _unit_load, tol=1e-6)()
        local = V.integrate_bilinear_form_local(_stiffness)
        b = V.integrate_linear_form(_unit_load)
        u2, info2 = solve_pcg_sharded_bsr(V, local, b, mesh, tol=1e-6, return_info=True)
        gathered = [torch.empty_like(u) for _ in range(world)]
        dist.all_gather(gathered, u)
        b_sh = shard_basis_cells(V, mesh).integrate_linear_form(_unit_load)
        return {
            "rank": rank, "device": str(device), "dofs": V.n_dofs, "iterations": it,
            "residual": float(res), "converged": bool(conv),
            "k2_launches": k2, "median_wall_s": median, "tables_s": tables_s,
            "compiled_iterations": info1.iterations,
            "vs_compiled": float((u - u1).norm() / u1.norm()),
            "legacy_iterations": info2.iterations,
            "legacy_vs_compiled": float((u2 - u1).norm() / u1.norm()),
            "ranks_equal": all(torch.equal(g, u) for g in gathered),
            "sharded_load_vs_full": float((b_sh - b).norm() / b.norm()),
        }
    finally:
        dist.destroy_process_group()


def _main_sharded(h: float) -> dict:
    """``sharded H``: one NCCL rank per visible card (a process each, a
    FileStore in a temporary directory, no network), each running
    ``_sharded_rank``; the kernels are built once, before the ranks
    start."""
    import json
    import os
    import shutil
    import subprocess
    import sys
    import tempfile

    from .ops import cuda_build

    world = torch.cuda.device_count()
    cuda_build.build_all()
    tmp = tempfile.mkdtemp(prefix="sharded_")
    store = os.path.join(tmp, "store")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "pytorch_fem_solver_tpu_torch.bench", "sharded-rank",
             str(h), str(rank), str(world), store],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=dict(os.environ, LOCAL_RANK=str(rank)),
        )
        for rank in range(world)
    ]
    ranks = []
    try:
        for rank, p in enumerate(procs):
            text = p.communicate(timeout=600)[0]
            if p.returncode != 0:
                raise RuntimeError(f"rank {rank} exited {p.returncode}:\n{text[-3000:]}")
            ranks.append(json.loads(text.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return {"h": h, "world": world, "ranks": ranks}


def main(argv=None) -> int:
    """``tet_poisson N`` (P1), ``elasticity_3d N``, ``refined H``,
    ``eigsh N``, ``stokes N``, ``precond NAME H [bf16]`` or ``sharded H``
    (one NCCL rank per visible card) on the card (float32; the refined
    solve's basis and the Stokes truth float64): one JSON line."""
    import json
    import sys

    args = list(sys.argv[1:] if argv is None else argv)
    if args[:1] == ["sharded-rank"] and len(args) == 5:
        out = _sharded_rank(float(args[1]), int(args[2]), int(args[3]), args[4])
        print(json.dumps(out), flush=True)
        return 0
    workloads = {"tet_poisson": (tet_poisson, _sine_load_3d),
                 "elasticity_3d": (elasticity_3d, _bubble_load)}
    precond_args = (
        args[:1] == ["precond"] and len(args) in (3, 4) and args[1] in PRECONDITIONERS
        and args[3:] in ([], ["bf16"])
    )
    if not precond_args and (
        len(args) != 2 or args[0] not in (*workloads, "refined", "eigsh", "stokes", "sharded")
    ):
        print("usage: python3 -m pytorch_fem_solver_tpu_torch.bench "
              "{tet_poisson|elasticity_3d|eigsh|stokes} N | {refined|sharded} H | "
              f"precond {{{'|'.join(PRECONDITIONERS)}}} H [bf16]", file=sys.stderr)
        return 2
    device = config.resolve_device(None)
    card = _card_line()
    if precond_args:
        out = {"metric": "precond", **_main_precond(args[1], float(args[2]), args[3:] == ["bf16"],
                                                    device)}
    elif args[0] == "refined":
        out = {"metric": "refined_dfn", **_main_refined(float(args[1]), device)}
    elif args[0] == "eigsh":
        out = {"metric": "eigsh_square", **_main_eigsh(int(args[1]), device)}
    elif args[0] == "stokes":
        out = {"metric": "stokes", **_main_stokes(int(args[1]), device)}
    elif args[0] == "sharded":
        out = {"metric": "sharded_bsr", **_main_sharded(float(args[1]))}
    else:
        out = _main_solve(args[0], *workloads[args[0]], int(args[1]), device)
    print(json.dumps({**out, "card": card}), flush=True)
    return 0


def _main_precond(name: str, h: float, bf16: bool, device) -> dict:
    """``precond NAME H [bf16]``: ``make_bsr_solve(precond=NAME)`` on the
    network at ``h``, float32 (bf16 preconditioner operands with ``bf16``):
    the first solve, three timed ones and K2's launches by key in the
    first."""
    from .ops import cuda_build
    from .utils import build_benchmark_network

    t0 = _now(device)
    mesh = build_benchmark_network(h, device=device, dtype=torch.float32)
    basis = benchmark_basis(mesh)
    t1 = _now(device)
    solve = make_bsr_solve(basis, precond=name, operand_dtype=torch.bfloat16 if bf16 else None)
    t2 = _now(device)
    cuda_build.reset_launch_counts()
    x, iterations, rel = solve()
    t3 = _now(device)
    k2 = {k: cuda_build.launch_counts[k] for k in ("bsr_spmv", "bsr_spmv_bf16")}
    walls = _walls(solve, device)
    return {
        "precond": name, "operands": "bf16" if bf16 else "f32", "h": h,
        "dofs": basis.n_dofs, "iterations": iterations, "rel_residual": float(rel),
        "finite": bool(torch.isfinite(x).all()), "k2_launches": k2,
        "first_wall_s": t3 - t2, "walls_s": walls, "median_wall_s": float(np.median(walls)),
        "host_s": {"mesh_and_basis": t1 - t0, "tables": t2 - t1},
    }


def _main_solve(name, make, load, n, device) -> dict:
    torch.cuda.reset_peak_memory_stats()
    r = make(n, device=device, dtype=torch.float32)
    first_peak = torch.cuda.max_memory_allocated()
    walls = []
    for _ in range(3):
        t0 = _now(device)
        u, info = r.solve()
        walls.append(_now(device) - t0)
    b = r.basis.reduce(r.basis.integrate_linear_form(load))
    extra = {}
    if name == "elasticity_3d":
        g, na, m = _coarse_of(r.basis)
        extra = {"inner_dofs": int(r.basis._basis_parameters["inner_dofs"].numel()),
                 "g": g, "na": na, "m": m, "coarse": na * m,
                 "l2_error": l2_error(r.basis, u, bubble_exact)}
    return {
        "metric": name, "n": n, "cells": int(r.basis.v_grad.shape[0]),
        "dofs": r.basis.n_dofs, "iterations": info.iterations,
        "rel_residual": float(info.residual_norm / b.norm()),
        "finite": bool(torch.isfinite(u).all()), "walls_s": walls,
        "median_wall_s": float(np.median(walls)), "peak_gib_first_solve": first_peak / 2**30,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "host_s": r.seconds,
        **extra,
    }


if __name__ == "__main__":
    raise SystemExit(main())
