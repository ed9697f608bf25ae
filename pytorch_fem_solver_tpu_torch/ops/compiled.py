"""Assemble+solve pipeline on the BSR operator.

Counterpart of ``compiled_bsr_solver`` in
``pytorch_fem_solver_tpu/ops/compiled.py``, scalar ``"auto"``/``"jacobi"``
branches. All host-side structure building happens once at construction;
the returned ``solve`` runs local assembly, the BSR value scatter, the
preconditioner setup and PCG (with the SpMV kernel) on the basis's device.
PyTorch runs eagerly, so there is nothing to compile: the name is kept so a
reader finds the counterpart.

The chunked assembly (``chunk_cells``; on by default for a symmetric form
above 2M cells) streams the canonical-pair scatter over cell chunks, so
the full-size (T, q, n_loc, n_loc) temporary of the form never exists.
The JAX package pads the basis arrays to a whole number of chunks and
stacks copies of them for its ``lax.scan``; PyTorch loops in Python, so a
chunk here is a view of the basis's own ``v_grad``, ``integration_points``
and ``_dx`` (the last chunk ragged) and of the structure's
``entry_slot_sym``, and no array is copied. The per-chunk slot views are
cached on the basis as ``_chunk_tables[(C, max_b)]``, where JAX caches its
padded tables.

A vector basis (``n_components >= 2``) takes the rigid-body-mode coarse
space under ``"auto"``: its structure (W, the aggregate-pair bins) is built
once per basis, its numeric setup runs per solve.

``compiled_newton_solver`` is the counterpart of the JAX package's one-jit
Newton: the ``lax.while_loop`` becomes a host loop that reads the trial
residual norm once per Newton step (and once per halving of a damped
step), around the jvp Jacobian, the BSR scatter, the preconditioner setup
and BiCGStab on the SpMV kernel.

Not ported yet (ROADMAP.md, B6): reduced-precision preconditioner operands
and reduced-precision SpMV values.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from .bsr import (
    _scatter_drop,
    bsr_diagonal,
    bsr_expand,
    bsr_matvec,
    bsr_reduce,
    bsr_values_from_chunks_symmetric,
    bsr_values_from_local,
    default_max_b,
    get_bsr_structure,
    inverse_inner_perm,
)
from .precondition import (
    agg_block_two_level_from_values,
    auto_preconditioner_setup,
    build_agg_block_table,
    default_aggregate_size,
)
from .solvers import bicgstab, pcg

__all__ = [
    "aggblock_setup",
    "bsr_pcg",
    "compiled_bsr_solver",
    "compiled_newton_solver",
    "preconditioner_setup",
]


def aggblock_setup(structure):
    """Build the aggregate table once; return ``setup(values, diag=None) ->
    AggBlockTwoLevel``, the aggblock preconditioner of assembled ``values``
    (g from ``default_aggregate_size``, gs = min(g, 128))."""
    g = default_aggregate_size(structure)
    gs = min(g, 128)
    table = torch.as_tensor(
        build_agg_block_table(structure, gs), device=structure.bcols.device
    )

    def setup(values, diag=None):
        if diag is None:
            diag = bsr_diagonal(structure, values)
        return agg_block_two_level_from_values(
            structure, values, diag, g=g, gs=gs, table=table
        )

    return setup


def preconditioner_setup(structure, precondition: str = "auto", basis=None):
    """The per-solve preconditioner setup of ``precondition``: None for
    ``"jacobi"``; for ``"auto"`` the setup of ``auto_preconditioner`` on
    ``basis`` (the rigid-body-mode M of a vector basis, else the
    aggregate-block one), or the aggregate-block one without a basis.
    Host tables are built here, once."""
    if precondition not in ("auto", "jacobi"):
        raise ValueError(
            f"unknown precondition: {precondition!r} (expected 'auto' or "
            "'jacobi')"
        )
    if precondition == "jacobi":
        return None
    if basis is None:
        return aggblock_setup(structure)
    return auto_preconditioner_setup(basis, structure)


def bsr_pcg(
    structure,
    precondition: str = "auto",
    tol: float = 1e-10,
    maxiter: Optional[int] = None,
    basis=None,
):
    """Build ``run(values, b_pad) -> (x_pad, PCGInfo)`` for one structure.

    ``"auto"`` builds the preconditioner's host tables here, once (the
    aggregate-block two-level M, or on a vector ``basis`` the rigid-body-
    mode one); each ``run`` sets the preconditioner up from the assembled
    ``values`` and solves the padded reduced system by PCG on the SpMV
    kernel. ``"jacobi"`` preconditions with the BSR diagonal.
    """
    st = structure
    setup = preconditioner_setup(st, precondition, basis)

    def run(values, b_pad):
        diag = bsr_diagonal(st, values)
        precond = None if setup is None else setup(values, diag)
        return pcg(
            lambda v: bsr_matvec(st, values, v),
            b_pad,
            precond_diag=diag,
            precond=precond,
            tol=tol,
            maxiter=maxiter,
        )

    return run


class _CellChunkView:
    """Cell-axis slice of a basis, handed to the user's bilinear form
    during chunked assembly and by the symmetric-form probe. Exposes
    exactly the array surface typical forms read (``v``, ``v_grad``,
    ``integration_points``, the element); anything else raises with a
    pointer to the unchunked path."""

    def __init__(self, v, v_grad, integration_points, dx, element):
        self.v = v
        self.v_grad = v_grad
        self.integration_points = integration_points
        self._dx = dx
        self._element = element

    def __getattr__(self, name):
        raise AttributeError(
            f"chunked assembly exposes only v / v_grad / integration_points "
            f"to the bilinear form (requested: {name!r}); pass "
            "chunk_cells=0 to compiled_bsr_solver to disable chunking"
        )


def _chunk_table(basis, structure, chunk_cells: int, max_b: int):
    """``(start, stop, slots)`` per chunk of ``chunk_cells`` cells: the
    cell range and the view of ``entry_slot_sym`` that its canonical pairs
    scatter to. Cached on the basis per ``(chunk_cells, max_b)``."""
    cache = getattr(basis, "_chunk_tables", None)
    if cache is None:
        cache = basis._chunk_tables = {}
    key = (chunk_cells, max_b)
    if key not in cache:
        n_cells = int(basis.v_grad.shape[0])
        pairs = structure.entry_slot_sym.shape[0] // n_cells
        cache[key] = tuple(
            (c0, min(c0 + chunk_cells, n_cells),
             structure.entry_slot_sym[c0 * pairs: min(c0 + chunk_cells, n_cells) * pairs])
            for c0 in range(0, n_cells, chunk_cells)
        )
    return cache[key]


def _local_chunks(basis, structure, bilinear_form, chunks):
    """``(slots, local_matrices)`` for ``bsr_values_from_chunks_symmetric``:
    with ``chunks`` None, the whole mesh at once with the form on the basis
    itself; else chunk by chunk, the form on a ``_CellChunkView`` of the
    chunk's cells."""
    if chunks is None:
        yield structure.entry_slot_sym, basis.integrate_bilinear_form_local(bilinear_form)
        return
    for c0, c1, slots in chunks:
        view = _CellChunkView(
            basis.v, basis.v_grad[c0:c1], basis.integration_points[c0:c1],
            basis._dx[c0:c1], basis._element,
        )
        yield slots, (basis._evaluate_form(bilinear_form, view) * basis._dx[c0:c1]).sum(-3)


def compiled_bsr_solver(
    basis,
    bilinear_form: Callable,
    linear_form: Optional[Callable] = None,
    tol: float = 1e-10,
    maxiter: Optional[int] = None,
    precondition: str = "auto",
    symmetric_form: bool = True,
    max_b: Optional[int] = None,
    chunk_cells: Optional[int] = None,
):
    """Build ``solve() -> (u, info)`` for a fixed basis + forms.

    Args:
      basis: a cell basis (2D tri / 3D tet / DFN / vector) with interior
        DOFs; structures are built for its mesh once, on the host, and live
        on the basis's device.
      bilinear_form: closure ``basis -> (T, q, n_loc, n_loc)`` integrand.
      linear_form: closure for the right-hand side; if None the returned
        callable takes an assembled global vector ``b`` instead.
      precondition: ``"auto"`` (aggregate-block two-level; the
        rigid-body-mode coarse space for vector bases) or ``"jacobi"``.
      symmetric_form: enable the canonical-pair scatter (6/9 entries for P1
        triangles); only valid for symmetric forms.
      max_b: tier-1 block cap; None picks ``default_max_b`` (8 in 2D, 24
        for tets).
      chunk_cells: stream the symmetric scatter over chunks of this many
        cells (see the module docstring). None picks 2^18 for a symmetric
        form on more than 2M cells and 0 otherwise; 0 disables chunking.
        Chunked forms may only read ``v`` / ``v_grad`` /
        ``integration_points`` from the basis they are passed.

    Returns:
      ``solve(b=None) -> (u, PCGInfo)``.
    """
    if precondition not in ("auto", "jacobi"):
        raise ValueError(
            f"unknown precondition: {precondition!r} (expected 'auto' or "
            "'jacobi'); use solve_iterative for the full option surface"
        )
    n_cells = int(basis.v_grad.shape[0])
    if chunk_cells and not symmetric_form:
        raise ValueError(
            "chunk_cells requires symmetric_form=True (the streaming "
            "scatter is canonical-pair only); at >2M cells the one-shot "
            "non-symmetric local temp is known to exceed HBM "
            "(docs/performance.md)"
        )
    if chunk_cells is None:
        chunk_cells = (1 << 18) if (n_cells > 2_000_000 and symmetric_form) else 0

    # construction-time spot check: symmetric_form=True with a
    # non-symmetric form would silently assemble a symmetrized (wrong)
    # operator. Evaluate the form eagerly on a small cell slice and verify.
    sl = slice(0, min(64, n_cells))
    try:
        probe = (
            basis._evaluate_form(
                bilinear_form,
                _CellChunkView(
                    basis.v,
                    basis.v_grad[sl],
                    basis.integration_points[sl],
                    basis._dx[sl],
                    basis._element,
                ),
            )
            * basis._dx[sl]
        ).sum(-3)
    except AttributeError:
        probe = None  # form reads beyond the slice surface; cannot probe
    if probe is not None and symmetric_form:
        asym = float((probe - probe.mT).abs().max())
        scale = float(probe.abs().max())
        if asym > 1e-4 * max(scale, 1e-30):
            raise ValueError(
                "symmetric_form=True but the bilinear form's local "
                f"matrices are not symmetric (max asymmetry {asym:.2e} "
                f"vs scale {scale:.2e}); pass symmetric_form=False"
            )

    if max_b is None:
        max_b = default_max_b(basis)
    st = get_bsr_structure(basis, max_b=max_b, want_entry_slot=not symmetric_form)
    chunks = _chunk_table(basis, st, int(chunk_cells), max_b) if chunk_cells else None
    solve_padded = bsr_pcg(st, precondition, tol=tol, maxiter=maxiter, basis=basis)

    # direct-to-padded rhs scatter (flat single-index linear layouts): the
    # load-vector targets pre-mapped through the inverse inner permutation
    # land straight in the padded reduced vector (Dirichlet rows -> n_pad,
    # dropped into a sink); any other layout assembles the load vector and
    # reduces it
    rhs_pad_idx = None
    lf_idx = basis._basis_parameters.get("linear_form_idx")
    if linear_form is not None and lf_idx is not None and len(lf_idx) == 1:
        inv = inverse_inner_perm(st, int(basis.n_dofs))
        rhs_pad_idx = torch.as_tensor(
            inv[basis._as_host_index(lf_idx[0])], device=basis.device
        )

    n_dofs = basis.n_dofs

    def _run(b):
        if symmetric_form:
            values = bsr_values_from_chunks_symmetric(
                st, _local_chunks(basis, st, bilinear_form, chunks)
            )
        else:
            values = bsr_values_from_local(
                st, basis.integrate_bilinear_form_local(bilinear_form)
            )
        if rhs_pad_idx is not None:
            lv = basis.reshape_for_assembly(
                basis.integrate_linear_form_local(linear_form), "linear"
            )[:, 0]
            b_pad = _scatter_drop(rhs_pad_idx, lv, st.n_pad)
        else:
            if linear_form is not None:
                b = basis.integrate_linear_form(linear_form)
            b_pad = bsr_reduce(st, b)
        x, info = solve_padded(values, b_pad)
        u = basis.solution_tensor() + bsr_expand(st, x, n_dofs)
        return u, info

    if linear_form is not None:

        def solve(b=None):
            return _run(None)

    else:

        def solve(b):
            return _run(b)

    return solve


def _bsr_setup(basis, max_b, precondition):
    """Shared construction of the compiled Newton solve: the full-entry-slot
    BSR structure (the Jacobians are not symmetric) and the per-step
    preconditioner setup of ``precondition`` (``preconditioner_setup``),
    its host tables built once."""
    if max_b is None:
        max_b = default_max_b(basis)
    st = get_bsr_structure(basis, max_b=max_b, want_entry_slot=True)
    return st, preconditioner_setup(st, precondition, basis)


def compiled_newton_solver(
    basis,
    residual_form: Callable,
    *,
    tol: float = 1e-10,
    max_newton: int = 25,
    solve_tol: float = 1e-8,
    solve_maxiter: Optional[int] = None,
    precondition: str = "jacobi",
    damping: bool = True,
    max_b: Optional[int] = None,
):
    """Newton's method for F(u)[v] = 0, the counterpart of the JAX
    package's one-jit ``compiled_newton_solver`` (same
    ``residual_form(basis, u, u_grad, *args)`` contract as
    ``AbstractBasis.solve_newton``).

    Each step assembles the residual, takes the consistent Jacobian's
    element matrices by ``torch.func.jvp`` against the ``n_loc`` one-hot
    local tangents, scatters them into the BSR layout, sets the
    preconditioner up from those values and solves the update by BiCGStab
    on the SpMV kernel. The JAX ``lax.while_loop`` is a host loop here.

    Args:
      precondition: ``"jacobi"`` (the default) or ``"auto"`` (the
        aggregate-block two-level M, or the rigid-body-mode one on a vector
        basis, built from each step's Jacobian values; the host tables
        once, here).
      damping: the JAX compiled rule, kept as written: halve the step (at
        most 12 times) while ``not (rn < res)``, so a NaN trial norm keeps
        damping; a step whose trial norm is still non-finite, or (with
        damping) not below the current norm after the halvings, is a
        stall: the iterate stays, the iteration count jumps to
        ``max_newton`` and the loop stops.

    Returns ``solve(u0=None, *args) -> (u, (iterations, residual_norm,
    converged))``: ``iterations`` a Python int, ``residual_norm`` a 0-dim
    tensor and ``converged`` a 0-dim bool tensor, on the CPU and on the
    card alike. ``u0`` seeds non-homogeneous Dirichlet values; ``args`` go
    to ``residual_form``.
    """
    st, setup = _bsr_setup(basis, max_b, precondition)
    n_dofs = basis.n_dofs
    dofs = basis._global_dofs4elements.long()

    def solve(u0=None, *args):
        if u0 is None:
            u0 = basis.solution_tensor()

        def residual_local(u_cells):
            return basis._residual_local(residual_form, u_cells, args)

        def res_norm(u):
            r = basis._assemble_linear_from_local(residual_local(u[..., 0][..., dofs]))
            return torch.linalg.norm(basis.reduce(r))

        u = u0
        res = res_norm(u)
        target = tol * torch.clamp(res, min=1.0)
        res_h, target_h = (float(v) for v in torch.stack([res, target]).cpu())
        k = 0
        while res_h > target_h and k < max_newton:
            u_cells = u[..., 0][..., dofs]
            r, j_local = basis._newton_terms(residual_local, u_cells)
            values = bsr_values_from_local(st, j_local)
            diag = bsr_diagonal(st, values)
            x, _ = bicgstab(
                lambda v: bsr_matvec(st, values, v),
                bsr_reduce(st, -r),
                precond_diag=diag,
                precond=None if setup is None else setup(values, diag),
                tol=solve_tol,
                maxiter=solve_maxiter,
            )
            delta = bsr_expand(st, x, n_dofs)
            step, halvings = 1.0, 0
            rn = res_norm(u + step * delta)
            rn_h = float(rn)
            # not (rn < res): a NaN trial norm keeps damping
            while damping and not rn_h < res_h and halvings < 12:
                step *= 0.5
                rn = res_norm(u + step * delta)
                rn_h = float(rn)
                halvings += 1
            bad = not math.isfinite(rn_h) or (damping and rn_h >= res_h)
            if bad:
                k = max_newton
            else:
                u = u + step * delta
                res, res_h = rn, rn_h
                k += 1
        return u, (k, res, res <= target)

    return solve
