"""Assemble+solve pipeline on the BSR operator.

Counterpart of ``compiled_bsr_solver`` in
``pytorch_fem_solver_tpu/ops/compiled.py``, scalar ``"auto"``/``"jacobi"``
branches. All host-side structure building happens once at construction;
the returned ``solve`` runs local assembly, the BSR value scatter, the
preconditioner setup and PCG (with the SpMV kernel) on the basis's device.
PyTorch runs eagerly, so there is nothing to compile: the name is kept so a
reader finds the counterpart.

Not ported yet (ROADMAP.md): the chunked assembly branch (auto above 2M
cells), the vector/rigid-body-mode branch, reduced-precision preconditioner
operands and reduced-precision SpMV values.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .bsr import (
    _scatter_drop,
    bsr_diagonal,
    bsr_expand,
    bsr_matvec,
    bsr_reduce,
    bsr_values_from_local,
    bsr_values_from_local_symmetric,
    default_max_b,
    get_bsr_structure,
    inverse_inner_perm,
)
from .precondition import (
    agg_block_two_level_from_values,
    build_agg_block_table,
    default_aggregate_size,
)
from .solvers import pcg

__all__ = ["bsr_pcg", "compiled_bsr_solver"]


def bsr_pcg(
    structure,
    precondition: str = "auto",
    tol: float = 1e-10,
    maxiter: Optional[int] = None,
):
    """Build ``run(values, b_pad) -> (x_pad, PCGInfo)`` for one structure.

    ``"auto"`` (the aggregate-block two-level preconditioner) builds its
    aggregate table here, once; each ``run`` sets the preconditioner up from
    the assembled ``values`` and solves the padded reduced system by PCG on
    the SpMV kernel. ``"jacobi"`` preconditions with the BSR diagonal.
    """
    if precondition not in ("auto", "jacobi"):
        raise ValueError(
            f"unknown precondition: {precondition!r} (expected 'auto' or "
            "'jacobi')"
        )
    st = structure
    g = gs = agg_table = None
    if precondition == "auto":
        g = default_aggregate_size(st)
        gs = min(g, 128)
        agg_table = torch.as_tensor(
            build_agg_block_table(st, gs), device=st.bcols.device
        )

    def run(values, b_pad):
        diag = bsr_diagonal(st, values)
        precond = None
        if precondition == "auto":
            precond = agg_block_two_level_from_values(
                st, values, diag, g=g, gs=gs, table=agg_table
            )
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
    """Cell-axis slice of a basis, handed to the user's bilinear form by the
    symmetric-form probe. Exposes exactly the array surface typical forms
    read (``v``, ``v_grad``, ``integration_points``, the element)."""

    def __init__(self, v, v_grad, integration_points, dx, element):
        self.v = v
        self.v_grad = v_grad
        self.integration_points = integration_points
        self._dx = dx
        self._element = element

    def __getattr__(self, name):
        raise AttributeError(
            f"the form probe exposes only v / v_grad / integration_points "
            f"(requested: {name!r})"
        )


def compiled_bsr_solver(
    basis,
    bilinear_form: Callable,
    linear_form: Optional[Callable] = None,
    tol: float = 1e-10,
    maxiter: Optional[int] = None,
    precondition: str = "auto",
    symmetric_form: bool = True,
    max_b: Optional[int] = None,
):
    """Build ``solve() -> (u, info)`` for a fixed basis + forms.

    Args:
      basis: a scalar cell basis with interior DOFs; structures are built
        for its mesh once, on the host, and live on the basis's device.
      bilinear_form: closure ``basis -> (T, q, n_loc, n_loc)`` integrand.
      linear_form: closure for the right-hand side; if None the returned
        callable takes an assembled global vector ``b`` instead.
      precondition: ``"auto"`` (aggregate-block two-level) or ``"jacobi"``.
      symmetric_form: enable the canonical-pair scatter (6/9 entries for P1
        triangles); only valid for symmetric forms.
      max_b: tier-1 block cap; None picks ``default_max_b`` (8 in 2D).

    A symmetric form on more than 2M cells, where the JAX package switches
    to chunked assembly, raises: that branch is not ported yet.

    Returns:
      ``solve(b=None) -> (u, PCGInfo)``.
    """
    if int(getattr(basis, "n_components", 1)) >= 2:
        raise NotImplementedError(
            "the vector (rigid-body-mode) branch of compiled_bsr_solver is "
            "not ported yet; see ROADMAP.md"
        )

    n_cells = int(basis.v_grad.shape[0])
    if n_cells > 2_000_000 and symmetric_form:
        raise NotImplementedError(
            "chunked assembly (the JAX default above 2M cells) is not ported "
            "yet; see ROADMAP.md"
        )

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
    solve_padded = bsr_pcg(st, precondition, tol=tol, maxiter=maxiter)

    # direct-to-padded rhs scatter: the load-vector targets pre-mapped
    # through the inverse inner permutation land straight in the padded
    # reduced vector (Dirichlet rows -> n_pad, dropped into a sink)
    rhs_pad_idx = None
    if linear_form is not None:
        inv = inverse_inner_perm(st, int(basis.n_dofs))
        lf_idx = basis._as_host_index(basis._basis_parameters["linear_form_idx"][0])
        rhs_pad_idx = torch.as_tensor(inv[lf_idx], device=basis.device)

    n_dofs = basis.n_dofs

    def _run(b):
        local = basis.integrate_bilinear_form_local(bilinear_form)
        if symmetric_form:
            values = bsr_values_from_local_symmetric(st, local)
        else:
            values = bsr_values_from_local(st, local)
        if rhs_pad_idx is not None:
            lv = basis.reshape_for_assembly(
                basis.integrate_linear_form_local(linear_form), "linear"
            )[:, 0]
            b_pad = _scatter_drop(rhs_pad_idx, lv, st.n_pad)
        else:
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
