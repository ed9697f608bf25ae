"""Mixed-precision iterative refinement: float64-grade solves from a
float32 inner solver.

Counterpart of ``RefineInfo`` and ``compiled_refined_solver`` in
``pytorch_fem_solver_tpu/ops/refine.py``. Classic two-precision refinement
(Wilkinson; Carson & Higham):

    x_0      = solve32(b)                      (float32 two-level PCG)
    repeat:  r_k = b - A x_k   in float64      (one float64 SpMV + axpy)
             d_k = solve32(r_k)                (the same float32 PCG)
             x_{k+1} = x_k + d_k  in float64

The float64 operator values (canonical-pair scatter) and right-hand side
are assembled once, at construction, on the basis's device, together with
the preconditioner's host tables. Each solve casts the values to a
contiguous float32 copy, builds the diagonal and the preconditioner from
it, and runs the float32 PCG on the SpMV kernel K2 in float32; the true
residual ``b - A x`` runs K2 in float64. The JAX program computes that
residual twice on the same ``x`` (the stage's residual, then the next
pass's right-hand side); K2 is bitwise repeatable, so one float64 launch
per stage gives the same bits: 1 + ``refine`` float64 launches per solve.
The spans are ``compiled_bsr_solver``'s: ``fem.solve`` and
``fem.precond_setup`` (the float32 copy, the diagonal, the M) per solve,
``fem.tables.solver`` at construction.

On a vector basis the rigid-body-mode M is built from the float32 values
with a float32 copy of W made per solve (``affine_two_level_from_values``
casts it), so the float64 W cached on the basis is never replaced.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..utils.profiling import span
from .bsr import (
    bsr_diagonal,
    bsr_expand,
    bsr_matvec,
    bsr_reduce,
    bsr_values_from_local_symmetric,
    default_max_b,
    get_bsr_structure,
)
from .compiled import preconditioner_setup
from .solvers import pcg

__all__ = ["RefineInfo", "compiled_refined_solver"]


class RefineInfo(NamedTuple):
    """Solve evidence: the inner PCG iteration count of each stage (the
    initial solve, then one per refinement pass) and the true float64
    relative residual ``||b - A x|| / ||b||`` after each stage, recomputed
    from the float64 operator, never from the float32 recurrence.

    Types, the same on the CPU and on the card: ``inner_iterations`` a
    tuple of Python ints, ``residuals`` a float64 tensor (1 + refine,) on
    the basis's device, ``converged`` a 0-dim bool tensor there."""

    inner_iterations: tuple
    residuals: torch.Tensor
    converged: torch.Tensor


def compiled_refined_solver(
    basis,
    bilinear_form: Callable,
    linear_form: Optional[Callable] = None,
    *,
    refine: int = 2,
    tol32: float = 1e-6,
    maxiter: Optional[int] = None,
    precondition: str = "auto",
    max_b: Optional[int] = None,
):
    """Build ``solve(b=None) -> (u, RefineInfo)`` whose solution matches
    the float64 solve of the same discrete system to near float64.

    The basis must be float64 (its assembly is the refinement target) and
    the bilinear form symmetric (canonical-pair scatter). The operator and,
    when ``linear_form`` is given, the right-hand side are assembled once
    here: a change of coefficients needs a rebuild.

    Args:
      refine: number of refinement passes (2 reaches ~1e-12 relative on
        the benchmark network in the JAX package's float64 tests).
      tol32: the float32 inner PCG tolerance. Much below ~1e-7 is wasted
        (the float32 floor); much above ~1e-3 needs more passes.
      precondition / max_b: as in ``compiled_bsr_solver`` (``"auto"``: the
        aggregate-block M, or the rigid-body-mode one on a vector basis).
    """
    if precondition not in ("auto", "jacobi"):
        raise ValueError(
            f"unknown precondition: {precondition!r} (expected 'auto' or "
            "'jacobi')"
        )
    if basis.dtype != torch.float64:
        raise ValueError(
            "compiled_refined_solver needs a float64 basis (its float64 "
            f"assembly is the refinement target; got {basis.dtype}). Build "
            "the mesh and basis with dtype=torch.float64."
        )
    if refine < 0:
        raise ValueError(f"refine must be >= 0, got {refine}")

    with span("fem.tables.solver", always=True):
        if max_b is None:
            max_b = default_max_b(basis)
        st = get_bsr_structure(basis, max_b=max_b, want_entry_slot=False)
        values64 = bsr_values_from_local_symmetric(
            st, basis.integrate_bilinear_form_local(bilinear_form)
        )
        b64 = basis.integrate_linear_form(linear_form) if linear_form is not None else None
        setup = preconditioner_setup(st, precondition, basis)
        u0 = basis.solution_tensor()
        n_dofs = basis.n_dofs
        floor = max(tol32**2, 1e-14)

        def _run(b):
            with span("fem.solve"):
                with span("fem.precond_setup", b.device):
                    values32 = tuple(v.to(torch.float32).contiguous() for v in values64)
                    diag32 = bsr_diagonal(st, values32)
                    precond = None if setup is None else setup(values32, diag32)

                def solve32(rhs32):
                    return pcg(
                        lambda v: bsr_matvec(st, values32, v),
                        rhs32,
                        precond_diag=diag32,
                        precond=precond,
                        tol=tol32,
                        maxiter=maxiter,
                    )

                b_pad = bsr_reduce(st, b)
                safe_b = torch.clamp(torch.linalg.norm(b_pad), min=torch.finfo(torch.float64).tiny)

                x32, info = solve32(b_pad.to(torch.float32))
                x64 = x32.to(torch.float64)
                r64 = b_pad - bsr_matvec(st, values64, x64)
                iters = [info.iterations]
                resids = [torch.linalg.norm(r64) / safe_b]
                for _ in range(refine):
                    d32, info = solve32(r64.to(torch.float32))
                    x64 = x64 + d32.to(torch.float64)
                    r64 = b_pad - bsr_matvec(st, values64, x64)
                    iters.append(info.iterations)
                    resids.append(torch.linalg.norm(r64) / safe_b)

                u = u0 + bsr_expand(st, x64, n_dofs)
                residuals = torch.stack(resids)
                # "reached float64 grade": the last stage at or below the inner
                # tolerance squared (floored at 1e-14), the JAX threshold as written
                return u, RefineInfo(
                    inner_iterations=tuple(iters),
                    residuals=residuals,
                    converged=residuals[-1] <= floor,
                )

        if linear_form is not None:

            def solve(b=None):
                return _run(b64)

        else:

            def solve(b):
                if b.dtype != torch.float64:
                    raise ValueError(
                        f"refined solve needs an f64 right-hand side, got {b.dtype}"
                    )
                return _run(b)

        return solve
