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

``compiled_eigsh_solver`` is the counterpart of the one-jit generalized
eigensolve: both forms' BSR values, the preconditioner setup and LOBPCG or
subspace iteration (``ops.eigen``), whose host loops read the stopping test
once per round.

``compiled_stokes_solver`` is the counterpart of the one-jit Stokes solve:
the host tables (the velocity BSR structure, the coarse space, the mixed B
element matrices, the lumped pressure mass) once at construction; A's
values, the preconditioner and the nested Schur loop (``ops.saddle``) or
MINRES per solve, every A product on K2.

The reduced-precision knobs: ``operand_dtype`` stores the preconditioner's
dense apply operands reduced (``ops.precondition._mixed_matvec``);
``values_dtype`` casts the SpMV values after the diagonal and the
preconditioner are built from the full-precision ones, so every PCG
product runs K2's bf16-values instantiation on the card.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional

import numpy as np
import torch

from .bsr import (
    _scatter_drop,
    bsr_diagonal,
    bsr_expand,
    bsr_matvec,
    bsr_reduce,
    bsr_values_from_chunks_symmetric,
    bsr_values_from_local,
    bsr_values_from_local_symmetric,
    default_max_b,
    get_bsr_structure,
    inverse_inner_perm,
)
from .precondition import (
    affine_two_level_from_values,
    agg_block_two_level_from_values,
    auto_preconditioner_setup,
    block_two_level_from_values,
    build_agg_block_table,
    default_aggregate_size,
    get_affine_two_level_structure,
    get_three_level_structure,
    mult_three_level_from_values,
    mult_two_level_from_values,
    smoothed_two_level_matrix_free,
    three_level_from_values,
)
from .solvers import bicgstab, pcg

__all__ = [
    "aggblock_setup",
    "bsr_pcg",
    "compiled_bsr_solver",
    "compiled_eigsh_solver",
    "compiled_newton_solver",
    "compiled_stokes_solver",
    "preconditioner_setup",
]


def aggblock_setup(structure, g: Optional[int] = None, gs: Optional[int] = None,
                   operand_dtype=None):
    """Build the aggregate table once; return ``setup(values, diag=None) ->
    AggBlockTwoLevel``, the aggblock preconditioner of assembled ``values``
    (g from ``default_aggregate_size`` and gs = min(g, 128) unless given;
    ``operand_dtype`` stores its inverses reduced)."""
    g = default_aggregate_size(structure) if g is None else g
    gs = min(g, 128) if gs is None else gs
    table = torch.as_tensor(
        build_agg_block_table(structure, gs), device=structure.bcols.device
    )

    def setup(values, diag=None):
        if diag is None:
            diag = bsr_diagonal(structure, values)
        return agg_block_two_level_from_values(
            structure, values, diag, g=g, gs=gs, table=table, operand_dtype=operand_dtype
        )

    return setup


#: the names ``preconditioner_setup`` takes: ``compiled_bsr_solver``'s two
#: and the options of the repo-root ``bench.py`` (``BENCH_PRECOND``)
PRECONDITIONERS = (
    "auto", "jacobi", "aggblock", "two_level", "three_level", "mult", "mult3", "affine",
    "smoothed",
)


def preconditioner_setup(
    structure,
    precondition: str = "auto",
    basis=None,
    *,
    operand_dtype=None,
    g: Optional[int] = None,
    gs: Optional[int] = None,
    omega: float = 0.8,
):
    """The per-solve preconditioner setup of ``precondition``, as
    ``setup(values, diag) -> M`` (None for ``"jacobi"``). Host tables are
    built here, once (cached on ``basis`` where the JAX package caches
    them):

    * ``"auto"``: ``auto_preconditioner`` on ``basis`` (the rigid-body-mode
      M of a vector basis, else the aggregate-block one);
    * ``"aggblock"``: the aggregate-block two-level M (``g``, ``gs``);
    * ``"two_level"``: the 8x8 block-Jacobi two-level M (``g``);
    * ``"three_level"`` / ``"mult3"``: the additive three-level M and its
      multiplicative V(1,1) cycle (``omega="auto"``), tables on ``basis``;
    * ``"mult"``: the multiplicative two-level cycle (``g``,
      ``omega="auto"``);
    * ``"affine"``: the [1, x, y, z] coarse space on ``basis`` (``g``);
    * ``"smoothed"``: the matrix-free smoothed two-level M (``g``,
      ``omega``).

    ``operand_dtype`` stores the dense apply operands reduced (all but
    ``"smoothed"``, which has none to store, as in the JAX package).
    """
    if precondition not in PRECONDITIONERS:
        raise ValueError(
            f"unknown precondition: {precondition!r} (expected one of "
            f"{', '.join(map(repr, PRECONDITIONERS))})"
        )
    st, od = structure, operand_dtype
    if precondition == "jacobi":
        return None
    if precondition == "aggblock":
        return aggblock_setup(st, g, gs, od)
    if precondition == "two_level":
        return lambda values, diag: block_two_level_from_values(
            st, values, diag, g=g, operand_dtype=od
        )
    if precondition == "mult":
        return lambda values, diag: mult_two_level_from_values(
            st, values, diag, g=g, operand_dtype=od
        )
    if precondition == "smoothed":
        return lambda values, diag: smoothed_two_level_matrix_free(
            st, values, diag, g=g, omega=omega
        )
    if basis is None:
        raise ValueError(f"precondition {precondition!r} needs the basis")
    if precondition == "auto":
        return auto_preconditioner_setup(basis, st, od)
    if precondition == "affine":
        ast = get_affine_two_level_structure(basis, st, g=g)
        return lambda values, diag: affine_two_level_from_values(
            ast, st, values, diag, operand_dtype=od
        )
    tl = get_three_level_structure(basis, st)
    build = three_level_from_values if precondition == "three_level" else (
        mult_three_level_from_values)
    return lambda values, diag: build(tl, st, values, diag, operand_dtype=od)


def bsr_pcg(
    structure,
    precondition: str = "auto",
    tol: float = 1e-10,
    maxiter: Optional[int] = None,
    basis=None,
    *,
    values_dtype=None,
    **options,
):
    """Build ``run(values, b_pad) -> (x_pad, PCGInfo)`` for one structure.

    The preconditioner's host tables are built here, once
    (``preconditioner_setup`` with ``options``: ``operand_dtype``, ``g``,
    ``gs``, ``omega``); each ``run`` sets the preconditioner up from the
    assembled ``values`` and solves the padded reduced system by PCG on
    the SpMV kernel. ``"jacobi"`` preconditions with the BSR diagonal.
    With ``values_dtype`` the PCG products run on a copy of the values in
    that dtype, made after the diagonal and the preconditioner.
    """
    st = structure
    setup = preconditioner_setup(st, precondition, basis, **options)

    def run(values, b_pad):
        diag = bsr_diagonal(st, values)
        precond = None if setup is None else setup(values, diag)
        if values_dtype is not None:
            values = tuple(v.to(values_dtype) for v in values)
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
    operand_dtype=None,
    chunk_cells: Optional[int] = None,
    values_dtype=None,
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
      operand_dtype: storage dtype of the preconditioner's dense apply
        operands (e.g. ``torch.bfloat16``); None keeps the values'.
      values_dtype: storage dtype of the SpMV values (e.g.
        ``torch.bfloat16``): the diagonal and the preconditioner are built
        from the full-precision values first, then the values are cast, so
        the PCG solves the system of the rounded operator (about 1e-3 from
        the full-precision answer in bf16, as the JAX package measured).
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
    solve_padded = bsr_pcg(
        st, precondition, tol=tol, maxiter=maxiter, basis=basis,
        values_dtype=values_dtype, operand_dtype=operand_dtype,
    )

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
    """Shared construction of the compiled Newton and eigen solves: the
    full-entry-slot BSR structure (the Jacobians are not symmetric; the
    eigen forms are scattered entry by entry, as in the JAX package) and
    the per-solve preconditioner setup of ``precondition``
    (``preconditioner_setup``), its host tables built once."""
    if precondition not in ("auto", "jacobi"):
        raise ValueError(
            f"unknown precondition: {precondition!r} (expected 'auto' or 'jacobi')"
        )
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
    matmul_precision: Optional[str] = "highest",
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
      matmul_precision: see ``_mm_precision``; each step's assembly and
        BiCGStab run under it.

    Returns ``solve(u0=None, *args) -> (u, (iterations, residual_norm,
    converged))``: ``iterations`` a Python int, ``residual_norm`` a 0-dim
    tensor and ``converged`` a 0-dim bool tensor, on the CPU and on the
    card alike. ``u0`` seeds non-homogeneous Dirichlet values; ``args`` go
    to ``residual_form``.
    """
    _mm_precision(matmul_precision)  # an unknown name raises here, before any table
    st, setup = _bsr_setup(basis, max_b, precondition)
    n_dofs = basis.n_dofs
    dofs = basis._global_dofs4elements.long()

    def solve(u0=None, *args):
        if u0 is None:
            u0 = basis.solution_tensor()
        with _mm_precision(matmul_precision):
            return _run(u0, args)

    def _run(u0, args):
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


def _mm_precision(precision: Optional[str]):
    """The float32 matmul precision inside a Newton, eigen or Stokes
    solve. ``None`` and ``"highest"`` keep full float32 (TF32 stays off,
    the package's setting); ``"high"`` and ``"default"`` allow TF32 inside
    the call only, the card's nearest counterpart of the TPU's
    reduced-precision passes, which the JAX package measured to move
    float32 eigenvalues by 7.8% at 100k DOFs."""
    if precision is None or precision == "highest":
        return contextlib.nullcontext()
    if precision not in ("high", "default"):
        raise ValueError(
            f"unknown matmul_precision: {precision!r} (expected None, "
            "'highest', 'high' or 'default')"
        )

    @contextlib.contextmanager
    def tf32():
        before = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = before

    return tf32()


def compiled_eigsh_solver(
    basis,
    a_form: Callable,
    m_form: Callable,
    k: int = 6,
    *,
    tol: float = 1e-9,
    max_rounds: int = 60,
    solve_tol: float = 1e-10,
    solve_maxiter: Optional[int] = None,
    precondition: str = "two_level",
    max_b: Optional[int] = None,
    seed: int = 0,
    matmul_precision: Optional[str] = "highest",
    method: str = "lobpcg",
    lock_tol: Optional[float] = None,
):
    """Generalized eigensolve on built tables: the counterpart of the JAX
    package's one-jit ``compiled_eigsh_solver`` and of
    :meth:`AbstractBasis.solve_eigsh`.

    Each solve scatters both forms into the BSR layout (full entry slots),
    sets the preconditioner up from A's values and runs
    ``method="lobpcg"`` (the default; ``ops.eigen.lobpcg_eigsh`` with
    ``max_rounds=max(max_rounds, 200)``: one A- and one M-product and one
    preconditioner application per column per round; ``solve_tol`` and
    ``solve_maxiter`` are unused) or ``"subspace"``
    (``ops.eigen.subspace_eigsh_while``: shift-invert subspace iteration,
    full inner PCG A-solves per column). Both stop on the relative change
    of the leading ``k`` eigenvalues <= ``tol``. The start block is NumPy's
    ``default_rng(seed)`` over ``(n_dofs, m)`` in float64, cast to the
    basis's dtype, with m = ``min(k + max(2, k // 2), n_inner)``.

    Args:
      precondition: ``"two_level"`` (the aggregate-block M on a scalar
        basis, the rigid-body-mode M on a vector basis) or ``"jacobi"``.
      matmul_precision: see ``_mm_precision``.

    Returns ``solve() -> (vals (k,), vecs (n_dofs, k), (rounds,
    eig_change, converged))``: ``rounds`` a Python int, the other two 0-dim
    tensors.
    """
    from .eigen import lobpcg_eigsh, subspace_eigsh_while

    if precondition not in ("two_level", "jacobi"):
        raise ValueError(
            f"unknown precondition: {precondition!r} "
            "(expected 'two_level' or 'jacobi')"
        )
    if method not in ("lobpcg", "subspace"):
        raise ValueError(
            f"unknown method: {method!r} (expected 'lobpcg' or 'subspace')"
        )
    _mm_precision(matmul_precision)  # an unknown name raises here, before any table
    n_inner = int(basis._basis_parameters["inner_dofs"].numel())
    if k > n_inner:
        raise ValueError(f"requested k={k} eigenpairs from an n={n_inner} system")
    m_block = min(k + max(2, k // 2), n_inner)

    st, setup = _bsr_setup(
        basis, max_b, "auto" if precondition == "two_level" else "jacobi"
    )
    n_dofs = basis.n_dofs
    rand = torch.as_tensor(
        np.random.default_rng(seed).standard_normal((n_dofs, m_block)),
        dtype=basis.dtype, device=basis.device,
    )

    def solve():
        with _mm_precision(matmul_precision):
            va = bsr_values_from_local(st, basis.integrate_bilinear_form_local(a_form))
            vm = bsr_values_from_local(st, basis.integrate_bilinear_form_local(m_form))
            diag = bsr_diagonal(st, va)
            precond = None if setup is None else setup(va, diag)
            x0 = torch.stack([bsr_reduce(st, rand[:, j]) for j in range(m_block)], dim=1)
            common = dict(
                tol=tol,
                precond=precond,
                precond_diag=None if precond is not None else diag,
            )
            if method == "lobpcg":
                vals, vecs_pad, info = lobpcg_eigsh(
                    lambda v: bsr_matvec(st, va, v),
                    lambda v: bsr_matvec(st, vm, v),
                    x0, k, max_rounds=max(max_rounds, 200), lock_tol=lock_tol, **common,
                )
            else:
                vals, vecs_pad, info = subspace_eigsh_while(
                    lambda v: bsr_matvec(st, va, v),
                    lambda v: bsr_matvec(st, vm, v),
                    x0, k, max_rounds=max_rounds, solve_tol=solve_tol,
                    solve_maxiter=solve_maxiter, **common,
                )
            vecs = torch.stack(
                [bsr_expand(st, vecs_pad[:, j], n_dofs)[..., 0] for j in range(k)], dim=1
            )
        return vals, vecs, info

    return solve


def _stokes_couplings(Vu, Vp, b_form, mass_form, u_dofs):
    """The per-solve-independent parts of a Stokes solve, built once on the
    bases' device: ``apply_b`` (B u, (n_u, 1) -> (n_p, 1), from the mixed
    element matrices gathered at ``u_dofs``), ``project_mean`` (the
    constant pressure mode removed in the lumped-mass inner product),
    ``inv_lump`` and ``mp_total``, and the local B^T."""
    from .saddle import lumped_mass

    local_b = Vp.integrate_mixed_bilinear_form_local(Vu, b_form)
    mp_lumped = lumped_mass(Vp, mass_form)
    mp_total = mp_lumped.sum()
    u_dofs = u_dofs.long()

    def apply_b(u_vec):
        return Vp._assemble_linear_from_local(local_b @ u_vec[:, 0][u_dofs][..., None])

    def project_mean(p_vec):
        return p_vec - (mp_lumped * p_vec).sum() / mp_total

    return apply_b, project_mean, 1.0 / mp_lumped[:, 0], mp_total, local_b.mT


def compiled_stokes_solver(
    velocity_basis,
    pressure_basis,
    a_form: Callable,
    b_form: Callable,
    *,
    tol: float = 1e-8,
    maxiter: Optional[int] = None,
    inner_tol: float = 1e-11,
    inner_maxiter: Optional[int] = None,
    precondition: str = "auto",
    mass_form: Optional[Callable] = None,
    max_b: Optional[int] = None,
    operand_dtype=None,
    matmul_precision: Optional[str] = "highest",
    method: str = "schur",
    minres_restart: Optional[int] = 50,
    inner_eta: float = 0.1,
    inner_tol_max: float = 1e-2,
    f_solve_tol: Optional[float] = None,
    recovery_tol: Optional[float] = None,
    inner_iters: Optional[int] = None,
    a_scalar_form: Optional[Callable] = None,
):
    """Stokes solve on built tables: the counterpart of the JAX package's
    one-jit ``compiled_stokes_solver`` (same math, same contracts, same
    signature and defaults).

    Construction builds the host tables once: the BSR structure of the
    velocity basis (canonical-pair slots only), the affine coarse space
    (``mode_kind="rbm"``, or ``"components"`` for ``"agg_comp"``), the
    aggregate table of the aggregate-block smoother, the mixed element
    matrices of B and the lumped pressure mass. Each ``solve(f, g=None,
    x0=None)`` then runs on the bases' device: A's BSR values, the
    preconditioner setup, and the Schur or MINRES loop on K2.

    Args:
      method: ``"schur"`` (the flexible outer CG of
        ``ops.saddle.schur_flexible_cg`` with warm-started inner A-solves at
        the relaxed tolerance ``clip(inner_eta * tol * ||r_0|| / ||r_k||,
        inner_tol, inner_tol_max)``) or ``"minres"`` (block-diagonally
        preconditioned MINRES on the whole saddle system, with a true
        residual every ``minres_restart`` iterations, then one velocity
        recovery solve to ``inner_tol``).
      precondition: the A-block preconditioner: ``"auto"`` (the
        aggregate-block two-level M on a scalar basis, the rigid-body-mode
        one with the 8x8 block-Jacobi smoother on a vector basis),
        ``"agg_rbm"`` / ``"agg_comp"`` (the rigid-body-mode or
        component-indicator coarse space with the aggregate-block smoother,
        gs = min(g, 128)) or ``"jacobi"``.
      inner_maxiter: cap of the inner and recovery A-solves (default
        max(10 n, 100)).
      f_solve_tol, recovery_tol: the tolerances of the one initial f-solve
        and the one final velocity recovery (default ``inner_tol``).
      inner_iters: every Schur-apply inner solve runs exactly this many PCG
        iterations (tol 0) instead of solving to a tolerance; fast but
        floors the attainable accuracy (the JAX package's measurements).
      a_scalar_form: declares the viscous block component-decoupled: the
        scalar form whose operator, applied per velocity component, equals
        ``a_form``. Every inner solve then runs ``pcg_cols`` on the scalar
        operator of the companion scalar basis with the components as
        columns (schur method only; the caller owns the claim).
      operand_dtype: storage dtype of the A-block preconditioner's dense
        apply operands (e.g. ``torch.bfloat16``); None keeps the values'.
      matmul_precision: see ``_mm_precision``.

    Returns ``solve(f, g=None, x0=None) -> (u, p, StokesInfo)``; the
    pressure has zero lumped-mass mean. ``StokesInfo.outer_iterations`` and
    ``inner_total`` are ints (``inner_total`` None for MINRES).
    """
    from .precondition import affine_two_level_from_values, get_affine_two_level_structure
    from .saddle import StokesInfo, schur_flexible_cg
    from .solvers import minres

    if precondition not in ("auto", "jacobi", "agg_rbm", "agg_comp"):
        raise ValueError(
            f"unknown precondition: {precondition!r} "
            "(expected 'auto', 'agg_rbm', 'agg_comp' or 'jacobi')"
        )
    if method not in ("minres", "schur"):
        raise ValueError(f"unknown method: {method!r} (expected 'minres' or 'schur')")
    _mm_precision(matmul_precision)  # an unknown name raises here, before any table
    common = dict(
        tol=tol, maxiter=maxiter, inner_tol=inner_tol, inner_maxiter=inner_maxiter,
        mass_form=mass_form, max_b=max_b, matmul_precision=matmul_precision,
        inner_eta=inner_eta, inner_tol_max=inner_tol_max, f_solve_tol=f_solve_tol,
        recovery_tol=recovery_tol, inner_iters=inner_iters, operand_dtype=operand_dtype,
    )
    if a_scalar_form is not None:
        if method != "schur":
            raise ValueError("a_scalar_form requires method='schur'")
        return _compiled_stokes_scalar_a(
            velocity_basis, pressure_basis, a_scalar_form, b_form,
            precondition=precondition, **common,
        )
    Vu, Vp = velocity_basis, pressure_basis
    if max_b is None:
        max_b = default_max_b(Vu)
    st = get_bsr_structure(Vu, max_b=max_b, want_entry_slot=False)

    is_vector = int(getattr(Vu, "n_components", 1)) >= 2
    ast = agg_table = None
    g_agg = gs = None
    if precondition != "jacobi":
        if is_vector:
            ast = get_affine_two_level_structure(
                Vu, st, mode_kind="components" if precondition == "agg_comp" else "rbm"
            )
            if precondition in ("agg_rbm", "agg_comp"):
                # for agg_comp the smoother aggregate follows the coarse
                # aggregate of the component space
                gs = (
                    min(ast.W.shape[1], 128)
                    if precondition == "agg_comp"
                    else min(default_aggregate_size(st), 128)
                )
        else:
            g_agg = default_aggregate_size(st)
            gs = min(g_agg, 128)
        if gs is not None:
            agg_table = torch.as_tensor(build_agg_block_table(st, gs), device=Vu.device)

    apply_b, project_mean, inv_lump, mp_total, local_bt = _stokes_couplings(
        Vu, Vp, b_form, mass_form, Vu._global_dofs4elements
    )
    p_dofs = Vp._global_dofs4elements.long()
    n_u, n_p = Vu.n_dofs, Vp.n_dofs

    def apply_bt(p_vec):
        return Vu._assemble_linear_from_local(local_bt @ p_vec[:, 0][p_dofs][..., None])

    def preconditioner(values, diag):
        if precondition == "jacobi":
            return None
        if not is_vector:
            return agg_block_two_level_from_values(
                st, values, diag, g=g_agg, gs=gs, table=agg_table, operand_dtype=operand_dtype
            )
        return affine_two_level_from_values(
            ast, st, values, diag,
            fine="block_jacobi" if precondition == "auto" else "agg_block",
            gs=gs, agg_table=agg_table, operand_dtype=operand_dtype,
        )

    def _run(f, g, x0):
        values = bsr_values_from_local_symmetric(st, Vu.integrate_bilinear_form_local(a_form))
        diag = bsr_diagonal(st, values)
        precond = preconditioner(values, diag)

        def matvec(v):
            return bsr_matvec(st, values, v)

        def solve_a_reduced(rhs_red, x0_red, tol_inner, maxiter_inner=inner_maxiter):
            """Inner A-solve in the reduced padded layout from ``x0_red`` to
            the relative tolerance ``tol_inner`` (a float or a 0-dim tensor)."""
            return pcg(matvec, rhs_red, x0=x0_red, precond_diag=diag, precond=precond,
                       tol=tol_inner, maxiter=maxiter_inner)

        if method == "minres":
            # the whole saddle system, block-diagonal preconditioner: one
            # A-preconditioner application per iteration; the velocity block
            # in the reduced padded layout, where bsr_reduce / bsr_expand are
            # exact adjoints, so K stays symmetric
            nr = st.n_pad
            safe_diag = torch.where(diag != 0, diag, torch.ones_like(diag))
            precond_u = precond if precond is not None else (lambda r: r / safe_diag)

            def k_op(xall):
                xu, xp = xall[:nr], xall[nr:]
                yu = matvec(xu) + bsr_reduce(st, apply_bt(xp[:, None]))
                yp = apply_b(bsr_expand(st, xu, n_u))[:, 0]
                return torch.cat([yu, yp])

            def p_op(rall):
                ru, rp = rall[:nr], rall[nr:]
                # the pressure block: the mean-projected lumped-mass inverse
                zp = inv_lump * rp - torch.sum(rp) / mp_total
                return torch.cat([precond_u(ru), zp])

            rhs = torch.cat([bsr_reduce(st, f), g[:, 0]])
            xall, mr_info = minres(
                k_op, rhs, x0=torch.cat([rhs.new_zeros(nr), x0]), precond=p_op, tol=tol,
                maxiter=maxiter, restart=minres_restart,
            )
            p = project_mean(xall[nr:][:, None])
            # the velocity recovery at inner_tol, from zero
            x, info_u = solve_a_reduced(bsr_reduce(st, f - apply_bt(p)), None, inner_tol)
            info = StokesInfo(
                outer_iterations=mr_info.iterations,
                schur_residual=mr_info.residual_norm,
                converged=mr_info.converged,
                inner_info=info_u,
            )
            return bsr_expand(st, x, n_u), p, info

        if inner_iters is None:
            solve_a_schur = solve_a_reduced
        else:
            # fixed-iteration inexact applies: tol 0 never meets the
            # residual test (but on an exactly zero rhs)
            def solve_a_schur(rhs_red, x0_red, tol_inner):
                return solve_a_reduced(rhs_red, x0_red, 0.0, inner_iters)

        zeros_red = f.new_zeros(st.n_pad)
        u_f_red, info_f = solve_a_reduced(
            bsr_reduce(st, f), zeros_red, f_solve_tol if f_solve_tol is not None else inner_tol
        )
        rhs_p = project_mean(apply_b(bsr_expand(st, u_f_red, n_u)) - g)
        outer_cap = maxiter if maxiter is not None else 10 * n_p
        p_flat, res_fin, k_out, atol, inner_schur, u_bt = schur_flexible_cg(
            rhs_p[:, 0],
            x0,
            apply_bt_w=lambda d: bsr_reduce(st, apply_bt(d[:, None])),
            solve_a=solve_a_schur,
            schur_out=lambda y: project_mean(apply_b(bsr_expand(st, y, n_u)))[:, 0],
            precond_p=lambda r: project_mean((inv_lump * r)[:, None])[:, 0],
            dot_w=lambda a, b: torch.sum(a * b),
            zeros_red=zeros_red,
            tol=tol,
            inner_tol=inner_tol,
            inner_eta=inner_eta,
            inner_tol_max=inner_tol_max,
            outer_cap=outer_cap,
        )
        p = project_mean(p_flat[:, None])
        # the velocity recovery, warm-started from the outer CG's free
        # by-product u_f - u_bt ~ A^{-1}(f - B^T p)
        u_red, info_u = solve_a_reduced(
            bsr_reduce(st, f - apply_bt(p)),
            u_f_red - u_bt,
            recovery_tol if recovery_tol is not None else inner_tol,
        )
        info = StokesInfo(
            outer_iterations=k_out,
            schur_residual=res_fin,
            converged=res_fin <= atol,
            inner_info=info_u,
            inner_total=info_f.iterations + inner_schur + info_u.iterations,
        )
        return bsr_expand(st, u_red, n_u), p, info

    return _stokes_entry(_run, Vp, matmul_precision)


def _stokes_entry(run, Vp, matmul_precision):
    """``solve(f, g=None, x0=None)`` of a compiled Stokes solve: a zero
    ``g`` and ``x0`` by default, on the pressure basis's device and in its
    dtype, made once; ``x0`` is (n_p, 1)."""
    zero_g = Vp.solution_tensor()
    zero_x0 = zero_g[:, 0]

    def solve(f, g=None, x0=None):
        with _mm_precision(matmul_precision):
            return run(f, zero_g if g is None else g, zero_x0 if x0 is None else x0[:, 0])

    return solve


def _compiled_stokes_scalar_a(
    Vu,
    Vp,
    a_scalar_form: Callable,
    b_form: Callable,
    *,
    tol: float,
    maxiter: Optional[int],
    inner_tol: float,
    inner_maxiter: Optional[int],
    precondition: str,
    mass_form: Optional[Callable],
    max_b: Optional[int],
    matmul_precision: Optional[str],
    inner_eta: float,
    inner_tol_max: float,
    f_solve_tol: Optional[float],
    recovery_tol: Optional[float],
    inner_iters: Optional[int],
    operand_dtype,
):
    """The component-decoupled Stokes schur solve (``a_scalar_form``).

    A is ``blkdiag(A_s, ..., A_s)`` with A_s the scalar operator of
    ``a_scalar_form`` on the companion scalar basis; every inner solve runs
    ``pcg_cols`` on A_s with the ``nc`` components as columns
    (``bsr_matvec_cols``: K2 once per column on the card). The interleaved
    vector layout (DOF i * nc + c) makes the vector <-> columns mapping a
    reshape. The preconditioner of the columns applies the scalar M to each
    column alone (the JAX ``vmap``). B^T scatters into the vector layout
    through the flattened vector DOF table, as the JAX package does.
    """
    from ..basis.basis import Basis
    from .bsr import bsr_expand_cols, bsr_matvec_cols, bsr_reduce_cols
    from .eigen import _block
    from .saddle import StokesInfo, schur_flexible_cg
    from .solvers import pcg_cols

    nc = int(getattr(Vu, "n_components", 1))
    if nc < 2:
        raise ValueError("a_scalar_form requires a vector velocity basis")
    if getattr(Vu, "_dirichlet_components", None) is not None:
        raise ValueError(
            "a_scalar_form requires all components Dirichlet-clamped "
            "together (dirichlet_components=None): per-component "
            "constraints break the shared scalar reduction"
        )
    Vs = Basis(Vu.mesh, Vu._element)
    n_s, n_u, n_p = int(Vs.n_dofs), int(Vu.n_dofs), int(Vp.n_dofs)
    if n_s * nc != n_u:
        raise ValueError(
            f"scalar companion basis has {n_s} DOFs but the vector basis "
            f"has {n_u} != {nc} * {n_s}: non-interleaved layout?"
        )
    if max_b is None:
        max_b = default_max_b(Vs)
    st = get_bsr_structure(Vs, max_b=max_b, want_entry_slot=False)
    g_agg = gs = agg_table = None
    if precondition != "jacobi":
        g_agg = default_aggregate_size(st)
        gs = min(g_agg, 128)
        agg_table = torch.as_tensor(build_agg_block_table(st, gs), device=Vs.device)

    u_dofs = Vu._global_dofs4elements
    apply_b, project_mean, inv_lump, _, local_bt = _stokes_couplings(
        Vu, Vp, b_form, mass_form, u_dofs
    )
    u_dofs_flat = u_dofs.reshape(-1).long()
    p_dofs = Vp._global_dofs4elements.long()

    def apply_bt(p_vec):
        # the mixed element blocks scattered straight into the vector layout
        out = p_vec.new_zeros(n_u)
        return out.index_add(
            0, u_dofs_flat, (local_bt @ p_vec[:, 0][p_dofs][..., None])[..., 0].reshape(-1)
        )[:, None]

    def reduce_cols_f(u_flat):
        return bsr_reduce_cols(st, u_flat.reshape(n_s, nc))

    def expand_to_vec(X):
        return bsr_expand_cols(st, X, n_s).reshape(-1)

    def _run(f, g, x0):
        values = bsr_values_from_local_symmetric(
            st, Vs.integrate_bilinear_form_local(a_scalar_form)
        )
        diag = bsr_diagonal(st, values)
        if precondition != "jacobi":
            precond_cols = _block(
                agg_block_two_level_from_values(
                    st, values, diag, g=g_agg, gs=gs, table=agg_table,
                    operand_dtype=operand_dtype,
                )
            )
        else:
            inv_diag = 1.0 / torch.where(diag != 0, diag, torch.ones_like(diag))

            def precond_cols(R):
                return inv_diag[:, None] * R

        def solve_a_cols(rhs_red, x0_red, tol_inner, maxiter_inner=inner_maxiter):
            return pcg_cols(
                lambda X: bsr_matvec_cols(st, values, X), rhs_red, x0=x0_red,
                precond=precond_cols, tol=tol_inner, maxiter=maxiter_inner,
            )

        if inner_iters is None:
            solve_a_schur = solve_a_cols
        else:
            def solve_a_schur(rhs_red, x0_red, tol_inner):
                return solve_a_cols(rhs_red, x0_red, 0.0, inner_iters)

        zeros_red = f.new_zeros((st.n_pad, nc))
        u_f_red, info_f = solve_a_cols(
            reduce_cols_f(f[:, 0]), zeros_red,
            f_solve_tol if f_solve_tol is not None else inner_tol,
        )
        rhs_p = project_mean(apply_b(expand_to_vec(u_f_red)[:, None]) - g)
        outer_cap = maxiter if maxiter is not None else 10 * n_p
        p_flat, res_fin, k_out, atol, inner_schur, u_bt = schur_flexible_cg(
            rhs_p[:, 0],
            x0,
            apply_bt_w=lambda d: reduce_cols_f(apply_bt(d[:, None])[:, 0]),
            solve_a=solve_a_schur,
            schur_out=lambda y: project_mean(apply_b(expand_to_vec(y)[:, None]))[:, 0],
            precond_p=lambda r: project_mean((inv_lump * r)[:, None])[:, 0],
            dot_w=lambda a, b: torch.sum(a * b),
            zeros_red=zeros_red,
            tol=tol,
            inner_tol=inner_tol,
            inner_eta=inner_eta,
            inner_tol_max=inner_tol_max,
            outer_cap=outer_cap,
        )
        p = project_mean(p_flat[:, None])
        # the recovery, warm-started from the outer CG's free by-product
        u_red, info_u = solve_a_cols(
            reduce_cols_f((f - apply_bt(p))[:, 0]),
            u_f_red - u_bt,
            recovery_tol if recovery_tol is not None else inner_tol,
        )
        info = StokesInfo(
            outer_iterations=k_out,
            schur_residual=res_fin,
            converged=res_fin <= atol,
            # per-column recovery info as the scalar summary of StokesInfo
            inner_info=info_u._replace(residual_norm=torch.max(info_u.residual_norm)),
            inner_total=info_f.iterations + inner_schur + info_u.iterations,
        )
        return expand_to_vec(u_red)[:, None], p, info

    return _stokes_entry(_run, Vp, matmul_precision)
