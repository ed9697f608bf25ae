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
"""

from __future__ import annotations

import numpy as np
import torch

from .basis import FractureNetworkBasis
from .element import ElementTri
from .ops.bsr import (
    _scatter_drop,
    bsr_complete_symmetric,
    get_bsr_structure,
    inverse_inner_perm,
)
from .ops.compiled import bsr_pcg
from .ops.kernels import p1_element_3d

#: K1 rows of the canonical pairs (0,0) (0,1) (0,2) (1,1) (1,2) (2,2)
SYM_ROWS = (0, 1, 2, 4, 5, 8)
#: K1 rows of the f=1 load
LOAD_ROWS = slice(9, 12)


def benchmark_basis(mesh) -> FractureNetworkBasis:
    """The benchmark's basis: P1 with the order-2 triangle rule."""
    return FractureNetworkBasis(mesh, ElementTri(1, 2))


def make_bsr_solve(basis, *, max_b: int = 8, tol: float = 1e-6, maxiter: int = 600):
    """Build the host tables once; return ``solve() -> (x_pad, iterations,
    rel_res)``.

    ``x_pad`` is the permuted padded solution (``n_pad``,) of the structure
    ``get_bsr_structure(basis, max_b=max_b)`` (cached on the basis), and
    ``rel_res`` the final residual norm over ``||b||`` as a tensor.
    """
    st = get_bsr_structure(basis, max_b=max_b, want_entry_slot=False)
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

    solve_padded = bsr_pcg(st, "auto", tol=tol, maxiter=maxiter)

    def solve():
        out = p1_element_3d(coords)  # (13, T)
        e6 = out[sym_rows] * w6  # diagonal pairs pre-halved
        values = bsr_complete_symmetric(
            st, _scatter_drop(slots_T, e6.reshape(-1), st.n_values)
        )
        b_pad = _scatter_drop(dofs_pad_T, out[LOAD_ROWS].reshape(-1), st.n_pad)
        x, info = solve_padded(values, b_pad)
        rel = info.residual_norm / torch.sqrt(torch.dot(b_pad, b_pad))
        return x, info.iterations, rel

    return solve
