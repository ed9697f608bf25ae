"""The fused aggregate-block two-level PCG tail (kernels K3 and K4).

Counterpart of ``tools/exp_pallas_fused_pcg.py``: one PCG iteration with the
aggregate-block two-level preconditioner (``AggBlockTwoLevel``) is the SpMV,
``alpha = rz / dot(p, ap)``, then two kernels over the ``(ns, gs)`` views
of the padded vectors, then ``p = z + beta p``:

* K3 ``agg_smooth_restrict``: ``xn = x + alpha p``, ``rn = r - alpha ap``,
  the smoother ``s[i] = inv_agg[i] @ rn[i]`` and the restriction
  ``rc[i] = sum_j rn[i, j]``;
* K4 ``coarse_prolong_dot``: ``zc = coarse_inv @ rc``, the prolongation
  ``z[i, :] = s[i, :] + zc[i]`` and ``rz = sum rn * z``.

So ``z = M^{-1} rn`` and ``rz = rn . z`` come out of the tail without the
preconditioner's separate passes. The algebra needs the coarse aggregates to
be the smoother blocks (``g == gs``, ``nc == ns``); otherwise the loops raise.

Each wrapper takes its plain PyTorch version for CPU tensors and on a CUDA
tensor launches ``csrc/fused_pcg.cu`` or raises. ``alpha`` is a 0-d device
tensor that K3 reads through a pointer, and ``rz`` comes back as one, so
an iteration never reads the device from the host: ``fused_pcg`` runs it
as a step of ``ops.solvers``' chunked loop, captured as a CUDA graph on
the card.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import numpy as np
import torch

from ..utils.profiling import span
from . import cuda_build
from .precondition import AggBlockTwoLevel
from .solvers import PCGGraphs, _pcg_state, _run_chunks, _squared_tolerance

_K3_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int64] * 2 + [ctypes.c_void_p]
_K4_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 2 + [ctypes.c_void_p]
_MAX_GS = 1024  # one thread per smoother row entry
_K4_MAX_RC_BYTES = 226 * 1024  # K4 stages rc in one thread block's shared memory


# -- kernel K3: axpys + aggregate-block smoother + restriction ---------------


def _agg_smooth_restrict_plain(alpha, x, r, p, ap, inv_agg):
    """Plain PyTorch version of K3, the algebra of the Pallas ``k1_kernel``."""
    xn = x + alpha * p
    rn = r - alpha * ap
    s = torch.einsum("rij,rj->ri", inv_agg, rn)
    return xn, rn, s, rn.sum(dim=1)


def k3_lane_map(words_per_piece: int):
    """Which words of a 32x32 block each lane of K3's warp kernel takes.

    With ``N = words_per_piece`` (4 in float32 and 2 in float64 on the
    16-byte path, 1 for a misaligned ``inv_agg``) a row of the block is
    ``P = 32 // N`` pieces and a lane makes ``P`` loads. Returns
    ``(rows, cols, out_col)``: load ``g`` hands lane ``l`` the ``N`` words
    of row ``rows[g, l]`` from column ``cols[g, l]`` on, and after the
    reduce-scatter over each group of ``P`` neighbouring lanes, lane ``l``
    holds ``s[i, out_col[l]]``. The kernel computes the same three
    expressions; this copy is for the tests of the map.
    """
    n = int(words_per_piece)
    if n not in (1, 2, 4):
        raise ValueError(f"a piece is 1, 2 or 4 words, got {words_per_piece}")
    per_row = 32 // n
    lane = np.arange(32)
    load = np.arange(per_row)[:, None]
    rows = n * load + lane // per_row
    cols = np.broadcast_to(n * (lane % per_row), rows.shape).copy()
    return rows, cols, n * (lane % per_row) + lane // per_row


def agg_smooth_restrict(alpha, x, r, p, ap, inv_agg):
    """``(xn, rn, s, rc)`` of one iteration's tail (kernel K3).

    ``x``, ``r``, ``p``, ``ap`` are ``(ns, gs)``; ``inv_agg`` is
    ``(ns, gs, gs)``; ``alpha`` is a 0-d tensor. ``rc`` is ``(ns,)``.
    """
    if x.device.type == "cpu":
        return _agg_smooth_restrict_plain(alpha, x, r, p, ap, inv_agg)
    ns, gs = inv_agg.shape[0], inv_agg.shape[-1]
    dtype = inv_agg.dtype
    if gs > _MAX_GS:
        raise ValueError(f"agg_smooth_restrict takes gs <= {_MAX_GS}, got {gs}")
    cuda_build.check(inv_agg, "inv_agg", (ns, gs, gs), dtype)
    cuda_build.check(alpha, "alpha", (), dtype)
    for name, t in (("x", x), ("r", r), ("p", p), ("ap", ap)):
        cuda_build.check(t, name, (ns, gs), dtype)
    xn, rn, s = (torch.empty_like(x) for _ in range(3))
    rc = torch.empty((ns,), dtype=dtype, device=x.device)
    fn = cuda_build.function(
        "fused_pcg", "agg_smooth_restrict", dtype, _K3_ARGTYPES
    )
    err = fn(
        alpha.data_ptr(), x.data_ptr(), r.data_ptr(), p.data_ptr(),
        ap.data_ptr(), inv_agg.data_ptr(), xn.data_ptr(), rn.data_ptr(),
        s.data_ptr(), rc.data_ptr(), ns, gs,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    cuda_build.raise_on_error(err, "agg_smooth_restrict")
    cuda_build.launch_counts["agg_smooth_restrict"] += 1
    return xn, rn, s, rc


# -- kernel K4: coarse solve + prolongation + rz ----------------------------


def _coarse_prolong_dot_plain(coarse_inv, rc, s, rn):
    """Plain PyTorch version of K4, the algebra of the Pallas ``k2_kernel``."""
    z = s + (coarse_inv @ rc)[:, None]
    return z, torch.sum(rn * z)


# K4's "blocks done" counter, one zeroed int32 per device: the kernel's last
# thread block resets it, so it is zero between launches. Launches on one
# device therefore have to be ordered (one stream, or streams that wait on
# each other, as a graph capture after its warm-up run is).
_k4_counters: dict[int, torch.Tensor] = {}


def _k4_counter(device: torch.device) -> torch.Tensor:
    counter = _k4_counters.get(device.index)
    if counter is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "coarse_prolong_dot: launch once before capturing a CUDA graph "
                "(its counter is allocated at the first launch on a device)"
            )
        counter = torch.zeros((), dtype=torch.int32, device=device)
        _k4_counters[device.index] = counter
    return counter


def coarse_prolong_dot(coarse_inv, rc, s, rn):
    """``(z, rz)``: ``z = s + prolong(coarse_inv @ rc)`` and ``rz = rn . z``
    (kernel K4).

    ``coarse_inv`` is ``(nc, nc)``, ``rc`` ``(nc,)``, ``s`` and ``rn``
    ``(nc, gs)``: coarse unknown i prolongs to smoother row i. ``rz`` is a
    0-d tensor, summed in a fixed order on the card by the thread block
    that finishes last, in the same launch.
    """
    if s.device.type == "cpu":
        return _coarse_prolong_dot_plain(coarse_inv, rc, s, rn)
    nc, gs = s.shape[0], s.shape[-1]
    dtype = coarse_inv.dtype
    if nc < 1 or nc * coarse_inv.element_size() > _K4_MAX_RC_BYTES:
        raise ValueError(
            f"coarse_prolong_dot takes 1 <= nc <= "
            f"{_K4_MAX_RC_BYTES // coarse_inv.element_size()} in {dtype}, got {nc}"
        )
    cuda_build.check(coarse_inv, "coarse_inv", (nc, nc), dtype)
    cuda_build.check(rc, "rc", (nc,), dtype)
    cuda_build.check(s, "s", (nc, gs), dtype)
    cuda_build.check(rn, "rn", (nc, gs), dtype)
    counter = _k4_counter(s.device)
    z = torch.empty_like(s)
    # the thread blocks' partials of rz (at most nc blocks); freed on return
    # while the kernel may still run, which is safe: the caching allocator
    # hands the block only to work queued after it on this stream
    partial = torch.empty((nc,), dtype=dtype, device=s.device)
    rz = torch.empty((), dtype=dtype, device=s.device)
    fn = cuda_build.function(
        "fused_pcg", "coarse_prolong_dot", dtype, _K4_ARGTYPES
    )
    err = fn(
        coarse_inv.data_ptr(), rc.data_ptr(), s.data_ptr(), rn.data_ptr(),
        z.data_ptr(), partial.data_ptr(), counter.data_ptr(), rz.data_ptr(),
        nc, gs, torch.cuda.current_stream(s.device).cuda_stream,
    )
    cuda_build.raise_on_error(err, "coarse_prolong_dot")
    cuda_build.launch_counts["coarse_prolong_dot"] += 1
    return z, rz


# -- the loops --------------------------------------------------------------


def fused_shape(precond: AggBlockTwoLevel, n: int) -> tuple[int, int]:
    """``(ns, gs)`` of the fused tail for vectors of length ``n``; raises
    ``ValueError`` unless the coarse aggregates are the smoother blocks
    (``g == gs`` and ``nc == ns == n / gs``), which K4's prolongation
    assumes."""
    ns, gs = precond.inv_agg.shape[0], precond.gs
    nc = precond.coarse_inv.shape[0]
    if precond.g != gs or nc != ns or ns * gs != n:
        raise ValueError(
            "the fused PCG tail needs coarse aggregates equal to the smoother "
            f"blocks: g={precond.g} gs={gs} nc={nc} ns={ns} n={n}"
        )
    return ns, gs


def _fused_step(matvec, precond, atol2, maxiter, x2, r2, p2, rz, its, active):
    """``ops.solvers._pcg_step`` with the tail through K3/K4, on the
    ``(ns, gs)`` views of x, r and p: SpMV, alpha, K3, K4, beta, the p
    update. Taken only while ``active``; after that x and r hold."""
    ns, gs = r2.shape
    r = r2.view(-1)
    active &= (torch.dot(r, r) > atol2) & (its < maxiter)
    p = p2.view(-1)
    ap = matvec(p)
    alpha = rz / torch.dot(p, ap)
    xn, rn, s, rc = agg_smooth_restrict(
        alpha, x2, r2, p2, ap.view(ns, gs), precond.inv_agg
    )
    z2, rz_new = coarse_prolong_dot(precond.coarse_inv, rc, s, rn)
    torch.where(active, xn, x2, out=x2)
    torch.where(active, rn, r2, out=r2)
    torch.add(z2, (rz_new / rz) * p2, out=p2)
    rz.copy_(rz_new)
    its += active


def fused_pcg(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    precond: AggBlockTwoLevel,
    tol: float = 1e-10,
    maxiter: Optional[int] = None,
    *,
    chunk: int,
    graphs: Optional[PCGGraphs] = None,
):
    """``ops.solvers.pcg_chunked`` with the fused tail; returns ``(x,
    PCGInfo)``.

    The start (x0 = 0, r0 = b - A x0, z0 = M r0 unfused), the default
    ``maxiter``, the stopping rule, ``chunk``, ``graphs`` and ``PCGInfo``
    are ``pcg_chunked``'s; only the x and r updates, z and rz go through
    K3/K4, so the iteration counts can be held to the stock loop's.
    ``tol=0.0, maxiter=iters`` runs ``iters`` iterations. Raises
    ``ValueError`` unless ``fused_shape`` holds.
    """
    n = b.shape[-1]
    ns, gs = fused_shape(precond, n)
    if maxiter is None:
        maxiter = max(10 * n, 100)
    with span("fem.pcg"):
        atol2 = _squared_tolerance(b, tol)
        x, r, p, rz, its, active = _pcg_state(matvec, precond, b)
        state = (x.view(ns, gs), r.view(ns, gs), p.view(ns, gs), rz, its, active)

        def step(*s):
            _fused_step(matvec, precond, atol2, maxiter, *s)

        info = _run_chunks(step, state, atol2, maxiter, chunk, graphs)
        return x, info
