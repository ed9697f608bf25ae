#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Usage, from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. build the hand-written kernels from ``pytorch_fem_solver_tpu_torch/csrc``
   with nvcc for ``sm_90a`` (one nvcc per source, in parallel) and print the
   card's name and power limit;
2. K1 (P1 element kernel) against its plain PyTorch version on the h=0.03
   seven-fracture DFN's 214,988 cells, in float64 (1e-12 relative) and
   float32 (1e-5 relative to each output row's max magnitude: FMA
   contraction and operation order differ, so it cannot be bit-exact);
3. K2 (BSR SpMV) against its plain version on the h=0.03 assembled values
   and a seeded x, in float64 (1e-12 relative to ||y||) and float32 (1e-5),
   two launches bitwise equal; the stored and slot counts of both tiers,
   and the bytes the kernel streams beside the bound's (within 5%); the
   same comparison on the h=0.1 DFN for a narrow tier 1 (``max_b=4``), the
   default (8) and no tier 2 (``max_b=None``);
4. the main path, ``pytorch_fem_solver_tpu_torch/bench.py``, at h=0.03 in
   float32 on the card: 107,355 DOFs, PCG to a relative residual <= 1e-6 in
   <= 80 iterations, K1 and K2 launched on that run, the solution within
   1e-4 of the same path in float64, the median of 5 timed repeats;
5. ``compiled_bsr_solver`` at h=0.03 in float32 agrees with phase 4 to 1e-4;
6. where the main path's time goes: ``PROFILED_SOLVES`` solves of phase 4's
   path under ``torch.profiler``, printing the wall and device time per
   solve, kernel launches per solve, device time by kernel and the device's
   idle share (1 - device / wall; one stream, so kernels do not overlap),
   against phase 4's unprofiled median as well, since the profiler slows
   the host;
7. the fused PCG tail (``make_fused_pcg`` in the port's ``bench.py``, on
   phase 4's assembled values and aggblock preconditioner, f32 and f64):
   K3 (``agg_smooth_restrict``) and K4 (``coarse_prolong_dot``) against
   their plain versions on seeded vectors (f64 1e-12, f32 1e-5, relative to
   each output's max magnitude; ``rz`` relative to |rz|), and at gs=64 on
   a seeded table (the one-block-per-row K3), and at nc = ns = 67 (no
   multiple of 4: K4's one-word loads) with gs=32 and gs=5; two launches
   of K4 bitwise equal (z and rz); their times beside plain, library and bound, and K2,
   K4 and ``torch.mv`` once more with the L2 flushed by a read (clean
   lines) beside the window's own overhead; ``run_stock(30)`` against ``run_fused(30)`` as CUDA
   graphs (5e-5 in f32, the tool's measure; 1e-10 in f64); the graphed
   per-iteration time of both over 100 iterations, median of 3; and
   ``solve_fused(1e-6)``: residual <= 1e-6 in <= 80 iterations, within 1
   of phase 4's count (equal in f64), within 1e-4 of phase 4's solution,
   K2-K4 launched at least once per iteration;
8. K5 (the 2D P1 element kernel) against its plain version on the RVPINN
   mesh (unit square, n=64: 8,192 cells) and on the h=0.03 DFN's 214,988
   chart cells, with and without a seeded scale, in float64 (1e-12) and
   float32 (1e-5 relative to each row's max); its time at the DFN size;
9. RVPINN training on the card at the benchmark's full size
   (``make_rvpinn()`` of the port's ``bench_vpinn.py``: N=64, width 15,
   depth 4, 50 epochs, float32): counts reset before the setup, K5 launched
   there (it builds the Gram), finite losses whose last is below the first
   through ``train()`` and through ``train_compiled(10)`` (within 1e-4
   relative of ``train()``: the card's scatter sums with atomics), the
   first 10 epochs within 1e-2 relative of a float64 run on the card, the
   s/epoch of both loops (``rvpinn_s_per_epoch`` line), and one profiled
   block of 10 epochs printing device time and launches per epoch and the
   idle share;
10. the two-fracture RVPINN loss of ``make_two_fracture(8)`` and one Adam
    step on the card in float32, within 1e-4 relative of the same port in
    float64 on the CPU;
11. K6 (row gather) on the gather probe's own inputs, equal to the tool's
    NumPy answer exactly (counts reset before it: the probe is K6's path),
    then at the h=0.03 SpMV shapes (x as (n_pad/8, 8), cols the BSR column
    table) in f32 and f64, equal to ``x[cols]``, timed beside it.

The last three lines are the card line, the kernels JSON line and the
``{"ok": true, ...}`` line. Kernel times use CUDA events around single
launches with the 50 MB L2 flushed before each (the PCG loop streams more
than L2 between SpMVs) and the card held busy while the host enqueues the
launch, median of the repeats. The flush is a write of 128 MB, which leaves
the L2 full of dirty lines that the timed kernel's loads have to evict; the
``flush="read"`` times of phase 7 leave clean lines instead, as the PCG loop
does, and the empty window says what the two events cost by themselves.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

H = 0.03
EXPECTED_DOFS = 107_355
MAX_ITERATIONS = 80
TOL = 1e-6
SEED = 0
TIMED_REPEATS = 5
PROFILED_SOLVES = 3
KERNEL_REPS = 30
FIXED_ITERS = 30  # the tool's fused-vs-stock check
LOOP_ITERS = 100  # the tool's PROF_REPS: graphed iterations per timed run
FUSED_VS_STOCK = 5e-5
# device cycles (about 0.25 ms at the H100's 1.98 GHz boost) the card spins
# before each timed launch, so the host's enqueue of the launch falls inside
# the spin and not inside the timed window
SPIN_CYCLES = 500_000
DEVICE = "cuda"  # where phases 7-11 make their inputs

# H100 SXM data sheet: HBM3 rate and the non-tensor-core float32 peak (the
# table in the on-chip measurement notes); both assume the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# K1 arithmetic per cell, counted from csrc/p1_element.cu: 9+3 edge
# differences, 9 for the cross product, 5+1 for the norm and sqrt, 1+1 for
# area and 1/(4A), 6 dot products of 6 operations, 1 for the load
K1_FLOPS_PER_CELL = 66
# K5 arithmetic per cell, counted from csrc/p1_element.cu: 4 edge
# differences, 3 for det, 1 for 1/det, 2 for the area, 10 for the six
# gradient components, 6 entries of 4 operations, 1 for the load
K5_FLOPS_PER_CELL = 45
RVPINN_N = 64
RVPINN_BLOCK = 10
TWO_FRACTURE_N = 8

failures: list[str] = []


def log(*args):
    print(*args, flush=True)


def check(ok: bool, what: str) -> None:
    log(("PASS " if ok else "FAIL ") + what)
    if not ok:
        failures.append(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = KERNEL_REPS, flush: str = "write") -> float:
    """Median device time of one call of ``fn`` with a cold L2: flushed by
    writing 128 MB (dirty lines, the figure every kernel is quoted at) or,
    with ``flush="read"``, by summing them after the write (clean lines)."""
    import torch

    buf = torch.empty(32 * 2**20, dtype=torch.float32, device="cuda")  # 128 MB
    fn()
    times = []
    for _ in range(reps):
        buf.zero_()
        if flush == "read":
            buf.sum()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_flops / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_k1(mesh64):
    import torch

    from pytorch_fem_solver_tpu_torch.ops.kernels import _p1_plain_3d, p1_element_3d

    coords64 = mesh64["cells", "coordinates_3d"].contiguous()
    T = coords64.shape[0]
    max_abs = None
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        c = coords64.to(dtype)
        out = p1_element_3d(c)
        ref = _p1_plain_3d(c.reshape(T, 9).T)
        torch.cuda.synchronize()
        err = float(((out - ref).abs().amax(dim=1) / ref.abs().amax(dim=1)).max())
        finite = bool(torch.isfinite(out).all())
        check(finite and err <= tol, f"K1 {dtype} vs plain: rel err {err:.3e} <= {tol:g}")
        max_abs = float((out - ref).abs().max())
    c32 = coords64.to(torch.float32)
    ms = time_ms(lambda: p1_element_3d(c32))
    plain_ms = time_ms(lambda: _p1_plain_3d(c32.reshape(T, 9).T))
    b_ms, by = bound_ms(T * (9 + 13) * 4, T * K1_FLOPS_PER_CELL)
    log(f"K1 p1_element_3d T={T}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms by {by})")
    return {
        "name": "p1_element_3d",
        "route": "cuda",
        "source": "pytorch_fem_solver_tpu_torch/csrc/p1_element.cu",
        "replaces": "pytorch_fem_solver_tpu/ops/pallas_kernels.py:192",
        "max_abs_err": max_abs,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": by,
        "library_ms": None,
    }


def _csr_of(st, values):
    """The permuted padded operator as one torch CSR matrix (for the
    library yardstick only): every stored block, 64 entries each."""
    import torch

    v1, v2 = values
    k = st.block
    nb, B = st.bcols.shape
    nh, B2 = st.bcols2.shape
    dev = v1.device
    ii, jj = torch.meshgrid(torch.arange(k, device=dev), torch.arange(k, device=dev), indexing="ij")
    br = torch.cat([
        torch.arange(nb, device=dev).repeat_interleave(B),
        st.heavy_rows.long().repeat_interleave(B2),
    ])
    bc = torch.cat([st.bcols.long().reshape(-1), st.bcols2.long().reshape(-1)])
    vals = torch.cat([v1.reshape(-1, k, k), v2.reshape(-1, k, k)])
    stored = torch.as_tensor(np.sort(st.blk_id_host), device=dev)
    rows = (br[stored, None, None] * k + ii).reshape(-1)
    cols = (bc[stored, None, None] * k + jj).reshape(-1)
    a = torch.sparse_coo_tensor(
        torch.stack([rows, cols]), vals[stored].reshape(-1), (st.n_pad, st.n_pad),
        check_invariants=False,
    )
    return a.coalesce().to_sparse_csr()


def _check_k2(tag, st, values64, x64):
    """K2 against its plain version in f64 and f32, two launches bitwise
    equal, one launch counted per product; the f32 max absolute error."""
    import torch

    from pytorch_fem_solver_tpu_torch.ops import cuda_build
    from pytorch_fem_solver_tpu_torch.ops.bsr import _bsr_spmv_plain, bsr_matvec

    max_abs = None
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        vals = tuple(v.to(dtype).contiguous() for v in values64)
        x = x64.to(dtype)
        before = cuda_build.launch_counts["bsr_spmv"]
        y = bsr_matvec(st, vals, x)
        counted = cuda_build.launch_counts["bsr_spmv"] - before
        ref = _bsr_spmv_plain(st.bcols, vals[0], x, st.bcols2, vals[1], st.heavy_rows)
        again = bsr_matvec(st, vals, x)
        torch.cuda.synchronize()
        err = float((y - ref).norm() / ref.norm())
        check(bool(torch.isfinite(y).all()) and err <= tol,
              f"K2 {tag} {dtype} vs plain: rel err {err:.3e} <= {tol:g}")
        check(torch.equal(y, again) and counted == 1,
              f"K2 {tag} {dtype}: two launches bitwise equal, {counted} launch per product")
        max_abs = float((y - ref).abs().max())
    return max_abs


def phase_k2_structures():
    """K2 on the h=0.1 DFN with a narrow tier 1 and a wide tier 2
    (``max_b=4``), the default (8) and no tier 2 at all (``max_b=None``)."""
    import torch

    import pytorch_fem_solver_tpu_torch as pt
    from pytorch_fem_solver_tpu_torch.bench import benchmark_basis
    from pytorch_fem_solver_tpu_torch.ops.bsr import (
        bsr_values_from_local_symmetric,
        get_bsr_structure,
    )

    V = benchmark_basis(pt.build_benchmark_network(0.1, device=DEVICE, dtype=torch.float64))
    local = V.integrate_bilinear_form_local(lambda b: b.v_grad @ b.v_grad.mT)
    for max_b in (4, 8, None):
        st = get_bsr_structure(V, max_b=max_b, want_entry_slot=False)
        (nb, B), (nh, B2) = st.bcols.shape, st.bcols2.shape
        log(f"K2 structure h=0.1 max_b={max_b}: nb={nb} B={B} nh={nh} B2={B2} "
            f"stored={st.blk_id_host.size} of {nb * B + nh * B2} slots")
        check((nh == 0) == (max_b is None) and (max_b != 4 or B2 > B),
              f"K2 structure max_b={max_b}: tier 2 as expected (nh={nh}, B2={B2})")
        x64 = torch.as_tensor(
            np.random.default_rng(SEED + 2).standard_normal(st.n_pad), device=DEVICE
        )
        _check_k2(f"h=0.1 max_b={max_b}", st, bsr_values_from_local_symmetric(st, local), x64)


def phase_k2(st, values64):
    import torch

    from pytorch_fem_solver_tpu_torch.ops.bsr import _bsr_spmv_plain, bsr_matvec

    rng = np.random.default_rng(SEED)
    x64 = torch.as_tensor(rng.standard_normal(st.n_pad), device=values64[0].device)
    max_abs = _check_k2(f"h={H}", st, values64, x64)
    vals32 = tuple(v.to(torch.float32).contiguous() for v in values64)
    x32 = x64.to(torch.float32)
    ms = time_ms(lambda: bsr_matvec(st, vals32, x32))
    plain_ms = time_ms(
        lambda: _bsr_spmv_plain(st.bcols, vals32[0], x32, st.bcols2, vals32[1], st.heavy_rows)
    )
    csr = _csr_of(st, vals32)
    y_lib = torch.mv(csr, x32)
    y_ker = bsr_matvec(st, vals32, x32)
    torch.cuda.synchronize()
    lib_err = float((y_lib - y_ker).norm() / y_ker.norm())
    check(lib_err <= 1e-5, f"K2 vs torch CSR matvec: rel diff {lib_err:.3e} <= 1e-05")
    library_ms = time_ms(lambda: torch.mv(csr, x32))
    n_stored = int(st.blk_id_host.size)
    (nb, B), (nh, B2) = st.bcols.shape, st.bcols2.shape
    stored1 = int((st.blk_id_host < nb * B).sum())
    log(f"K2 tiers: tier 1 (nb={nb}, B={B}) {stored1} of {nb * B} slots stored; "
        f"tier 2 (nh={nh}, B2={B2}) {n_stored - stored1} of {nh * B2} slots stored")
    # every stored block and its column, the two per-row tables (row_blocks,
    # heavy_rank) and the two vectors, in f32 words
    n_bytes = n_stored * (64 * 4 + 4) + 2 * nb * 4 + 2 * st.n_pad * 4
    b_ms, by = bound_ms(n_bytes, 2 * 64 * n_stored)
    # what the kernel's loads ask of memory: the same, but the column tables
    # come in 32-byte sectors, so a row's last sector brings padded slots
    counts = st.row_blocks.cpu().numpy().astype(np.int64)
    sectors = -(-np.minimum(counts, B) * 4 // 32) + -(-np.maximum(counts - B, 0) * 4 // 32)
    streamed = n_stored * 64 * 4 + int(sectors.sum()) * 32 + 2 * nb * 4 + 2 * st.n_pad * 4
    log(f"K2 bytes: the bound counts {n_bytes}, the kernel streams {streamed} "
        f"({streamed / n_bytes:.4f} of it); a walk of every slot would stream "
        f"{(nb * B + nh * B2) * (64 * 4 + 4) + 2 * st.n_pad * 4}")
    check(abs(streamed / n_bytes - 1) <= 0.05,
          f"K2 streams {streamed / n_bytes:.4f} of the bound's bytes (within 5%)")
    log(
        f"K2 bsr_spmv nb={st.nb} B={B} spill_rows={nh} "
        f"stored_blocks={n_stored}: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
        f"torch CSR {library_ms:.4f} ms, bound {b_ms:.4f} ms by {by})"
    )
    return {
        "name": "bsr_spmv",
        "route": "cuda",
        "source": "pytorch_fem_solver_tpu_torch/csrc/bsr_spmv.cu",
        "replaces": "tools/exp_pallas_spmv.py:63",
        "max_abs_err": max_abs,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": by,
        "library_ms": library_ms,
    }


def phase_main(st, V32, V64):
    import torch

    from pytorch_fem_solver_tpu_torch.bench import make_bsr_solve
    from pytorch_fem_solver_tpu_torch.ops import cuda_build

    solve32 = make_bsr_solve(V32, tol=TOL)
    solve64 = make_bsr_solve(V64, tol=TOL)
    solve32()  # warm-up: library handles, allocator
    torch.cuda.synchronize()

    cuda_build.reset_launch_counts()
    x32, iters, rel = solve32()
    torch.cuda.synchronize()
    launches = dict(cuda_build.launch_counts)

    log(f"main path: dofs={V32.n_dofs} iterations={iters} rel_res={float(rel):.4e} launches={launches}")
    check(V32.n_dofs == EXPECTED_DOFS, f"DOFs {V32.n_dofs} == {EXPECTED_DOFS}")
    check(float(rel) <= TOL, f"relative residual {float(rel):.3e} <= {TOL:g}")
    check(iters <= MAX_ITERATIONS, f"iterations {iters} <= {MAX_ITERATIONS}")
    check(bool(torch.isfinite(x32).all()), "solution finite")
    check(launches["p1_element_3d"] >= 1, f"K1 launched on the main path ({launches['p1_element_3d']})")
    check(launches["bsr_spmv"] >= iters, f"K2 launches {launches['bsr_spmv']} >= iterations {iters}")

    x64, iters64, rel64 = solve64()
    torch.cuda.synchronize()
    n = st.n_inner
    diff = float((x32[:n].double() - x64[:n]).norm() / x64[:n].norm())
    log(f"f64 on the card: iterations={iters64} rel_res={float(rel64):.4e}; f32-vs-f64 rel L2 {diff:.4e}")
    check(diff <= 1e-4, f"f32 solution vs f64 solution {diff:.3e} <= 1e-4")

    times = []
    for _ in range(TIMED_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve32()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    median = float(np.median(times))
    log(f"main path f32 h={H}: median {median:.6f} s over {TIMED_REPEATS} repeats {times}")
    return solve32, x32, iters, iters64, launches, median


def phase_compiled(st, V32, x32):
    import torch

    from pytorch_fem_solver_tpu_torch.ops.bsr import bsr_expand
    from pytorch_fem_solver_tpu_torch.ops import cuda_build

    solve = V32.compiled_solver(lambda b: b.v_grad @ b.v_grad.mT, lambda b: b.v, tol=TOL)
    cuda_build.reset_launch_counts()
    u, info = solve()
    torch.cuda.synchronize()
    launches = dict(cuda_build.launch_counts)
    ref = bsr_expand(st, x32, V32.n_dofs)
    diff = float((u - ref).norm() / ref.norm())
    log(f"compiled_bsr_solver: iterations={info.iterations} residual={float(info.residual_norm):.4e} launches={launches}")
    check(bool(info.converged), "compiled_bsr_solver converged")
    check(diff <= 1e-4, f"compiled_bsr_solver vs main path {diff:.3e} <= 1e-4")
    check(launches["bsr_spmv"] >= info.iterations, "compiled_bsr_solver ran K2")
    return info.iterations


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(evt, name, None)
        if value is not None:
            return float(value)
    return 0.0


def _device_kernels(prof, per: int):
    """(device us, launches, name) per run of each kernel, largest first,
    and the device ms per run. User annotations (the optimizer's step range
    on the device timeline) span kernels counted already and are left out."""
    import torch

    kernels = []
    for evt in prof.key_averages():
        us = _device_us(evt)
        if (us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            kernels.append((us / per, evt.count / per, evt.key))
    kernels.sort(reverse=True)
    return kernels, sum(k[0] for k in kernels) / 1e3


def phase_profile(solve32, median_s: float):
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    walls = []
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(PROFILED_SOLVES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solve32()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    kernels, device_ms = _device_kernels(prof, PROFILED_SOLVES)
    wall_ms = 1e3 * float(np.median(walls))
    log(f"profile, {PROFILED_SOLVES} solves: wall {wall_ms:.3f} ms per solve under the profiler, "
        f"device {device_ms:.3f} ms, idle share {1 - device_ms / wall_ms:.3f} "
        f"({1 - device_ms / (1e3 * median_s):.3f} of the unprofiled median), "
        f"{sum(k[1] for k in kernels):.0f} kernel launches per solve")
    log("device ms/solve  launches/solve  kernel")
    for us, count, name in kernels[:25]:
        log(f"{us / 1e3:14.4f}  {count:14.1f}  {name[:110]}")


def _rel_err(ours, ref) -> float:
    """max |ours - ref| / max |ref| (for a 0-d tensor |ours - ref| / |ref|)."""
    return float((ours - ref).abs().max() / ref.abs().max())


def _tail_inputs(ns, gs, dtype):
    """Seeded (alpha, [x, r, p, ap]) for K3, on the card."""
    import torch

    rng = np.random.default_rng(SEED)
    vecs = [torch.as_tensor(rng.standard_normal((ns, gs)), device=DEVICE).to(dtype)
            for _ in range(4)]
    alpha = torch.tensor(rng.uniform(0.5, 1.5), dtype=dtype, device=DEVICE)
    return alpha, vecs


def _check_tail(tag, pre_inv, coarse_inv, alpha, vecs, tol):
    """K3 and K4 against their plain versions on the same inputs (K4 fed the
    plain K3's outputs); returns the largest absolute error of each."""
    import torch

    from pytorch_fem_solver_tpu_torch.ops import fused_pcg as fp

    k3 = fp.agg_smooth_restrict(alpha, *vecs, pre_inv)
    ref3 = fp._agg_smooth_restrict_plain(alpha, *vecs, pre_inv)
    k4 = fp.coarse_prolong_dot(coarse_inv, ref3[3], ref3[2], ref3[1])
    ref4 = fp._coarse_prolong_dot_plain(coarse_inv, ref3[3], ref3[2], ref3[1])
    again = fp.coarse_prolong_dot(coarse_inv, ref3[3], ref3[2], ref3[1])
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(again, k4)),
          f"K4 {tag}: two launches bitwise equal (z and rz)")
    out = {}
    for kernel, names, ours, refs in (
        ("K3", ("xn", "rn", "s", "rc"), k3, ref3),
        ("K4", ("z", "rz"), k4, ref4),
    ):
        errs = {n: _rel_err(a, b) for n, a, b in zip(names, ours, refs)}
        finite = all(bool(torch.isfinite(a).all()) for a in ours)
        worst = max(errs.values())
        check(finite and worst <= tol,
              f"{kernel} {tag} vs plain: rel err {worst:.3e} <= {tol:g} "
              + " ".join(f"{n}={e:.2e}" for n, e in errs.items()))
        out[kernel] = max(float((a - b).abs().max()) for a, b in zip(ours, refs))
    return out


def _loop_s_per_iter(run) -> float:
    """Median wall time per iteration of ``run(LOOP_ITERS)`` (a replayed
    CUDA graph), over 3 runs after the capturing one."""
    import torch

    run(LOOP_ITERS)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(LOOP_ITERS)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / LOOP_ITERS)
    return float(np.median(times))


def _figure(tag, name, replaces, kernel, plain, library, lib_name, n_bytes, n_flops,
            max_abs):
    """Time one kernel, its plain version and its library yardstick; the
    kernels-line entry without ``launches``."""
    ms = time_ms(kernel)
    plain_ms = time_ms(plain)
    library_ms = time_ms(library)
    b_ms, by = bound_ms(n_bytes, n_flops)
    log(f"{tag} {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, {lib_name} "
        f"{library_ms:.4f} ms, bound {b_ms:.4f} ms by {by})")
    return {
        "name": name,
        "route": "cuda",
        "source": "pytorch_fem_solver_tpu_torch/csrc/fused_pcg.cu",
        "replaces": replaces,
        "max_abs_err": max_abs,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": by,
        "library_ms": library_ms,
    }


def phase_fused(st, V32, V64, x32, iters, iters64, card):
    """Phase 7: the fused PCG tail, K3 and K4."""
    import torch

    from pytorch_fem_solver_tpu_torch.bench import make_fused_pcg
    from pytorch_fem_solver_tpu_torch.ops import cuda_build
    from pytorch_fem_solver_tpu_torch.ops import fused_pcg as fp
    from pytorch_fem_solver_tpu_torch.ops.bsr import bsr_matvec

    fused = {torch.float32: make_fused_pcg(V32), torch.float64: make_fused_pcg(V64)}
    ns, gs = fp.fused_shape(fused[torch.float32].precond, st.n_pad)
    nc = ns
    log(f"fused tail: ns={ns} gs={gs} nc={nc} g={fused[torch.float32].precond.g}")

    # 1. the kernels against their plain versions
    max_abs = {}
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        pre = fused[dtype].precond
        alpha, vecs = _tail_inputs(ns, gs, dtype)
        max_abs[dtype] = _check_tail(f"{dtype} h={H}", pre.inv_agg, pre.coarse_inv, alpha, vecs, tol)
        # gs=64: K3's one-block-per-row kernel, on seeded SPD tables (so rz
        # is a sum of mostly positive terms, as with the real M^{-1})
        rng = np.random.default_rng(SEED + 1)
        a = rng.standard_normal((65, 64, 64))
        spd = a @ a.transpose(0, 2, 1) / 64 + np.eye(64)
        inv64 = torch.as_tensor(spd[:64], device=DEVICE).to(dtype)
        cinv64 = torch.as_tensor(spd[64], device=DEVICE).to(dtype)
        alpha64, vecs64 = _tail_inputs(64, 64, dtype)
        _check_tail(f"{dtype} gs=64", inv64, cinv64, alpha64, vecs64, tol)
        # nc = ns = 67: rows of coarse_inv are not 16-byte aligned, so K4
        # takes its one-word loads; gs=32 (K3's warp kernel) and gs=5
        b = rng.standard_normal((67, 67))
        cinv67 = torch.as_tensor(b @ b.T / 67 + np.eye(67), device=DEVICE).to(dtype)
        for gs_odd in (32, 5):
            c = rng.standard_normal((67, gs_odd, gs_odd))
            inv67 = torch.as_tensor(
                c @ c.transpose(0, 2, 1) / gs_odd + np.eye(gs_odd), device=DEVICE
            ).to(dtype)
            alpha67, vecs67 = _tail_inputs(67, gs_odd, dtype)
            _check_tail(f"{dtype} nc=67 gs={gs_odd}", inv67, cinv67, alpha67, vecs67, tol)

    # 2. per-kernel figures, f32 at the benchmark shapes; bounds count f32
    # words: each input read once, each output written once
    pre = fused[torch.float32].precond
    alpha, vecs = _tail_inputs(ns, gs, torch.float32)
    xn, rn, s, rc = fp._agg_smooth_restrict_plain(alpha, *vecs, pre.inv_agg)
    n = ns * gs
    k3 = _figure(
        "K3", "agg_smooth_restrict", "tools/exp_pallas_fused_pcg.py:125",
        lambda: fp.agg_smooth_restrict(alpha, *vecs, pre.inv_agg),
        lambda: fp._agg_smooth_restrict_plain(alpha, *vecs, pre.inv_agg),
        lambda: torch.bmm(pre.inv_agg, rn.view(ns, gs, 1)), "torch.bmm",
        # inv_agg, alpha, x r p ap in; xn rn s, rc out
        4 * (ns * gs * gs + 1 + 7 * n + ns), 2 * ns * gs * gs + 5 * n,
        max_abs[torch.float32]["K3"],
    )
    k4 = _figure(
        "K4", "coarse_prolong_dot", "tools/exp_pallas_fused_pcg.py:173",
        lambda: fp.coarse_prolong_dot(pre.coarse_inv, rc, s, rn),
        lambda: fp._coarse_prolong_dot_plain(pre.coarse_inv, rc, s, rn),
        lambda: torch.mv(pre.coarse_inv, rc), "torch.mv",
        # coarse_inv, rc, s rn in; z, rz out
        4 * (nc * nc + nc + 3 * n + 1), 2 * nc * nc + 3 * n,
        max_abs[torch.float32]["K4"],
    )
    # K2, K4 and K4's yardstick once more behind a flush that leaves clean
    # lines, and the window with nothing in it
    values32 = fused[torch.float32].values
    x_seed = torch.as_tensor(
        np.random.default_rng(SEED).standard_normal(st.n_pad), device=DEVICE
    ).to(torch.float32)
    windows = {
        "K2": lambda: bsr_matvec(st, values32, x_seed),
        "K4": lambda: fp.coarse_prolong_dot(pre.coarse_inv, rc, s, rn),
        "torch.mv": lambda: torch.mv(pre.coarse_inv, rc),
        "empty window": lambda: None,
    }
    log("ms with the L2 flushed by a write (dirty lines) / by a read (clean lines): "
        + "; ".join(f"{name} {time_ms(fn):.4f} / {time_ms(fn, flush='read'):.4f}"
                    for name, fn in windows.items()))

    # 3. fixed-length runs as CUDA graphs
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, FUSED_VS_STOCK)):
        xs, _ = fused[dtype].run_stock(FIXED_ITERS)
        xf, _ = fused[dtype].run_fused(FIXED_ITERS)
        torch.cuda.synchronize()
        dx = _rel_err(xf, xs)
        check(bool(torch.isfinite(xf).all()) and dx <= tol,
              f"graphed run_fused({FIXED_ITERS}) vs run_stock({FIXED_ITERS}) {dtype}: "
              f"{dx:.3e} <= {tol:g}")
    f32 = fused[torch.float32]
    cuda_build.reset_launch_counts()
    s_stock = _loop_s_per_iter(f32.run_stock)
    captured_stock = dict(cuda_build.launch_counts)
    cuda_build.reset_launch_counts()
    s_fused = _loop_s_per_iter(f32.run_fused)
    captured_fused = dict(cuda_build.launch_counts)
    log(f"launches counted while capturing {LOOP_ITERS} iterations (warm-up + capture, "
        f"so twice one replay): stock {captured_stock}, fused {captured_fused}")
    s_stock2 = _loop_s_per_iter(f32.run_stock)
    s_fused2 = _loop_s_per_iter(f32.run_fused)
    log(f"graphed s/iteration, in turns stock, fused, stock, fused: "
        f"{s_stock:.4e} {s_fused:.4e} {s_stock2:.4e} {s_fused2:.4e}")
    log(json.dumps({
        "metric": "fused_pcg_s_per_iter",
        "h": H,
        "n_pad": st.n_pad,
        "g": f32.precond.g,
        "reps": LOOP_ITERS,
        "stock_s_per_iter": s_stock2,
        "fused_s_per_iter": s_fused2,
        "speedup": s_stock2 / s_fused2,
        "card": card,
    }))

    # 4. the fused solve to tolerance
    cuda_build.reset_launch_counts()
    xf, it, rel = f32.solve_fused(TOL)
    torch.cuda.synchronize()
    launches = dict(cuda_build.launch_counts)
    n_in = st.n_inner
    diff = float((xf[:n_in] - x32[:n_in]).norm() / x32[:n_in].norm())
    log(f"solve_fused f32: iterations={it} rel_res={float(rel):.4e} launches={launches}; "
        f"vs main path rel L2 {diff:.4e}")
    check(float(rel) <= TOL, f"solve_fused relative residual {float(rel):.3e} <= {TOL:g}")
    check(it <= MAX_ITERATIONS, f"solve_fused iterations {it} <= {MAX_ITERATIONS}")
    check(abs(it - iters) <= 1, f"solve_fused iterations {it} within 1 of the main path's {iters}")
    check(bool(torch.isfinite(xf).all()) and diff <= 1e-4,
          f"solve_fused vs main-path solution {diff:.3e} <= 1e-4")
    for name in ("bsr_spmv", "agg_smooth_restrict", "coarse_prolong_dot"):
        check(launches[name] >= it, f"{name} launches {launches[name]} >= iterations {it}")
    _, it64, rel64 = fused[torch.float64].solve_fused(TOL)
    log(f"solve_fused f64: iterations={it64} rel_res={float(rel64):.4e}")
    check(it64 == iters64, f"solve_fused f64 iterations {it64} == main path f64 {iters64}")
    times = []
    for _ in range(TIMED_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f32.solve_fused(TOL)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    log(f"solve_fused f32 (host-driven loop, assembly and setup excluded): median "
        f"{float(np.median(times)):.6f} s over {TIMED_REPEATS} repeats {times}")
    for fig in (k3, k4):
        fig["launches"] = launches[fig["name"]]
    return k3, k4


def _k5_inputs(coords, scale, dtype):
    c = coords.to(dtype).contiguous()
    return c, (None if scale is None else scale.to(dtype).contiguous())


def _k5_plain(c, s):
    """K5's plain version on the SoA rows of (T, 3, 2) cells and a scale."""
    from pytorch_fem_solver_tpu_torch.ops.kernels import _p1_plain, _soa_rows

    return _p1_plain(_soa_rows(c, s))


def phase_k5(mesh64):
    """Phase 8: K5 against its plain version on the RVPINN mesh and the
    DFN's chart cells, with and without a scale; its time at the DFN size."""
    import torch

    from pytorch_fem_solver_tpu_torch.mesh import MeshTri, unit_square
    from pytorch_fem_solver_tpu_torch.ops.kernels import P1_OUT_ROWS_2D, p1_element_2d

    rng = np.random.default_rng(SEED)
    meshes = {
        f"RVPINN n={RVPINN_N}": MeshTri(
            unit_square(n=RVPINN_N), device=DEVICE, dtype=torch.float64
        )["cells", "coordinates"],
        f"DFN h={H}": mesh64["cells", "coordinates"],
    }
    max_abs = 0.0
    for tag, coords in meshes.items():
        scale = torch.as_tensor(rng.uniform(0.5, 1.5, coords.shape[0]), device=DEVICE)
        for s64 in (None, scale):
            for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
                c, s = _k5_inputs(coords, s64, dtype)
                out = p1_element_2d(c, s)
                ref = _k5_plain(c, s)
                torch.cuda.synchronize()
                err = float(((out - ref).abs().amax(dim=1) / ref.abs().amax(dim=1)).max())
                check(bool(torch.isfinite(out).all()) and err <= tol,
                      f"K5 {tag} {'scaled' if s is not None else 'scale 1'} {dtype} vs plain: "
                      f"rel err {err:.3e} <= {tol:g}")
                if dtype == torch.float32:
                    max_abs = max(max_abs, float((out - ref).abs().max()))
    c, s = _k5_inputs(meshes[f"DFN h={H}"], scale, torch.float32)
    T = c.shape[0]
    ms = time_ms(lambda: p1_element_2d(c, s))
    plain_ms = time_ms(lambda: _k5_plain(c, s))
    # 6 coordinates and the scale in, 14 rows out
    b_ms, by = bound_ms(T * (7 + P1_OUT_ROWS_2D) * 4, T * K5_FLOPS_PER_CELL)
    log(f"K5 p1_element_2d T={T}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms by {by})")
    return {
        "name": "p1_element_2d",
        "route": "cuda",
        "source": "pytorch_fem_solver_tpu_torch/csrc/p1_element.cu",
        "replaces": "pytorch_fem_solver_tpu/ops/pallas_kernels.py:44",
        "max_abs_err": max_abs,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": by,
        "library_ms": None,
    }


def _rel_curve(ours, ref) -> float:
    """max over epochs of |ours - ref| / |ref|."""
    ours, ref = np.asarray(ours, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    return float(np.max(np.abs(ours - ref) / np.abs(ref)))


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_rvpinn(card):
    """Phase 9: RVPINN training at the benchmark's full size on the card."""
    import torch

    from pytorch_fem_solver_tpu_torch.bench_vpinn import EPOCHS, make_rvpinn
    from pytorch_fem_solver_tpu_torch.ops import cuda_build

    f32 = torch.float32
    warm = make_rvpinn(epochs=2, device=DEVICE, dtype=f32)  # cuBLAS/cuSOLVER handles, allocator
    warm.model.train()
    warm.model.train_compiled(2)

    # the path: setup (K5 builds the Gram) and 50 eager epochs
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    eager = make_rvpinn(device=DEVICE, dtype=f32)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    eager_s = _timed(eager.model.train) / EPOCHS
    launches = dict(cuda_build.launch_counts)
    losses, _, accs = eager.model.get_training_history()
    log(f"RVPINN n={RVPINN_N} cells={eager.mesh.n_cells} quadrature points="
        f"{eager.basis.integration_points.shape[0] * eager.basis.integration_points.shape[1]} "
        f"inner dofs={eager.gram_inv.shape[0]}: setup {setup_s:.3f} s; launches {launches}")
    check(launches["p1_element_2d"] >= 1,
          f"K5 launched in the RVPINN setup ({launches['p1_element_2d']})")
    check(len(losses) == EPOCHS and bool(np.isfinite(losses).all()),
          f"train(): {len(losses)} finite losses")
    check(losses[-1] < losses[0], f"train(): loss {losses[0]:.6e} -> {losses[-1]:.6e} decreases")

    blocked = make_rvpinn(device=DEVICE, dtype=f32)
    blocked_s = _timed(lambda: blocked.model.train_compiled(RVPINN_BLOCK)) / EPOCHS
    blosses = blocked.model.get_training_history()[0]
    diff = _rel_curve(blosses, losses)
    check(len(blosses) == EPOCHS and bool(np.isfinite(blosses).all()),
          f"train_compiled({RVPINN_BLOCK}): {len(blosses)} finite losses")
    check(diff <= 1e-4, f"train_compiled({RVPINN_BLOCK}) vs train() f32 loss history: "
          f"rel {diff:.3e} <= 1e-4")

    r64 = make_rvpinn(epochs=10, device=DEVICE, dtype=torch.float64)
    r64.model.train()
    d64 = _rel_curve(losses[:10], r64.model.get_training_history()[0])
    check(d64 <= 1e-2, f"f32 vs f64 10-epoch loss history on the card: rel {d64:.3e} <= 1e-2")

    eager_med = float(np.median(eager.model._epoch_times[1:]))
    blocked_med = float(np.median(blocked.model._epoch_times))
    log(f"RVPINN f32 s/epoch: train() {eager_s:.6e} (median host epoch {eager_med:.6e}), "
        f"train_compiled({RVPINN_BLOCK}) {blocked_s:.6e} (median {blocked_med:.6e}); "
        f"loss {losses[0]:.6e} -> {losses[-1]:.6e}, relative H1 {accs[0]:.4f} -> {accs[-1]:.4f}")
    log(json.dumps({
        "metric": "rvpinn_s_per_epoch",
        "n": RVPINN_N,
        "epochs": EPOCHS,
        "train_s_per_epoch": eager_s,
        "train_compiled_s_per_epoch": blocked_s,
        "block_size": RVPINN_BLOCK,
        "card": card,
    }))

    # one profiled block: where an epoch's time goes
    prof_model = make_rvpinn(epochs=RVPINN_BLOCK, device=DEVICE, dtype=f32)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        wall = _timed(lambda: prof_model.model.train_compiled(RVPINN_BLOCK))
    kernels, device_ms = _device_kernels(prof, RVPINN_BLOCK)
    wall_ms = 1e3 * wall / RVPINN_BLOCK
    log(f"profile, one block of {RVPINN_BLOCK} epochs: wall {wall_ms:.3f} ms per epoch under the "
        f"profiler, device {device_ms:.3f} ms, idle share {1 - device_ms / wall_ms:.3f} "
        f"({1 - device_ms / (1e3 * blocked_s):.3f} of the unprofiled train_compiled epoch), "
        f"{sum(k[1] for k in kernels):.0f} kernel launches per epoch")
    log("device ms/epoch  launches/epoch  kernel")
    for us, count, name in kernels[:20]:
        log(f"{us / 1e3:14.4f}  {count:14.1f}  {name[:110]}")
    return launches


def phase_two_fracture():
    """Phase 10: the two-fracture RVPINN loss and one Adam step on the card,
    against the same port in float64 on the CPU."""
    import torch

    from pytorch_fem_solver_tpu_torch.bench_vpinn import make_two_fracture, two_fracture_loss
    from pytorch_fem_solver_tpu_torch.models import Model

    histories = {}
    for device, dtype in (("cpu", torch.float64), (DEVICE, torch.float32)):
        problem = make_two_fracture(TWO_FRACTURE_N, device=device, dtype=dtype)

        def step(net, basis=problem.basis):
            loss = two_fracture_loss(net, basis)
            return loss, loss, loss

        model = Model(problem.network, step, epochs=2, progress_bar=False)
        model.train()  # the loss before and after one step
        histories[dtype] = model.get_training_history()[0]
    card, ref = histories[torch.float32], histories[torch.float64]
    diff = _rel_curve(card, ref)
    log(f"two-fracture n={TWO_FRACTURE_N}: card f32 losses {card}, CPU f64 {ref}")
    check(bool(np.isfinite(card).all()) and diff <= 1e-4,
          f"two-fracture loss and one step, card f32 vs CPU f64: rel {diff:.3e} <= 1e-4")


def phase_k6(st):
    """Phase 11: K6 on the gather probe's inputs (its path) and at the
    h=0.03 SpMV shapes."""
    import torch

    from pytorch_fem_solver_tpu_torch.ops import cuda_build
    from pytorch_fem_solver_tpu_torch.ops.gather import _gather_rows_plain, gather_rows

    rng = np.random.default_rng(0)  # the tool's inputs, in its order
    nb, k, B = 256, 8, 8
    x = rng.normal(size=(nb, k)).astype(np.float32)
    cols = rng.integers(0, nb, size=(nb, B)).astype(np.int32)
    want = torch.as_tensor(x[cols].reshape(nb, B * k), device=DEVICE)
    xd = torch.as_tensor(x, device=DEVICE)
    cd = torch.as_tensor(cols, device=DEVICE)
    cuda_build.reset_launch_counts()
    out = gather_rows(xd, cd)
    torch.cuda.synchronize()
    launches = cuda_build.launch_counts["gather_rows"]
    check(torch.equal(out, want), "K6 on the probe's inputs equals the tool's want exactly")
    check(launches >= 1, f"K6 launched by the probe ({launches})")
    for dtype in (torch.float32, torch.float64):
        xs = torch.as_tensor(rng.standard_normal(st.n_pad), device=DEVICE).to(dtype).reshape(-1, 8)
        bcols = st.bcols.contiguous()
        ours = gather_rows(xs, bcols)
        ref = _gather_rows_plain(xs, bcols)
        torch.cuda.synchronize()
        check(torch.equal(ours, ref), f"K6 {dtype} at the SpMV shapes equals x[cols] exactly")
    nbs, Bs = bcols.shape
    xs32 = xs.to(torch.float32)
    ms = time_ms(lambda: gather_rows(xs32, bcols))
    plain_ms = time_ms(lambda: _gather_rows_plain(xs32, bcols))
    library_ms = time_ms(lambda: xs32[bcols])
    # cols and x read once, the (nb, B*8) blocks written once
    b_ms, by = bound_ms(4 * (nbs * Bs + st.n_pad + nbs * Bs * 8), 0)
    log(f"K6 gather_rows nb={nbs} B={Bs} k=8: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
        f"x[cols] {library_ms:.4f} ms, bound {b_ms:.4f} ms by {by})")
    return {
        "name": "gather_rows",
        "route": "cuda",
        "source": "pytorch_fem_solver_tpu_torch/csrc/gather.cu",
        "replaces": "tools/exp_pallas_gather_probe.py:44",
        "max_abs_err": 0.0,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": by,
        "library_ms": library_ms,
        "launches": launches,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import pytorch_fem_solver_tpu_torch as pt
    from pytorch_fem_solver_tpu_torch.bench import benchmark_basis
    from pytorch_fem_solver_tpu_torch.ops import cuda_build
    from pytorch_fem_solver_tpu_torch.ops.bsr import (
        bsr_values_from_local_symmetric,
        get_bsr_structure,
    )

    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    card = card_line()
    log(f"card: {card}")

    # phase 1: kernel build
    t0 = time.perf_counter()
    logs = cuda_build.build_all(force=True)
    log(f"kernels built in {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
    for name, text in logs.items():
        for line in text.splitlines():
            if "ptxas" in line and ("registers" in line or "spill" in line):
                log(f"  {name}: {line.strip()}")

    # host tables, built once for every phase
    t0 = time.perf_counter()
    mesh64 = pt.build_benchmark_network(H, device="cuda", dtype=torch.float64)
    mesh32 = mesh64.to(dtype=torch.float32)
    V32 = benchmark_basis(mesh32)
    V64 = benchmark_basis(mesh64)
    st = get_bsr_structure(V32, max_b=8, want_entry_slot=False)
    # the structure is integer tables only, the same for both dtypes
    V64._bsr_structures = V32._bsr_structures
    log(
        f"mesh h={H}: cells={mesh64.n_cells} dofs={V32.n_dofs} n_pad={st.n_pad} "
        f"nb={st.nb} B={st.bcols.shape[1]} spill_rows={st.heavy_rows.shape[0]} "
        f"({time.perf_counter() - t0:.1f} s host)"
    )

    k1 = phase_k1(mesh64)
    values64 = bsr_values_from_local_symmetric(
        st, V64.integrate_bilinear_form_local(lambda b: b.v_grad @ b.v_grad.mT)
    )
    k2 = phase_k2(st, values64)
    del values64
    phase_k2_structures()
    solve32, x32, iters, iters64, launches, median = phase_main(st, V32, V64)
    phase_compiled(st, V32, x32)
    phase_profile(solve32, median)
    k3, k4 = phase_fused(st, V32, V64, x32, iters, iters64, card)
    k5 = phase_k5(mesh64)
    rvpinn_launches = phase_rvpinn(card)
    phase_two_fracture()
    k6 = phase_k6(st)

    if failures:
        print("chip_smoke FAILED:\n  " + "\n  ".join(failures), file=sys.stderr)
        return 1
    k1["launches"] = launches["p1_element_3d"]
    k2["launches"] = launches["bsr_spmv"]
    k5["launches"] = rvpinn_launches["p1_element_2d"]
    log(f"main path median {median:.6f} s, {iters} iterations, on {card}")
    print(card, flush=True)
    print(json.dumps({"kernels": [k1, k2, k3, k4, k5, k6]}), flush=True)
    # the run uses one card, whatever the machine holds
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
