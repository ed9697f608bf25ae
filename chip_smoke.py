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
   and a seeded x, in float64 (1e-12 relative to ||y||) and float32 (1e-5);
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
   the host.

The last three lines are the card line, the kernels JSON line and the
``{"ok": true, ...}`` line. Kernel times use CUDA events around single
launches with the 50 MB L2 flushed before each (the PCG loop streams more
than L2 between SpMVs), median of the repeats.
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

# H100 SXM data sheet: HBM3 rate and the non-tensor-core float32 peak (the
# table in the on-chip measurement notes); both assume the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# K1 arithmetic per cell, counted from csrc/p1_element.cu: 9+3 edge
# differences, 9 for the cross product, 5+1 for the norm and sqrt, 1+1 for
# area and 1/(4A), 6 dot products of 6 operations, 1 for the load
K1_FLOPS_PER_CELL = 66

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


def time_ms(fn, reps: int = KERNEL_REPS) -> float:
    """Median device time of one call of ``fn`` with a cold L2."""
    import torch

    flush = torch.empty(32 * 2**20, dtype=torch.float32, device="cuda")  # 128 MB
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
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


def phase_k2(st, values64):
    import torch

    from pytorch_fem_solver_tpu_torch.ops.bsr import _bsr_spmv_plain, bsr_matvec

    rng = np.random.default_rng(SEED)
    x64 = torch.as_tensor(rng.standard_normal(st.n_pad), device=values64[0].device)
    max_abs = None
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        vals = tuple(v.to(dtype).contiguous() for v in values64)
        x = x64.to(dtype)
        y = bsr_matvec(st, vals, x)
        ref = _bsr_spmv_plain(st.bcols, vals[0], x, st.bcols2, vals[1], st.heavy_rows)
        torch.cuda.synchronize()
        err = float((y - ref).norm() / ref.norm())
        check(bool(torch.isfinite(y).all()) and err <= tol,
              f"K2 {dtype} vs plain: rel err {err:.3e} <= {tol:g}")
        max_abs = float((y - ref).abs().max())
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
    nh = int(st.heavy_rows.shape[0])
    n_bytes = n_stored * (64 * 4 + 4) + nh * 4 + 2 * st.n_pad * 4
    b_ms, by = bound_ms(n_bytes, 2 * 64 * n_stored)
    log(
        f"K2 bsr_spmv nb={st.nb} B={st.bcols.shape[1]} spill_rows={nh} "
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
    return solve32, x32, iters, launches, median


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
    kernels = []
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((us / PROFILED_SOLVES, evt.count / PROFILED_SOLVES, evt.key))
    kernels.sort(reverse=True)
    device_ms = sum(k[0] for k in kernels) / 1e3
    wall_ms = 1e3 * float(np.median(walls))
    log(f"profile, {PROFILED_SOLVES} solves: wall {wall_ms:.3f} ms per solve under the profiler, "
        f"device {device_ms:.3f} ms, idle share {1 - device_ms / wall_ms:.3f} "
        f"({1 - device_ms / (1e3 * median_s):.3f} of the unprofiled median), "
        f"{sum(k[1] for k in kernels):.0f} kernel launches per solve")
    log("device ms/solve  launches/solve  kernel")
    for us, count, name in kernels[:25]:
        log(f"{us / 1e3:14.4f}  {count:14.1f}  {name[:110]}")


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
    solve32, x32, iters, launches, median = phase_main(st, V32, V64)
    phase_compiled(st, V32, x32)
    phase_profile(solve32, median)

    if failures:
        print("chip_smoke FAILED:\n  " + "\n  ".join(failures), file=sys.stderr)
        return 1
    k1["launches"] = launches["p1_element_3d"]
    k2["launches"] = launches["bsr_spmv"]
    log(f"main path median {median:.6f} s, {iters} iterations, on {card}")
    print(card, flush=True)
    print(json.dumps({"kernels": [k1, k2]}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
