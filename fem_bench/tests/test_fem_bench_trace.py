"""The trace arithmetic and the metric readers on made-up records."""

import math

import pytest

from fem_bench import work
from fem_bench.metrics import (device_idle_share, device_ms_per_solve, launches_per_iteration,
                               pcg_iterations_mean, solve_ms_p95, solves_per_s, spmv_roofline)
from fem_bench.run import RunRecord
from fem_bench.trace import DeviceEvent, busy_intervals, busy_s, idle_gaps, short_name, template_args

SPMV = "void (anonymous namespace)::bsr_spmv_rows<float, float>(int const*, float const*, long)"
SPMV64 = "void (anonymous namespace)::bsr_spmv_rows<double, double>(int const*, double const*, long)"
ADD = ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, "
       "std::array<char*, 3ul> >(int, at::native::CUDAFunctor_add<float>, std::array<char*, 3ul>)")
EVENTS = [DeviceEvent(SPMV, 0, 10_000), DeviceEvent(ADD, 5_000, 20_000),
          DeviceEvent("Memcpy DtoH (Device -> Pageable)", 30_000, 31_000),
          DeviceEvent(SPMV64, 40_000, 60_000)]


def _record(**kw):
    base = dict(setup_s=1.0, tables_s=0.5, window_s=1e-4, latencies_s=[0.01, 0.02, 0.03],
                iterations=[2, 2, 1], converged=[True, True, True], peak_window_bytes=2**30,
                events=EVENTS, work={"nnz": 1000, "rows": 100})
    base.update(kw)
    return RunRecord(**base)


def test_names():
    assert short_name(SPMV) == "bsr_spmv_rows<float, float>"
    assert template_args(SPMV64) == ("double", "double")
    assert template_args("Memcpy DtoH (Device -> Pageable)") == ()
    assert short_name(ADD).startswith("vectorized_elementwise_kernel<4, CUDAFunctor_add<float>")


def test_busy_and_gaps():
    assert busy_intervals(EVENTS) == [(0, 20_000, 0, 1), (30_000, 31_000, 2, 2), (40_000, 60_000, 3, 3)]
    assert busy_s(EVENTS) == pytest.approx(41_000e-9)
    gaps = dict(idle_gaps(EVENTS))
    assert gaps[f"{short_name(ADD)} -> Memcpy DtoH"] == pytest.approx(10e-6)
    assert gaps[f"Memcpy DtoH -> {short_name(SPMV64)}"] == pytest.approx(9e-6)


def test_device_readers():
    r = _record()
    assert launches_per_iteration.read(r) == 3 / 5  # the copy is no launch
    assert device_ms_per_solve.read(r) == pytest.approx((10 + 15 + 1 + 20) / 1e3 / 3)
    assert device_idle_share.read(r) == pytest.approx(100 * (1 - 41e-6 / 1e-4))
    bound = work.roofline_s(1000, 100, 4, 4) + work.roofline_s(1000, 100, 8, 8)
    assert spmv_roofline.read(r) == pytest.approx(100 * bound / 30e-6)
    empty = _record(events=[])
    for reader in (launches_per_iteration, device_ms_per_solve, device_idle_share, spmv_roofline):
        assert reader.read(empty) is None


def test_host_readers():
    r = _record(window_s=0.06)
    assert solves_per_s.read(r) == pytest.approx(50.0)
    assert pcg_iterations_mean.read(r) == pytest.approx(5 / 3)
    lat = [0.001 * k for k in range(1, 101)]
    assert solve_ms_p95.read(_record(latencies_s=lat, converged=[True] * 100)) == pytest.approx(95.0)
    # a request that did not converge is infinitely late; five of them at
    # the tail leave the 95th percentile on a finished one, six do not
    conv = [True] * 95 + [False] * 5
    assert math.isfinite(solve_ms_p95.read(_record(latencies_s=lat, converged=conv)))
    conv = [True] * 94 + [False] * 6
    assert solve_ms_p95.read(_record(latencies_s=lat, converged=conv)) is None
