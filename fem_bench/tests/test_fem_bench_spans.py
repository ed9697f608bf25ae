"""The readers of the program's spans and counters on made-up records and a
made-up ``recorded()``: the seven metrics' arithmetic, the idle-overlap
sweep on hand-built gaps, and each case in which a reader finds nothing to
read."""

import pytest

from fem_bench import spans
from fem_bench.metrics import (assembly_ms_per_solve, host_read_us_per_iteration,
                               host_reads_per_iteration, idle_pcg_dispatch_share,
                               pcg_dispatch_us_per_iteration, precond_setup_ms_per_solve,
                               solver_tables_s)
from fem_bench.run import RunRecord
from fem_bench.trace import DeviceEvent
from pytorch_fem_solver_tpu_torch.utils import profiling
from pytorch_fem_solver_tpu_torch.utils.profiling import Recording, Span

READERS = (host_reads_per_iteration, pcg_dispatch_us_per_iteration, host_read_us_per_iteration,
           idle_pcg_dispatch_share, assembly_ms_per_solve, precond_setup_ms_per_solve,
           solver_tables_s)


def _request(request: int, t0: int, first: int, device: bool = True) -> list:
    """One request's spans from ``t0`` (ns), at indices from ``first``:
    assembly, the M's set-up with one read, a PCG loop with three reads."""
    ms = (lambda v: v) if device else (lambda v: None)
    solve, setup, loop = first, first + 2, first + 4
    return [
        Span("fem.solve", request, None, t0, t0 + 1000),
        Span("fem.assemble", request, solve, t0 + 10, t0 + 100, ms(0.05)),
        Span("fem.precond_setup", request, solve, t0 + 100, t0 + 200, ms(0.03)),
        Span("fem.host_read", request, setup, t0 + 150, t0 + 160),
        Span("fem.pcg", request, solve, t0 + 200, t0 + 900),
        Span("fem.host_read", request, loop, t0 + 300, t0 + 350),
        Span("fem.host_read", request, loop, t0 + 500, t0 + 520),
        Span("fem.host_read", request, loop, t0 + 880, t0 + 900),
    ]


def _recording(device: bool = True, requests: int = 2) -> Recording:
    tables = [Span("fem.tables.solver", None, None, -3_000_000_000, -1_000_000_000),
              Span("fem.tables.bsr", None, 0, -2_500_000_000, -2_000_000_000)]
    out = list(tables)
    for r in range(requests):
        out += _request(r + 1, 1000 * r, len(out), device)
    return Recording(out, {"host_reads": 4 * requests})


#: busy [0, 250), [400, 1850), [1950, 2000): idle gaps [250, 400) and [1850, 1950)
EVENTS = [DeviceEvent("k", 0, 250), DeviceEvent("Memcpy DtoH", 200, 240),
          DeviceEvent("k", 400, 1850), DeviceEvent("k", 1950, 2000)]


def _record(**kw):
    base = dict(setup_s=1.0, tables_s=0.5, window_s=1e-6, latencies_s=[1e-6, 1e-6],
                iterations=[2, 2], converged=[True, True], peak_window_bytes=0,
                events=EVENTS, work=None)
    base.update(kw)
    return RunRecord(**base)


@pytest.fixture
def program(monkeypatch):
    """Make ``recorded()`` return what the test sets."""
    box = {"rec": _recording()}
    monkeypatch.setattr(profiling, "recorded", lambda: box["rec"])
    return box


def test_the_seven_readers(program):
    r = _record()
    assert host_reads_per_iteration.read(r) == 8 / 4
    # each loop: 700 ns less 90 ns of reads; two loops over four iterations
    assert pcg_dispatch_us_per_iteration.read(r) == pytest.approx(2 * 610 / 1e3 / 4)
    # the set-up's read is not the loop's
    assert host_read_us_per_iteration.read(r) == pytest.approx(2 * 90 / 1e3 / 4)
    assert assembly_ms_per_solve.read(r) == pytest.approx(0.05)
    assert precond_setup_ms_per_solve.read(r) == pytest.approx(0.03)
    assert solver_tables_s.read(r) == pytest.approx(2.0)
    # the loops' own time [200, 300) [350, 500) [520, 880) and [1200, 1300)
    # [1350, 1500) [1520, 1880) meet the gaps in 50 + 50 and 30 of 250 ns
    assert idle_pcg_dispatch_share.read(r) == pytest.approx(100 * 130 / 250)


def test_intervals_on_hand_built_gaps():
    assert spans.idle_gaps(EVENTS) == [(250, 400), (1850, 1950)]
    rec = _recording()
    assert spans.self_intervals(rec.spans, "fem.pcg", "fem.host_read") == [
        (200, 300), (350, 500), (520, 880), (1200, 1300), (1350, 1500), (1520, 1880)]
    assert spans.overlap_ns([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert spans.overlap_ns([(0, 10)], [(10, 20)]) == 0
    assert spans.overlap_ns([(0, 100)], [(10, 20), (30, 40), (90, 200)]) == 30
    assert spans.overlap_ns([], [(0, 1)]) == 0
    # a read that starts with its loop leaves no empty piece
    loop = [Span("fem.pcg", 1, None, 0, 100), Span("fem.host_read", 1, 0, 0, 10),
            Span("fem.host_read", 1, 0, 90, 100)]
    assert spans.self_intervals(loop, "fem.pcg", "fem.host_read") == [(10, 90)]


def test_nothing_to_read_without_the_recorder(monkeypatch):
    monkeypatch.delattr(profiling, "recorded")  # the parent commit's program
    for reader in READERS:
        assert reader.read(_record()) is None


def test_nothing_to_read_without_a_solve(program):
    program["rec"] = _recording(requests=0)
    for reader in READERS:
        assert reader.read(_record(latencies_s=[], iterations=[], converged=[])) is None
        assert reader.read(_record()) is None


def test_nothing_to_read_when_the_requests_differ(program):
    r = _record(latencies_s=[1e-6] * 3, iterations=[2] * 3, converged=[True] * 3)
    for reader in READERS:
        assert reader.read(r) is None


def test_device_times_need_the_card(program):
    program["rec"] = _recording(device=False)
    assert assembly_ms_per_solve.read(_record()) is None
    assert precond_setup_ms_per_solve.read(_record()) is None
    assert host_reads_per_iteration.read(_record()) == 2.0


def test_idle_share_needs_the_device_trace(program):
    assert idle_pcg_dispatch_share.read(_record(events=None)) is None
    assert idle_pcg_dispatch_share.read(_record(events=[])) is None
    assert idle_pcg_dispatch_share.read(_record(events=EVENTS[:1])) is None  # no gap


def test_tables_of_an_earlier_build_are_not_taken(program):
    rec = program["rec"]
    late = Span("fem.tables.solver", None, None, 5000, 6000)  # after the window began
    early = Span("fem.tables.solver", None, None, -9_000_000_000, -8_000_000_000)
    program["rec"] = Recording([early] + rec.spans[:1] + [late], rec.counters)
    # no fem.solve is left: nothing to read
    assert solver_tables_s.read(_record()) is None
    shifted = [s._replace(parent=None if s.parent is None else s.parent + 1) for s in rec.spans]
    program["rec"] = Recording([early] + shifted + [late], rec.counters)
    assert solver_tables_s.read(_record()) == pytest.approx(2.0)


def test_split_of_a_made_up_window(program):
    from fem_bench.split import analyse

    out = analyse([1e-6, 1e-6], [2, 2], EVENTS, profiling.recorded())
    assert out["requests"] == 2 and out["host_reads_per_request"] == 4
    assert out["device_events_per_request"] == 2 and out["dtoh_per_request"] == 0.5
    assert out["launches_per_iteration"] == 3 / 4
    assert out["solve_over_latency"] == pytest.approx(1.0)
    idle = out["idle_by_state"]
    # the gaps [250, 400) and [1850, 1950): the loops' own time 130 ns of
    # 250, the first loop's first read [300, 350) 50, the second loop's
    # last [1880, 1900) 20, the second solve's tail after its loop
    # [1900, 1950) 50
    assert idle["pcg_dispatch"] == pytest.approx(52.0)
    assert idle["pcg_first_read"] == pytest.approx(20.0)
    assert idle["pcg_read"] == pytest.approx(8.0)
    assert idle["solve_rest"] == pytest.approx(20.0)
    assert idle["outside_solve"] == idle["assemble"] == idle["setup_read"] == 0
    host = out["host_ms_per_request"]
    assert host["pcg_dispatch"] == pytest.approx(610e-6)
    assert host["pcg_first_read"] == pytest.approx(50e-6)
    assert host["pcg_read"] == pytest.approx(40e-6) and host["setup_read"] == pytest.approx(10e-6)
    assert host["assemble"] == pytest.approx(90e-6) and host["precond_setup"] == pytest.approx(90e-6)
    assert host["solve_rest"] == pytest.approx(110e-6)
    assert host["outside_solve"] == pytest.approx(0.0, abs=1e-12)
    assert out["read_lag_us"]["reads"] == out["read_lag_us"]["matched"] == 6
    q = out["by_quarter"]
    assert len(q) == 4 and q[1]["dispatch_us_per_iteration"] == pytest.approx(610 / 1e3 / 2)
