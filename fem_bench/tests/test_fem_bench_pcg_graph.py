"""The readers of the captured PCG loop's span and counter on made-up
records and a made-up ``recorded()``: ``pcg_graphed_share`` and
``pcg_capture_ms_per_solve``, and each case in which they find nothing to
read (a program without the captured loop among them)."""

import pytest

from fem_bench.metrics import pcg_capture_ms_per_solve, pcg_graphed_share
from fem_bench.run import RunRecord
from pytorch_fem_solver_tpu_torch.utils import profiling
from pytorch_fem_solver_tpu_torch.utils.profiling import Recording, Span

READERS = (pcg_graphed_share, pcg_capture_ms_per_solve)


def _request(request: int, t0: int, first: int, capture_ns: int) -> list:
    """One request's spans from ``t0`` (ns), at indices from ``first``: a
    PCG loop with a capture of ``capture_ns`` (none for 0) and two reads."""
    solve, loop = first, first + 1
    out = [Span("fem.solve", request, None, t0, t0 + 10_000_000),
           Span("fem.pcg", request, solve, t0 + 1000, t0 + 9_000_000)]
    if capture_ns:
        out.append(Span("fem.pcg.capture", request, loop, t0 + 2000, t0 + 2000 + capture_ns))
    out += [Span("fem.host_read", request, loop, t0 + 8_000_000, t0 + 8_001_000),
            Span("fem.host_read", request, loop, t0 + 8_500_000, t0 + 8_501_000)]
    return out


def _recording(captures=(3_000_000, 5_000_000), counters=None) -> Recording:
    out = [Span("fem.tables.solver", None, None, -3_000_000_000, -1_000_000_000)]
    for r, ns in enumerate(captures):
        out += _request(r + 1, 20_000_000 * r, len(out), ns)
    if counters is None:
        counters = {"host_reads": 2 * len(captures), "pcg_graphed_iterations": 30}
    return Recording(out, counters)


def _record(**kw):
    base = dict(setup_s=1.0, tables_s=0.5, window_s=0.04, latencies_s=[0.01, 0.01],
                iterations=[16, 16], converged=[True, True], peak_window_bytes=0,
                events=[], work=None)
    base.update(kw)
    return RunRecord(**base)


@pytest.fixture
def program(monkeypatch):
    """Make ``recorded()`` return what the test sets."""
    box = {"rec": _recording()}
    monkeypatch.setattr(profiling, "recorded", lambda: box["rec"])
    return box


def test_the_two_readers(program):
    r = _record()
    assert pcg_graphed_share.read(r) == pytest.approx(100 * 30 / 32)
    # (3 + 5) ms of capture over two requests
    assert pcg_capture_ms_per_solve.read(r) == pytest.approx(4.0)
    program["rec"] = _recording(counters={"pcg_graphed_iterations": 32})
    assert pcg_graphed_share.read(r) == pytest.approx(100.0)


def test_nothing_to_read_from_a_program_without_the_captured_loop(program):
    """The host loop records neither the capture nor the counter."""
    program["rec"] = _recording(captures=(0, 0), counters={"host_reads": 34})
    assert [m.read(_record()) for m in READERS] == [None, None]


def test_nothing_to_read_without_the_recorder(monkeypatch):
    monkeypatch.delattr(profiling, "recorded")
    assert [m.read(_record()) for m in READERS] == [None, None]


def test_nothing_to_read_when_the_requests_differ(program):
    assert [m.read(_record(latencies_s=[0.01] * 3, iterations=[16] * 3,
                           converged=[True] * 3)) for m in READERS] == [None, None]


def test_no_share_of_no_iterations(program):
    assert pcg_graphed_share.read(_record(iterations=[0, 0])) is None


def test_an_open_capture_is_not_counted(program):
    rec = _recording()
    k = next(i for i, s in enumerate(rec.spans) if s.name == "fem.pcg.capture")
    rec.spans[k] = rec.spans[k]._replace(end_ns=None)
    program["rec"] = rec
    assert pcg_capture_ms_per_solve.read(_record()) == pytest.approx(2.5)
