"""The reader of the assembly's scatter counters, ``scatter_kernel_share``,
on a made-up ``recorded()``: the share of the scattered values the
program's kernel took, and nothing to read from a program without the
counters or without the recorder."""

import pytest

from fem_bench.metrics import scatter_kernel_share
from fem_bench.run import RunRecord
from pytorch_fem_solver_tpu_torch.utils import profiling
from pytorch_fem_solver_tpu_torch.utils.profiling import Recording, Span


def _recording(counters) -> Recording:
    spans = [Span("fem.solve", r + 1, None, 20_000_000 * r, 20_000_000 * r + 10_000_000)
             for r in range(2)]
    return Recording(spans, counters)


def _record():
    return RunRecord(setup_s=1.0, tables_s=0.5, window_s=0.04, latencies_s=[0.01, 0.01],
                     iterations=[16, 16], converged=[True, True], peak_window_bytes=0,
                     events=[], work=None)


@pytest.mark.parametrize("counters,share", [
    ({"host_reads": 4}, None),  # a program without the counters
    ({"scatter_values": 0}, None),  # nothing scattered
    ({"scatter_values": 2_000, "scatter_kernel_values": 2_000}, 100.0),
    ({"scatter_values": 2_000, "scatter_kernel_values": 500}, 25.0),
    ({"scatter_values": 2_000}, 0.0),  # every value through the stock path
])
def test_scatter_kernel_share(monkeypatch, counters, share):
    monkeypatch.setattr(profiling, "recorded", lambda: _recording(counters))
    assert scatter_kernel_share.read(_record()) == share


def test_nothing_to_read_without_the_recorder(monkeypatch):
    monkeypatch.delattr(profiling, "recorded")
    assert scatter_kernel_share.read(_record()) is None
