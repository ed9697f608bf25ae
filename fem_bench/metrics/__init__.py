"""One reader per metric of ``BENCHMARK.json``, found by the metric's
name: ``read(run) -> float | None`` (``fem_bench.run.RunRecord``). A
reader that finds nothing to read returns None and the metric is left out
of the result."""
