"""The benchmark of the PyTorch/CUDA port (``pytorch_fem_solver_tpu_torch``).

``python3 -m fem_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card; see
``fem_bench/README.md``.
"""
