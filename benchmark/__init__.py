"""The benchmark of the PyTorch/H100 port (``gradaccum_tpu_torch``).

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once on one card and prints one JSON line.
Cells, configurations, traffic mixes and metrics are data and small
readers under this directory, found by the names in ``BENCHMARK.json``.
"""
