"""The benchmark of ``raytrace_tpu_torch`` on NVIDIA H100 cards.

``python -m h100_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line.  Everything that belongs to one configuration, traffic mix or
per-layer metric is a file of its own under ``configs/``, ``traffic/`` and
``layer_metrics/``, found by the name ``BENCHMARK.json`` gives it.
"""
