"""The benchmark of ``exploring_meta_tpu_torch`` on one NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything that belongs to one configuration, traffic mix,
per-layer metric or cell is a file of its own, found by its name
(``registry.py``); README.md says how to add one.
"""
