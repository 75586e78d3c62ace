"""The benchmark of ``swat_tpu_torch`` on one NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints the
result as one JSON line.  The harness finds everything by name: a
configuration in ``configs/``, a traffic mix in ``traffic/``, a cell's
limits in ``limits/``, an entry kind in ``entries/`` and a per-layer
metric's reader in ``metrics/`` (``README.md``).
"""
