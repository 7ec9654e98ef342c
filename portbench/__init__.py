"""The benchmark of ``rlaopt_tpu_torch`` on one NVIDIA card.

``python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints its
result as the last line of standard output. Everything a cell is made of is
found by name: its configuration in ``configs/``, its traffic in
``traffic/``, the limits of its correctness check in ``checks/``, each
metric's reader in ``metrics/``, and the program and the plain reference
that each configuration names in ``programs/`` and ``reference/``. A new
cell, configuration, traffic mix, metric or program is new files there and
new entries in ``BENCHMARK.json``.
"""
