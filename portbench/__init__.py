"""The benchmark of ``petastorm_tpu_torch`` on NVIDIA cards.

``python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` and prints one JSON result line. The cell
names a configuration (``portbench/configs/<config>.json``, run by the task
module ``portbench/tasks/<task>.py`` it names) and a workload
(``portbench/workloads/<traffic>.json``: the data, the read path and the
limits of the output check). Each per-layer metric is a reader of its own,
``portbench/metrics/<metric>.py``. The plain references that decide
``correct`` live in ``portbench/reference/`` and import nothing of the port.
"""
