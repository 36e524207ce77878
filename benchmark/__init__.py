"""The benchmark of ``ganmf_tpu_torch`` on one NVIDIA H100.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of the repository's ``BENCHMARK.json`` in a process of its own
and prints one JSON line. Everything a cell needs is found by name:
``configs/<config>.json`` (the model, its data and its precision),
``traffic/<traffic>.json`` (the driver in ``drivers/`` and its parameters),
``workloads/<cell>.json`` (the limits of the comparison that decides
``correct``) and ``layer_metrics/<metric>.py`` (one reader per per-layer
metric). ``reference/`` holds the plain PyTorch and NumPy reference, which
imports nothing of the program.
"""
