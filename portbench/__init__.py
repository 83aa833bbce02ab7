"""The benchmark of the PyTorch and CUDA port (``repro_torch``): cells of
the boundary-row eigensolver on one card, run as ``python3
portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>``
from the root of a checkout.  See ``BENCHMARK.json`` and ``PERF.md``."""
