"""The benchmark of the PyTorch and CUDA port (``quantizations_tpu_torch``).

Run one cell: ``python3 bench_port/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``. ``BENCHMARK.json`` at the repository's
root names the cells and metrics; the files of each configuration,
cell, traffic mix, span and per-layer metric sit under this folder and
are found by name.
"""
