"""The benchmark of the PyTorch/CUDA port (`repro_torch`) on an NVIDIA H100.

`run.py` is the entry; `BENCHMARK.json` at the root of the checkout names
the cells. Everything that belongs to one configuration, one traffic mix or
one metric is a file of its own under `configs/`, `traffic/` and
`metrics/`, found by its name. See `run.py` for the run's shape.
"""
