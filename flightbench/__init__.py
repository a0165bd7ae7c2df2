"""The benchmark of the PyTorch port on one NVIDIA H100.

`run.py` runs one cell of `BENCHMARK.json`; everything one configuration,
traffic mix, cell or per-layer metric needs sits in a file of its own
(`configs/`, `mixes/`, `cells/`, `drivers/`, `metrics/`), found by the
name `BENCHMARK.json` gives it.  `reference/` is the plain PyTorch
yardstick that decides `correct`; it imports nothing of the port.
"""
