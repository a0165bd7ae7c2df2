"""The port's benchmarks: one module for each JAX benchmark, each with a
`run(..., device="cuda") -> dict` that returns its JAX counterpart's JSON
fields (every key kept) plus the card's name and power limit.

  solve.py         bench.py: the batched solve at its operating point, the
                   golden run, the certified tier and the r3-compat row
  kernel_check.py  benchmarks/check_pallas_tpu.py: the kernel path against
                   the plain path
  latency.py       benchmarks/bench_latency.py: warm-started queries
  realtime.py      benchmarks/bench_realtime.py: the 10 Hz tick, the 100 Hz
                   inner loop and closed-loop success at one config
  accuracy.py      benchmarks/bench_accuracy.py: the card's f64 solve against
                   the lifted-NLP oracle
  scaling.py       benchmarks/bench_scaling.py (ranks in scaling_worker.py)

The problems are the JAX benchmarks' own draws (problems.py reads
weights/bench_problems.npz).  The CLIs are scripts/torch_bench*.py and
scripts/torch_check_kernels.py.
"""
