"""Export the scenarios that the JAX benchmarks draw to an npz that the
PyTorch port reads with numpy alone:

  learningagileflight_se3_torch/weights/bench_problems.npz
    key0_n2048    bench.py's first batch, PRNGKey(0) (bench.py:74); also
                  bench_scaling.py's silicon row on one device
    key100_n2048, key101_n2048, key102_n2048
                  bench.py's timed reps, PRNGKey(100 + i) (bench.py:102)
    key3_n1       bench_latency.py's query, PRNGKey(3) (bench_latency.py:60)
    key7_n256     check_pallas_tpu.py's batch, PRNGKey(7) (check_pallas_tpu.py:67)
    key0_n256     bench_scaling.py's virtual-mesh batch, PRNGKey(0) (bench_scaling.py:181)
    key0_n64      scaling_worker.py's batch, PRNGKey(0) (scaling_worker.py:63)
    source        what these arrays are

Each array is (n, 9) float32: sample_scenarios(PRNGKey(k), n) with JAX's
default 32-bit types, as those benchmarks draw on an accelerator; the draws
in 64-bit are other numbers.  bench_realtime.py's seed-2024 draw is
bench_success.py's and is in weights/bench_success_seed2024.npz.  Sampling
only: no solve is run.  Needs the JAX package; the port itself never
imports it.

Usage: python scripts/export_bench_problems.py [--out FILE]
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")

from learningagileflight_se3_tpu.models.sampler import sample_scenarios  # noqa: E402

OUT = os.path.join(REPO, "learningagileflight_se3_torch", "weights", "bench_problems.npz")
# (PRNGKey, batch) of every draw
DRAWS = ((0, 2048), (100, 2048), (101, 2048), (102, 2048), (3, 1), (7, 256), (0, 256), (0, 64))
SOURCE = ("CPU draws of the JAX package's sample_scenarios(jax.random.PRNGKey(k), n) in 32-bit, "
          "cast to float32 as the benchmarks cast them; array key<k>_n<n>")


def bench_problems() -> dict:
    """{"key<k>_n<n>": (n, 9) float32} for every draw of DRAWS."""
    with jax.enable_x64(False):
        return {f"key{k}_n{n}": np.asarray(sample_scenarios(jax.random.PRNGKey(k), n), np.float32)
                for k, n in DRAWS}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    out = bench_problems()
    np.savez_compressed(args.out, source=np.asarray(SOURCE), **out)
    print(f"wrote {', '.join(f'{k} {v.shape}' for k, v in out.items())} to {os.path.relpath(args.out, REPO)}")


if __name__ == "__main__":
    main()
