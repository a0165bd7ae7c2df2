"""Real time and quality at one operating point, on the port: the 10 Hz
tick and the closed-loop success rate.

The PyTorch port's counterpart of benchmarks/bench_realtime.py, on the CUDA card
(learningagileflight_se3_torch/benchmarks/realtime.py; it raises where there is
no card).  Prints ONE JSON line with benchmarks/bench_realtime.py's fields, plus the card's
nvidia-smi name ("platform") and power limit; diagnostics go to stderr.

Usage: python3 scripts/torch_bench_realtime.py [--n 128] [--steps 500]
           [--latency-trajectories 2] [--skip-success] [--max-iters 30]
Exits 1 when not ok (tick p90 under 0.1 s and success at least 0.95), as
bench_realtime.py does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from learningagileflight_se3_torch.benchmarks import realtime  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=128, help="success-eval scenario count (bench_success protocol)")
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--latency-trajectories", type=int, default=2,
                    help="host-driven closed-loop trajectories timed tick by tick")
    ap.add_argument("--skip-success", action="store_true", help="latency part only (development)")
    ap.add_argument("--max-iters", type=int, default=30,
                    help="DDP iteration cap of the operating point (both the ticks and the success eval use it)")
    args = ap.parse_args(argv)
    out = realtime.run(n=args.n, steps=args.steps, latency_trajectories=args.latency_trajectories,
                       skip_success=args.skip_success, max_iters=args.max_iters)
    print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
