"""One warm-started MPC control query against the 10 Hz budget, on the port.

The PyTorch port's counterpart of benchmarks/bench_latency.py, on the CUDA card
(learningagileflight_se3_torch/benchmarks/latency.py; it raises where there is
no card).  Prints ONE JSON line with benchmarks/bench_latency.py's fields, plus the card's
nvidia-smi name ("platform") and power limit; diagnostics go to stderr.

Usage: python3 scripts/torch_bench_latency.py
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from learningagileflight_se3_torch.benchmarks import latency  # noqa: E402


def main():
    print(json.dumps(latency.run()))


if __name__ == "__main__":
    main()
