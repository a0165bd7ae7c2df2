"""Batched MPC solver throughput and quality at bench.py's operating point, on the port.

The PyTorch port's counterpart of bench.py, on the CUDA card
(learningagileflight_se3_torch/benchmarks/solve.py; it raises where there is
no card).  Prints ONE JSON line with bench.py's fields, plus the card's
nvidia-smi name ("platform") and power limit; diagnostics go to stderr.

Usage: python3 scripts/torch_bench.py
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from learningagileflight_se3_torch.benchmarks import solve  # noqa: E402


def main():
    print(json.dumps(solve.run()))


if __name__ == "__main__":
    main()
