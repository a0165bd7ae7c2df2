"""Weak scaling over the cards present and the multi-process rows, on the port.

The PyTorch port's counterpart of benchmarks/bench_scaling.py, on the CUDA card
(learningagileflight_se3_torch/benchmarks/scaling.py; it raises where there is
no card).  Prints ONE JSON line with benchmarks/bench_scaling.py's fields, plus the card's
nvidia-smi name ("platform") and power limit; diagnostics go to stderr.

Usage: python3 scripts/torch_bench_scaling.py
(ranks' logs under runs/torch_bench_scaling/)
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from learningagileflight_se3_torch.benchmarks import scaling  # noqa: E402


def main():
    print(json.dumps(scaling.run()))


if __name__ == "__main__":
    main()
