"""Cold-start control MAE of the card's f64 solve against the lifted-NLP
oracle, on the port.

The PyTorch port's counterpart of benchmarks/bench_accuracy.py, on the CUDA card
(learningagileflight_se3_torch/benchmarks/accuracy.py; it raises where there is
no card).  Prints ONE JSON line with benchmarks/bench_accuracy.py's fields, plus the card's
nvidia-smi name ("platform") and power limit; diagnostics go to stderr.

Usage: python3 scripts/torch_bench_accuracy.py [--n-per-cell 8]
The oracles run on the host, one process per problem, as many at once as
the host has cores (48 to 350 s of one core each).  Exits 1 when not ok,
as bench_accuracy.py does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from learningagileflight_se3_torch.benchmarks import accuracy  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-per-cell", type=int, default=8, help="scenarios per (variant x regime) cell; 4 cells")
    args = ap.parse_args(argv)
    out = accuracy.run(n_per_cell=args.n_per_cell)
    print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
