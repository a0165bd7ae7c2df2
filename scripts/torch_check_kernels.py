"""The kernel path (CUDA) against the plain path (CPU) at convergence, on the port.

The PyTorch port's counterpart of benchmarks/check_pallas_tpu.py, on the CUDA card
(learningagileflight_se3_torch/benchmarks/kernel_check.py; it raises where there is
no card).  Prints ONE JSON line with benchmarks/check_pallas_tpu.py's fields, plus the card's
nvidia-smi name ("platform") and power limit; diagnostics go to stderr.

Usage: python3 scripts/torch_check_kernels.py
Exits 1 when the agreement fails, as check_pallas_tpu.py does.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from learningagileflight_se3_torch.benchmarks import kernel_check  # noqa: E402


def main():
    out = kernel_check.run()
    print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
