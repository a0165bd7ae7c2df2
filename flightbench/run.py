"""Run one cell of BENCHMARK.json on the card and print its result line.

    python3 flightbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  See flightbench/harness.py.
"""

import time

T_START = time.perf_counter()  # set-up is timed from here: imports, CUDA, build, captures, warm-up

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    # every kernel cache of the program at a fixed place inside the checkout
    # (the kernels' nvcc build already lands in build/kernels/)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "flightbench", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "flightbench", "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    # one host thread for PyTorch's CPU work: idle worker threads spinning on
    # the machine's shared cores slow the one thread that feeds the card
    os.environ["OMP_NUM_THREADS"] = "1"
    # the checkout's root, not this script's folder, on the import path
    sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") not in (HERE, ROOT)]
    from flightbench.harness import main as run

    return run(argv, T_START)


if __name__ == "__main__":
    sys.exit(main())
