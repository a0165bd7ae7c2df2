"""Launch one of the port's kernels on the card, as a target for a kernel
profiler such as Nsight Compute.

The inputs are chip_smoke.py phase 3's: the solver's trajectories after 10
DDP iterations (ops/inputs.py main_path_inputs), f32, H=50; K3 runs on the
derivatives that ops/riccati_unfused.py derivatives_plain forms from K2's
inputs.  Making them runs the solver, so K1 and K2 are launched many times
before the launch of interest; that launch, one call of the kernel's
wrapper, is the one inside the NVTX range "launch".  Shared-memory bank
conflicts of K3 at B=2048:

    ncu --metrics l1tex__data_bank_conflicts_pipe_lsu_mem_shared_op_ld.sum,\\
l1tex__data_bank_conflicts_pipe_lsu_mem_shared_op_st.sum \\
        -k regex:riccati_unfused python3 scripts/launch_kernel.py --kernel K3 --batch 2048

For K1 or K2, select the launch by its range: `--nvtx --nvtx-include launch/`.

Usage: python3 scripts/launch_kernel.py --kernel K1|K2|K3 [--batch 2048]
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from learningagileflight_se3_torch.config import CostWeights, QuadParams, SolverConfig  # noqa: E402
from learningagileflight_se3_torch.ops import riccati_fused, riccati_unfused, rollout  # noqa: E402
from learningagileflight_se3_torch.ops.inputs import main_path_inputs  # noqa: E402

H = 50


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", required=True, choices=["K1", "K2", "K3"])
    ap.add_argument("--batch", type=int, default=2048)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("launch_kernel: no CUDA device")
    P, W, C = QuadParams(), CostWeights(), SolverConfig(horizon=H)
    k1, k2 = main_path_inputs(H, args.batch, device="cuda", iters=10)
    if args.kernel == "K1":
        a = [x.float() for x in k1]
        launch = lambda: rollout.rollout_forward(*a, P, W, C)
    elif args.kernel == "K2":
        a = [x.float() for x in k2]
        launch = lambda: riccati_fused.riccati_backward(*a, P, W, C)
    else:
        a = [x.float() for x in riccati_unfused.derivatives_plain(*k2, P, W, C)]
        launch = lambda: riccati_unfused.riccati_backward_unfused(*a, P, dt=C.dt, lb=C.u_lb, ub=C.u_ub)
    torch.cuda.synchronize()
    n = (rollout.launches, riccati_fused.launches, riccati_unfused.launches)
    torch.cuda.nvtx.range_push("launch")
    launch()
    torch.cuda.nvtx.range_pop()
    torch.cuda.synchronize()
    n = [b - a for a, b in zip(n, (rollout.launches, riccati_fused.launches, riccati_unfused.launches))]
    print(f"launch_kernel: {args.kernel} f32, H={H}, B={args.batch}: launches K1 {n[0]} K2 {n[1]} K3 {n[2]}")


if __name__ == "__main__":
    main()
