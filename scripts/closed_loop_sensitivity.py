"""How far a rounding-level difference in K2's outputs carries through the closed loop.

The CPU plain path of `learningagileflight_se3_torch` flies the first
scenarios of an exported benchmark seed twice in float64 at the flight's
solver settings (H=50, max_iters=45, tol=1e-4, gtol=3e-4,
no_progress_iters=10): once as it is, once with every output of the backward
sweep multiplied by 1 + eps * N(0,1).  eps = 1e-13 is about the difference
between the CUDA kernels and their plain versions in float64, so the table
is what a comparison of the kernel path with the plain path has to expect
from the solver alone: per lane the replans' iteration counts of both runs
and the largest state difference after each replan, then how many lanes kept
their iteration counts and how far those lanes moved.

Runs on the CPU (about a second a DDP iteration; 16 lanes x 60 steps take
some 6 minutes for the two flights).

Usage: python3 scripts/closed_loop_sensitivity.py [--lanes 16] [--offset 0]
           [--steps 60] [--eps 1e-13] [--seed 2024]
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from learningagileflight_se3_torch.sim.bench import flight_solver_config  # noqa: E402
from learningagileflight_se3_torch.sim.closed_loop import make_closed_loop_sim  # noqa: E402
from learningagileflight_se3_torch.solver import ilqr_batched  # noqa: E402
from learningagileflight_se3_torch.utils.weights import (  # noqa: E402
    bench_scenarios,
    bench_scenarios_path,
    load_dnn2,
)


def fly(scen, noise, steps, eps):
    """The closed loop's log on the CPU in float64, K2's outputs perturbed by eps."""
    plain = ilqr_batched.riccati_backward
    gen = torch.Generator().manual_seed(7)

    def perturbed(*a, **kw):
        return tuple(o * (1 + eps * torch.randn(o.shape, generator=gen, dtype=o.dtype))
                     if o.is_floating_point() else o for o in plain(*a, **kw))

    if eps > 0:
        ilqr_batched.riccati_backward = perturbed
    try:
        sim = make_closed_loop_sim(load_dnn2(), solver_cfg=flight_solver_config(), steps=steps,
                                   device="cpu", dtype=torch.float64)
        return sim(scen, gate_noise=noise[:, :steps])
    finally:
        ilqr_batched.riccati_backward = plain


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lanes", type=int, default=16)
    ap.add_argument("--offset", type=int, default=0, help="the first scenario of the file to fly")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--eps", type=float, default=1e-13)
    ap.add_argument("--seed", type=int, default=2024, help="an exported benchmark seed")
    args = ap.parse_args()

    scen, noise = bench_scenarios(bench_scenarios_path(args.seed))
    lanes = slice(args.offset, args.offset + args.lanes)
    a = fly(scen[lanes], noise[lanes], args.steps, 0.0)
    b = fly(scen[lanes], noise[lanes], args.steps, args.eps)
    ia, ib = a.solver_iters[:, ::10], b.solver_iters[:, ::10]
    d = (a.states - b.states).abs().amax(dim=2)  # (lanes, steps + 1)
    for lane in range(ia.shape[0]):
        after = [f"{float(d[lane, :10 * (k + 1) + 1].max()):.0e}" for k in range(ia.shape[1])]
        print(lane + args.offset, ia[lane].tolist(), ib[lane].tolist(), after)
    same, worst = (ia == ib).all(dim=1), d.amax(dim=1)
    print(f"{int(same.sum())} of {same.numel()} lanes kept their iteration counts: of these "
          f"{int((worst[same] <= 1e-6).sum())} within 1e-6, median {float(worst[same].median()):.3e}; of all lanes "
          f"{int((worst <= 1e-6).sum())} within 1e-6, max {float(worst.max()):.3e}")


if __name__ == "__main__":
    main()
