"""Where the omega-box continuation's kernel path and plain path part.

The flagship scenario of tests/test_oracle_lifted.py (H=50, max_iters=300
by default, the default ladder 10 .. 1e6) through solver/constrained.py in float64 on
`--device`, on the kernels (K1, K2).  For every stage it prints the cost,
the largest omega violation, the iterations and exit, and from a watcher
on the solver's kernel calls the sweeps, the sweeps that failed the pivot
test and the line-search trips.  Then the last stage is solved again from
the same warm start (the kernel path's previous stage) with the plain
versions patched into the solver in place of the kernels, on the same
device, and, on the kernel path's own inputs of every K2 call of the last
stage, K2 is held against its plain version: the calls whose fail flag
differs and the largest relative differences of the gains.

Usage: python3 scripts/continuation_paths.py [--device cuda] [--out FILE.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from learningagileflight_se3_torch.config import CostWeights, QuadParams, SolverConfig  # noqa: E402
from learningagileflight_se3_torch.core.rotations import axis_angle_to_quat  # noqa: E402
from learningagileflight_se3_torch.ops import riccati_fused, rollout  # noqa: E402
from learningagileflight_se3_torch.solver import ilqr_batched  # noqa: E402
from learningagileflight_se3_torch.solver.constrained import DEFAULT_LADDER, make_w_bounded_solver  # noqa: E402
from learningagileflight_se3_torch.solver.ilqr import make_batched_mpc_solver  # noqa: E402
from learningagileflight_se3_torch.solver.watch import watched_kernels  # noqa: E402
from learningagileflight_se3_torch.utils.device import resolve_device  # noqa: E402


def flagship(device, dtype=torch.float64):
    """tests/test_oracle_lifted.py canonical_args, as a batch of one."""
    kw = dict(dtype=dtype, device=device)
    x0 = torch.zeros((1, 13), **kw)
    x0[0, 1] = -8.0
    x0[0, 6:10] = axis_angle_to_quat(torch.tensor(0.0, **kw), torch.tensor([3.0, 3.0, 5.0], **kw))
    return (x0, torch.zeros((1, 4), **kw), torch.tensor([[0.0, 8.0, 0.0]], **kw), torch.zeros((1, 3), **kw),
            torch.tensor([[0.0, 0.6, 0.0]], **kw), torch.tensor([3.0], **kw))


def rel_err(a, b):
    """max |a-b| / (|b| + 1e-2) over entries finite in both."""
    a, b = a.double(), b.double()
    both = torch.isfinite(a) & torch.isfinite(b)
    return float(((a - b).abs() / (b.abs() + 1e-2))[both].max()) if bool(both.any()) else 0.0


def summary(sol, cfg, counts=None):
    viol = float(torch.clamp_min(sol.state_traj[0, :, 10:13].abs() - cfg.w_bound, 0.0).max())
    out = dict(cost=float(sol.cost[0]), violation=viol, iterations=int(sol.iterations[0]),
               status=int(sol.status[0]), reg_final=float(sol.reg_final[0]))
    return {**out, **(counts or {})}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--horizon", type=int, default=50)
    ap.add_argument("--max-iters", type=int, default=300)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    P, W = QuadParams(), CostWeights()
    cfg = SolverConfig(horizon=args.horizon, max_iters=args.max_iters)
    problem = flagship(device)
    counts = []

    def on_call(kind, solve, iteration, trip, a, kw, out):
        while len(counts) <= solve:
            counts.append(dict(sweeps=0, failed_sweeps=0, trips=0))
        if kind == "K2":
            counts[solve]["sweeps"] += 1
            counts[solve]["failed_sweeps"] += int(out[4].sum())
        elif kind == "K1":
            counts[solve]["trips"] += 1

    t0 = time.perf_counter()
    with watched_kernels(on_call):
        sols = make_w_bounded_solver(P, W, cfg)(*problem, all_stages=True)
    report = {"device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
              "kernel_path": [dict(rho=rho, **summary(s, cfg, c)) for rho, s, c in zip(DEFAULT_LADDER, sols, counts)],
              "kernel_path_seconds": time.perf_counter() - t0}
    for row in report["kernel_path"]:
        print(json.dumps(row), flush=True)

    # the last stage again from the same warm start, on the plain versions
    last = dataclasses.replace(cfg, w_bound_weight=DEFAULT_LADDER[-1])
    warm = sols[-2].control_traj
    real = ilqr_batched.rollout_forward, ilqr_batched.riccati_backward
    ilqr_batched.rollout_forward = rollout.rollout_forward_plain
    ilqr_batched.riccati_backward = riccati_fused.riccati_backward_plain
    try:
        t0 = time.perf_counter()
        plain = make_batched_mpc_solver(P, W, last)(*problem, U_init=warm)
        report["plain_last_stage"] = dict(rho=DEFAULT_LADDER[-1], **summary(plain, cfg),
                                          seconds=time.perf_counter() - t0)
    finally:
        ilqr_batched.rollout_forward, ilqr_batched.riccati_backward = real
    print(json.dumps({"plain_last_stage": report["plain_last_stage"]}), flush=True)

    # K2 against its plain version at every sweep of the kernel path's last stage
    calls = []

    def compare(kind, solve, iteration, trip, a, kw, out):
        if kind != "K2":
            return
        ref = riccati_fused.riccati_backward_plain(*a, **kw)
        calls.append(dict(iteration=iteration, fail=bool(out[4][0]), fail_plain=bool(ref[4][0]),
                          kk=rel_err(out[0], ref[0]), KK=rel_err(out[1], ref[1]),
                          dV1=rel_err(out[2], ref[2]), dV2=rel_err(out[3], ref[3])))

    with watched_kernels(compare):
        again = make_batched_mpc_solver(P, W, last)(*problem, U_init=warm)
    differ = [c["iteration"] for c in calls if c["fail"] != c["fail_plain"]]
    worst = {k: max((c[k] for c in calls if not c["fail"]), default=0.0) for k in ("kk", "KK", "dV1", "dV2")}
    report["last_stage_k2_vs_plain"] = dict(
        sweeps=len(calls), failed=sum(c["fail"] for c in calls), fail_differs_at=differ,
        max_rel_err_on_unfailed_sweeps=worst, same_result=summary(again, cfg) == summary(sols[-1], cfg))
    print(json.dumps({"last_stage_k2_vs_plain": report["last_stage_k2_vs_plain"]}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(report, last_stage_calls=calls), f, indent=1)


if __name__ == "__main__":
    main()
