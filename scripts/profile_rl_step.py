"""Time and profile the stage-2 RL step of the PyTorch port on a CUDA card.

At the --full stage-2 settings of scripts/train_pipeline.py (DNN1 from
nn_pre, B=256, H=50, f32, SolverConfig(horizon=50, max_iters=45, tol=1e-4,
gtol=3e-4, no_progress_iters=10), Adam 1e-4), for the analytic and the fd
learning signal in turn:

  - the step's host time, synced, for each of --reps steps on fresh seeded
    scenarios (the first steps of a process warm up);
  - one more step under torch.profiler: its wall time, the number of device
    operations (kernels, copies, fills), the device's busy time (the union
    of their intervals) and busy share of the wall time, and the count and
    device time of K1 (rollout_kernel), K2 (riccati_fused_kernel) and the
    other kernels with the most device time.  The profiler's own host
    overhead inflates the wall time, so the busy share it gives is a floor.

Prints one line per measurement, then the card's nvidia-smi name and power
limit, then one JSON object with every number (also written to --out when
given).  Needs a CUDA device; imports nothing of JAX.

Usage: python3 scripts/profile_rl_step.py [--reps 3] [--out FILE]
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from learningagileflight_se3_torch.config import (  # noqa: E402
    CostWeights, QuadParams, RewardConfig, SolverConfig,
)
from learningagileflight_se3_torch.models.sampler import sample_scenarios  # noqa: E402
from learningagileflight_se3_torch.train.rl import make_rl_train_step  # noqa: E402
from learningagileflight_se3_torch.utils.weights import load_dnn1  # noqa: E402

B = 256
CFG = SolverConfig(horizon=50, max_iters=45, tol=1e-4, gtol=3e-4, no_progress_iters=10)
KERNELS = {"K1": "rollout_kernel", "K2": "riccati_fused_kernel"}


def busy_us(intervals):
    """Length of the union of [start, end) intervals, in their unit."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def profiled_step(step, scen):
    """One step under torch.profiler: wall time and device-side figures."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(scen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in ops]) * 1e-6
    by_name = defaultdict(lambda: [0, 0.0])
    for e in ops:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us() * 1e-3
    ours = {k: [0, 0.0] for k in KERNELS}
    for name, (n, ms) in by_name.items():
        for k, sub in KERNELS.items():
            if sub in name:
                ours[k][0] += n
                ours[k][1] += ms
    others = sorted(((ms, n, name) for name, (n, ms) in by_name.items()
                     if not any(sub in name for sub in KERNELS.values())), reverse=True)[:5]
    return dict(
        wall_s=wall, device_ops=len(ops), device_busy_s=busy, busy_share=busy / wall,
        kernels={k: dict(launches=n, device_ms=ms) for k, (n, ms) in ours.items()},
        top_other=[dict(name=name[:120], launches=n, device_ms=ms) for ms, n, name in others],
    )


def run(grad_mode, reps, model0, seed):
    dev = torch.device("cuda")
    model = copy.deepcopy(model0)
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)
    step = make_rl_train_step(model, opt, QuadParams(), CostWeights(), CFG, RewardConfig(),
                              grad_mode=grad_mode)
    scens = [sample_scenarios(torch.Generator(device=dev).manual_seed(seed + i), B)
             for i in range(reps + 1)]
    times = []
    for scen in scens[:reps]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = step(scen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        print(f"{grad_mode} step: {times[-1]:.4f} s (host, synced), mean reward "
              f"{float(res.mean_reward):.4f}, valid rows {float(res.valid.float().mean()):.4f}",
              flush=True)
    prof = profiled_step(step, scens[reps])
    print(f"{grad_mode} step under torch.profiler: wall {prof['wall_s']:.4f} s, "
          f"{prof['device_ops']} device operations, device busy {prof['device_busy_s']:.4f} s, "
          f"busy share {prof['busy_share']:.4f}; " +
          ", ".join(f"{k} {v['launches']} launches {v['device_ms']:.3f} ms"
                    for k, v in prof["kernels"].items()), flush=True)
    for o in prof["top_other"]:
        print(f"  {o['device_ms']:.3f} ms over {o['launches']} launches: {o['name']}", flush=True)
    return dict(step_s=times, profiled=prof)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=3, help="timed steps per signal")
    ap.add_argument("--seed", type=int, default=0, help="scenario seed")
    ap.add_argument("--out", default=None, help="also write the JSON summary here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_rl_step: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    model0 = load_dnn1().cuda()
    summary = dict(device=smi, torch=torch.__version__, cuda=torch.version.cuda, batch=B,
                   horizon=CFG.horizon, max_iters=CFG.max_iters)
    for grad_mode in ("analytic", "fd"):
        summary[grad_mode] = run(grad_mode, args.reps, model0, args.seed)
    print(smi)
    line = json.dumps(summary)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
