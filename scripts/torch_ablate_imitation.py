"""Stage-3 ablation on the PyTorch port: which imitation frame makes the deployed pipeline fly?

scripts/ablate_imitation.py on `learningagileflight_se3_torch`: trains DNN2
from one fixed RL'd DNN1 under three label / input frames and flies each
through the port's batched closed loop (`sim/closed_loop.py`, the moving
gate, 10 Hz replanning) on held-out scenarios:

  world              world-frame inputs, world-frame labels (the reference's
                     exercised behaviour)
  window             window-frame inputs, world-frame labels
  window_consistent  window-frame inputs and labels (the traversal pose
                     mapped through gate_frame)

The flags, variants and JSON keys are the JAX script's; `--device` (the
card by default) and `--horizon` are the port's.  Writes
<out>/ablation.json (after each variant) and each variant's DNN2
(`save_params` directory nn3_<name>).

Usage: python3 scripts/torch_ablate_imitation.py [--dnn1 learningagileflight_se3_torch/weights/nn_deep_dnn1.npz]
       python3 scripts/torch_ablate_imitation.py --device cpu --horizon 6 --epochs 2 --batch-scenarios 4 \\
           --sgd-passes 2 --eval-scenarios 4 --sim-steps 20
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import zlib

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from learningagileflight_se3_torch.config import (  # noqa: E402
    CostWeights, QuadParams, SamplerConfig, SolverConfig,
)
from learningagileflight_se3_torch.models.sampler import sample_scenarios  # noqa: E402
from learningagileflight_se3_torch.sim.closed_loop import evaluate_closed_loop, make_closed_loop_sim  # noqa: E402
from learningagileflight_se3_torch.train.imitation import run_imitation_training  # noqa: E402
from learningagileflight_se3_torch.train.rl import keyed_generator  # noqa: E402
from learningagileflight_se3_torch.utils.checkpoint import save_params  # noqa: E402
from learningagileflight_se3_torch.utils.device import platform_line, resolve_device  # noqa: E402
from learningagileflight_se3_torch.utils.weights import NN_DEEP_DNN1, load_dnn1  # noqa: E402

FRAMES = {
    "world": dict(window_frame=False, consistent_labels=False),
    "window": dict(window_frame=True, consistent_labels=False),
    "window_consistent": dict(window_frame=True, consistent_labels=True),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dnn1", default=NN_DEEP_DNN1, help="npz of the RL'd DNN1 (utils/weights.py)")
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--batch-scenarios", type=int, default=64)
    ap.add_argument("--sgd-passes", type=int, default=10)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--eval-scenarios", type=int, default=32)
    ap.add_argument("--sim-steps", type=int, default=500)
    ap.add_argument("--max-iters", type=int, default=45)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="runs/torch_ablate_imitation")
    ap.add_argument("--device", default="cuda", help="cuda (default; fails without a card) or cpu")
    ap.add_argument("--horizon", type=int, default=50)
    ap.add_argument("--variants", default="world,window,window_consistent")
    args = ap.parse_args(argv)
    names = args.variants.split(",")
    if set(names) - set(FRAMES):
        raise ValueError(f"unknown variants {sorted(set(names) - set(FRAMES))}; known: {list(FRAMES)}")
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(args.out, exist_ok=True)
    on_cpu = device.type == "cpu"
    solver_cfg = SolverConfig(horizon=args.horizon, max_iters=args.max_iters,
                              tol=1e-9 if on_cpu else 1e-4, gtol=1e-7 if on_cpu else 3e-4)
    pq, cw, sc = QuadParams(), CostWeights(), SamplerConfig()
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    model1 = load_dnn1(args.dnn1)

    scens = sample_scenarios(keyed_generator(device, args.seed, 1), args.eval_scenarios, sc)
    meta = {"dnn1": os.path.relpath(args.dnn1, REPO), "epochs": args.epochs, "lr": args.lr,
            "batch_scenarios": args.batch_scenarios, "sgd_passes": args.sgd_passes,
            "eval_scenarios": args.eval_scenarios, "platform": platform_line(device),
            "horizon": args.horizon, "sim_steps": args.sim_steps, "torch": torch.__version__}
    results = {}

    def write():
        """<out>/ablation.json with the variants done so far."""
        record = {"meta": meta, "results": results}
        with open(os.path.join(args.out, "ablation.json"), "w") as f:
            json.dump(record, f, indent=2)
        return record

    for name in names:
        # crc32, not hash(): Python's str hash is salted per process
        seed_t = int(np.random.SeedSequence([args.seed, zlib.crc32(name.encode()) % 2**30])
                     .generate_state(1)[0])
        sync()
        t0 = time.time()
        model2, losses = run_imitation_training(
            seed_t, model1, epochs=args.epochs, batch_scenarios=args.batch_scenarios,
            sgd_passes=args.sgd_passes, lr=args.lr, lr_schedule=True, params_q=pq, weights=cw,
            solver_cfg=solver_cfg, sampler_cfg=sc, device=device, log_fn=lambda *a: None,
            **FRAMES[name])
        sync()
        train_s = time.time() - t0

        sim = make_closed_loop_sim(model2, pq, cw, solver_cfg, steps=args.sim_steps, device=device)
        t0 = time.time()
        trace = sim(scens, generator=keyed_generator(device, args.seed, 2))
        travs, margins, fds = (a.cpu().numpy() for a in evaluate_closed_loop(trace, scens[:, 3:6]))
        res = {
            "loss_first": float(losses[0]),
            "loss_last": float(losses[-1]),
            "success_rate": float(travs.astype(bool).mean()),
            "mean_margin": float(margins.mean()),
            "median_final_dist": float(np.median(fds)),
            "mean_final_dist": float(fds.mean()),
            "train_s": train_s,
            "eval_s": time.time() - t0,
        }
        results[name] = res
        save_params(os.path.join(args.out, f"nn3_{name}"), model2)
        print(f"[{name}] {json.dumps(res)}", flush=True)
        write()

    print(json.dumps(write()))
    return write()


if __name__ == "__main__":
    main()
