"""Stage-2 ablation on the PyTorch port: RL budget and learning signal for DNN1.

scripts/ablate_rl.py on `learningagileflight_se3_torch`: from one fixed
pretrained DNN1, trains under several (grad_mode, epochs, lr schedule)
settings and scores each by open-loop policy quality on a held-out scenario
set: mean / median / min reward, inside-gate fraction, mean collision and
path terms (the reference's reward, quad_policy.py:85-90), through the
port's `policy.make_objective`.  The flags, variants and JSON keys are the
JAX script's; `--device` (the card by default) and `--horizon` are the
port's.  Per variant the training state is checkpointed every 20 epochs and
a rerun resumes it.  Writes <out>/ablation.json (after each variant), each
variant's DNN1 (`save_params` directory nn_deep_<name>) and learning curve
(curve_<name>.npy).

Usage: python3 scripts/torch_ablate_rl.py [--pretrain learningagileflight_se3_torch/weights/nn_pre_dnn1.npz]
       python3 scripts/torch_ablate_rl.py --device cpu --horizon 6 --batch 4 --eval-scenarios 4 \\
           --variants fd2,analytic2sched
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from learningagileflight_se3_torch.config import (  # noqa: E402
    CostWeights, QuadParams, RewardConfig, SamplerConfig, SolverConfig,
)
from learningagileflight_se3_torch.models.sampler import sample_scenarios, scenario_to_problem  # noqa: E402
from learningagileflight_se3_torch.policy import make_objective  # noqa: E402
from learningagileflight_se3_torch.train.rl import keyed_generator, run_rl_training  # noqa: E402
from learningagileflight_se3_torch.utils.checkpoint import save_params  # noqa: E402
from learningagileflight_se3_torch.utils.device import platform_line, resolve_device  # noqa: E402
from learningagileflight_se3_torch.utils.weights import NN_PRE_DNN1, load_dnn1  # noqa: E402


def parse_variant(name: str):
    """{fd|analytic}{epochs}[sched] -> (grad_mode, epochs, lr_schedule)."""
    sched = name.endswith("sched")
    base = name[:-5] if sched else name
    mode = "analytic" if base.startswith("analytic") else "fd"
    if not base.startswith(mode) or not base[len(mode):].isdigit():
        raise ValueError(f"variant {name!r} is not {{fd|analytic}}{{epochs}}[sched]")
    return mode, int(base[len(mode):]), sched


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pretrain", default=NN_PRE_DNN1, help="npz of the pretrained DNN1 (utils/weights.py)")
    ap.add_argument("--eval-scenarios", type=int, default=256)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="runs/torch_ablate_rl")
    ap.add_argument("--device", default="cuda", help="cuda (default; fails without a card) or cpu")
    ap.add_argument("--horizon", type=int, default=50)
    ap.add_argument("--variants", default="fd100,fd400sched,analytic400sched",
                    help="comma list of {fd|analytic}{epochs}[sched]")
    args = ap.parse_args(argv)
    variants = [(name, *parse_variant(name)) for name in args.variants.split(",")]
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(args.out, exist_ok=True)
    on_cpu = device.type == "cpu"
    solver_cfg = SolverConfig(horizon=args.horizon, max_iters=45,
                              tol=1e-9 if on_cpu else 1e-4, gtol=1e-7 if on_cpu else 3e-4)
    pq, cw, rc, sc = QuadParams(), CostWeights(), RewardConfig(), SamplerConfig()
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    # held-out open-loop evaluation: reward of the MPC plan under DNN1's
    # decision variables, on scenarios never seen in training
    obj = make_objective(pq, cw, solver_cfg, rc)
    scens = sample_scenarios(keyed_generator(device, args.seed + 991), args.eval_scenarios, sc)
    probs = scenario_to_problem(scens)

    def summarize(model):
        with torch.no_grad():
            outs = model.to(device)(scens)
            res = obj(probs["x0"], torch.zeros((scens.shape[0], 4), dtype=scens.dtype, device=device),
                      probs["goal_pos"], probs["gate_pts"], outs[:, 0:3], outs[:, 3:6], outs[:, 6])
        r = res.reward.cpu().numpy()
        return {
            "reward_mean": float(r.mean()),
            "reward_median": float(np.median(r)),
            "reward_min": float(r.min()),
            "inside_gate_frac": float(res.inside_gate.float().mean()),
            "collision_mean": float(res.collision.mean()),
            "path_mean": float(res.path.mean()),
        }

    meta = {"pretrain": os.path.relpath(args.pretrain, REPO), "batch": args.batch,
            "eval_scenarios": args.eval_scenarios, "platform": platform_line(device),
            "horizon": args.horizon, "torch": torch.__version__}

    def write():
        """<out>/ablation.json with the variants done so far."""
        record = {"meta": meta, "results": results}
        with open(os.path.join(args.out, "ablation.json"), "w") as f:
            json.dump(record, f, indent=2)
        return record

    results = {"pretrain": summarize(load_dnn1(args.pretrain))}
    print(f"[pretrain] {json.dumps(results['pretrain'])}", flush=True)

    for name, mode, epochs, sched in variants:
        sync()
        t0 = time.time()
        model, mrs, _ = run_rl_training(
            args.seed, load_dnn1(args.pretrain), epochs=epochs, batch_size=args.batch, params_q=pq,
            weights=cw, solver_cfg=solver_cfg, reward_cfg=rc, sampler_cfg=sc, grad_mode=mode,
            lr_schedule=sched, checkpoint_dir=os.path.join(args.out, f"state_{name}"),
            checkpoint_every=20, resume=True, device=device, log_fn=lambda *a: None)
        sync()
        res = summarize(model)
        res.update(train_s=time.time() - t0, train_reward_last=float(mrs[-1]) if mrs else float("nan"))
        results[name] = res
        save_params(os.path.join(args.out, f"nn_deep_{name}"), model)
        np.save(os.path.join(args.out, f"curve_{name}.npy"), np.asarray(mrs))
        print(f"[{name}] {json.dumps(res)}", flush=True)
        write()

    print(json.dumps(write()))
    return write()


if __name__ == "__main__":
    main()
