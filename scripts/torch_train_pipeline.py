"""The three training stages and the closed-loop evaluation, on the PyTorch port.

scripts/train_pipeline.py's run order on `learningagileflight_se3_torch`:
  stage 1  supervised pretraining of DNN1          (train/pretrain.py)
  stage 2  differentiable-MPC RL of DNN1           (train/rl.py)
  stage 3  imitation of DNN1's MPC rollouts, DNN2  (train/imitation.py)
  eval     DNN2 flown through the moving gate      (sim/closed_loop.py)

Runs on the CUDA card unless --device cpu.  With LAF_NUM_PROCESSES > 1 (and
LAF_COORDINATOR_ADDRESS, LAF_PROCESS_ID: parallel/distributed.py) stage 2
runs data-parallel over the processes, one per card (scripts/train_pipeline.py's
mesh); every process runs every stage, and those other than rank 0 write
under runs/<tag>/rank<r>/.  Artifacts land in runs/<tag>/:
`save_params` directories nn_pre, nn_deep and nn3_1, the stage-2 training
state, the learning curves (.npy), the 8 closed-loop logs of the first
evaluation scenario, its position and input plots (where matplotlib is
installed) and summary.json.  Each stage is timed (utils/profiling.py
StageTimer; the report closes the run), and --profile-dir writes a
torch.profiler trace of the whole run there.

Usage:
  python3 scripts/torch_train_pipeline.py                 # mini demo scale
  python3 scripts/torch_train_pipeline.py --full          # paper-scale budgets: 3000 pretrain steps of
        # 256, 400 RL epochs of 256, 600 imitation epochs of 64 scenarios and 10 passes, 2 restarts
  python3 scripts/torch_train_pipeline.py --device cpu --horizon 10 --max-iters 12 \\
      --pretrain-steps 20 --rl-epochs 1 --rl-batch 8 --imitation-epochs 1 --sim-steps 100 --tag verify
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from learningagileflight_se3_torch.config import (  # noqa: E402
    CostWeights,
    QuadParams,
    RewardConfig,
    SamplerConfig,
)
from learningagileflight_se3_torch.models.sampler import sample_scenarios  # noqa: E402
from learningagileflight_se3_torch.parallel.distributed import initialize_distributed  # noqa: E402
from learningagileflight_se3_torch.parallel.mesh import make_mesh  # noqa: E402
from learningagileflight_se3_torch.sim.bench import solver_config  # noqa: E402
from learningagileflight_se3_torch.sim.closed_loop import (  # noqa: E402
    evaluate_closed_loop,
    make_closed_loop_sim,
)
from learningagileflight_se3_torch.train.imitation import run_imitation_training  # noqa: E402
from learningagileflight_se3_torch.train.pretrain import evaluate_pretrain, run_pretraining  # noqa: E402
from learningagileflight_se3_torch.train.rl import keyed_generator, run_rl_training  # noqa: E402
from learningagileflight_se3_torch.utils.checkpoint import save_params  # noqa: E402
from learningagileflight_se3_torch.utils.device import resolve_device  # noqa: E402
from learningagileflight_se3_torch.utils.profiling import StageTimer, device_trace  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default; fails without a card) or cpu")
    ap.add_argument("--tag", default=None)
    ap.add_argument("--full", action="store_true", help="paper-scale budgets")
    ap.add_argument("--grad", default="analytic", choices=["fd", "analytic"],
                    help="stage-2 learning signal")
    ap.add_argument("--pretrain-steps", type=int, default=None)
    ap.add_argument("--rl-epochs", type=int, default=None)
    ap.add_argument("--rl-batch", type=int, default=None)
    ap.add_argument("--imitation-epochs", type=int, default=None)
    ap.add_argument("--imitation-restarts", type=int, default=None,
                    help="stage-3 restarts; the DNN2 with the best closed-loop success on an "
                         "independent selection set is kept (default 2 with --full, else 1)")
    ap.add_argument("--horizon", type=int, default=50)
    ap.add_argument("--max-iters", type=int, default=45)
    ap.add_argument("--sim-steps", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", action="store_true",
                    help="resume stage 2 from runs/<tag>/rl_state if present")
    ap.add_argument("--window-frame", action=argparse.BooleanOptionalAction, default=True,
                    help="train DNN2 on window-frame states (--no-window-frame: the reference's "
                         "world-frame training)")
    ap.add_argument("--consistent-labels", action="store_true",
                    help="with --window-frame: also map the teacher's traversal pose into the window frame")
    ap.add_argument("--imitation-lr", type=float, default=1e-3, help="stage-3 lr (cosine-decayed)")
    ap.add_argument("--rl-sched", action=argparse.BooleanOptionalAction, default=True,
                    help="cosine-decay the stage-2 lr over the run")
    ap.add_argument("--eval-scenarios", type=int, default=64,
                    help="closed-loop evaluation scenario count (success rate)")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace of the run (trace.json) to this directory")
    args = ap.parse_args()

    device = resolve_device(args.device)
    # stage 2 data-parallel over the LAF_* processes (scripts/train_pipeline.py's mesh)
    mesh = None
    if int(os.environ.get("LAF_NUM_PROCESSES", "1")) > 1:
        initialize_distributed(device=device)
        mesh = make_mesh(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    platform = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    tag = args.tag or time.strftime("%Y%m%d-%H%M%S")
    rundir = os.path.join("runs", tag)
    # every rank runs every stage; ranks other than 0 keep their artifacts apart
    outdir = rundir if mesh is None or mesh.rank == 0 else os.path.join(rundir, f"rank{mesh.rank}")
    os.makedirs(outdir, exist_ok=True)
    print(f"[pipeline] device={platform} outdir={outdir}", flush=True)

    solver_cfg = solver_config(device, args.horizon, args.max_iters)
    pq, cw, rc, sc = QuadParams(), CostWeights(), RewardConfig(), SamplerConfig()
    if args.full:
        pretrain_steps = args.pretrain_steps or 3000
        rl_epochs = args.rl_epochs or 400
        rl_batch = args.rl_batch or 256
        imi_epochs = args.imitation_epochs or 600
    else:
        pretrain_steps = args.pretrain_steps or 300
        rl_epochs = args.rl_epochs or 5
        rl_batch = args.rl_batch or 32
        imi_epochs = args.imitation_epochs or 5
    # one seed per stage and draw, all from --seed
    seeds = [int(s) for s in np.random.SeedSequence(args.seed).generate_state(8)]
    timer = StageTimer()
    stage_s = timer.totals
    trace_ctx = device_trace(args.profile_dir)
    trace_ctx.__enter__()

    def timed(name, fn):
        sync()
        with timer(name):
            out = fn()
            sync()
        return out

    # ---------------- stage 1: supervised pretraining ----------------------
    model1, pre_losses = timed("stage1:pretrain", lambda: run_pretraining(
        seeds[0], steps=pretrain_steps, batch_size=256, sampler_cfg=sc,
        log_every=max(1, pretrain_steps // 10), device=device))
    pre_mse = evaluate_pretrain(model1, keyed_generator(device, seeds[1]), sampler_cfg=sc)
    print(f"[stage1] {stage_s['stage1:pretrain']:.1f}s  eval MSE {pre_mse:.5f}", flush=True)
    save_params(os.path.join(outdir, "nn_pre"), model1)
    np.save(os.path.join(outdir, "pretrain_loss.npy"), np.asarray(pre_losses))

    # ---------------- stage 2: differentiable-MPC RL -----------------------
    model1, mean_rewards, _ = timed("stage2:rl", lambda: run_rl_training(
        seeds[2], model1, epochs=rl_epochs, batch_size=rl_batch, params_q=pq, weights=cw,
        solver_cfg=solver_cfg, reward_cfg=rc, sampler_cfg=sc, grad_mode=args.grad,
        lr_schedule=args.rl_sched, checkpoint_dir=os.path.join(rundir, "rl_state"),
        resume=args.resume, device=device, mesh=mesh))
    if not mean_rewards:  # a resumed run that had already finished
        mean_rewards = [float("nan")]
    print(f"[stage2] {stage_s['stage2:rl']:.1f}s  mean reward "
          f"{mean_rewards[0]:.2f} -> {mean_rewards[-1]:.2f}", flush=True)
    save_params(os.path.join(outdir, "nn_deep"), model1)
    np.save(os.path.join(outdir, "Mean_Reward.npy"), np.asarray(mean_rewards))
    np.save(os.path.join(outdir, "Iteration.npy"), np.arange(1, len(mean_rewards) + 1))

    # ---------------- stage 3: DNN2 imitation ------------------------------
    # restart selection: train `restarts` DNN2s from independent seeds and keep
    # the one with the best closed-loop success on a selection set drawn
    # independently of the final evaluation
    restarts = args.imitation_restarts or (2 if args.full else 1)
    n_sel = 32
    sel_scens = sample_scenarios(keyed_generator(device, seeds[3]), n_sel, sc)

    def fly(model2, scens, seed):
        sim = make_closed_loop_sim(model2, pq, cw, solver_cfg, steps=args.sim_steps, device=device)
        trace = sim(scens, generator=keyed_generator(device, seed))
        return trace, evaluate_closed_loop(trace, scens[:, 3:6])

    def stage3():
        best, rates = None, []
        for r in range(restarts):
            model2, losses = run_imitation_training(
                seeds[5] + r, model1, epochs=imi_epochs, batch_scenarios=64 if args.full else 16,
                sgd_passes=10 if args.full else 4, lr=args.imitation_lr, lr_schedule=True,
                params_q=pq, weights=cw, solver_cfg=solver_cfg, sampler_cfg=sc,
                window_frame=args.window_frame, consistent_labels=args.consistent_labels, device=device)
            rate = float("nan")
            if restarts > 1:
                rate = float(fly(model2, sel_scens, seeds[4])[1][0].float().mean())
            rates.append(rate)
            print(f"[stage3] restart {r}: loss {losses[-1]:.5f} selection success {rate:.3f}", flush=True)
            if best is None or (restarts > 1 and rate > best[0]):
                best = (rate, model2, losses)
        return best[1], best[2], rates

    model2, imi_losses, sel_rates = timed("stage3:imitation", stage3)
    print(f"[stage3] {stage_s['stage3:imitation']:.1f}s  loss {imi_losses[0]:.4f} -> "
          f"{imi_losses[-1]:.4f}  (kept best of {restarts}: {sel_rates})", flush=True)
    save_params(os.path.join(outdir, "nn3_1"), model2)
    np.save(os.path.join(outdir, "imitation_loss.npy"), np.asarray(imi_losses))

    # ---------------- closed-loop evaluation -------------------------------
    n_eval = max(1, args.eval_scenarios)
    scens = sample_scenarios(keyed_generator(device, seeds[6]), n_eval, sc)
    trace, (travs, margins, final_ds) = timed("eval:closed_loop", lambda: fly(model2, scens, seeds[7]))
    travs, margins, final_ds = (a.cpu().numpy() for a in (travs, margins, final_ds))
    success_rate = float(travs.astype(bool).mean())
    print(f"[eval] {stage_s['eval:closed_loop']:.1f}s  success {success_rate:.2f} over {n_eval} "
          f"scenarios; scenario0 traversed={bool(travs[0])} margin={float(margins[0]):.3f} "
          f"final_dist={float(final_ds[0]):.3f}", flush=True)
    # the reference's 8 logs, of the first scenario
    for name, field in (("gate_move_traj", "gate_moves"), ("uav_traj", "states"), ("uav_ctrl", "controls"),
                        ("abs_tra_time", "abs_tra_times"), ("tra_time", "tra_times"), ("Time", "times"),
                        ("Pitch", "pitches"), ("HL_Variable", "hl_variables")):
        np.save(os.path.join(outdir, name + ".npy"), getattr(trace, field)[0].cpu().numpy())
    if importlib.util.find_spec("matplotlib") is not None:
        from learningagileflight_se3_torch.sim import plotting

        plotting.plot_position(trace.states[0].cpu().numpy(), dt=0.01, path=os.path.join(outdir, "position.png"))
        plotting.plot_input(trace.controls[0].cpu().numpy(), dt=0.01, path=os.path.join(outdir, "input.png"))

    summary = {
        "pretrain_eval_mse": pre_mse,
        "rl_mean_reward_first": mean_rewards[0],
        "rl_mean_reward_last": mean_rewards[-1],
        "imitation_loss_last": imi_losses[-1],
        "closed_loop_traversed": bool(travs[0]),
        "closed_loop_margin": float(margins[0]),
        "closed_loop_final_dist": float(final_ds[0]),
        "closed_loop_success_rate": success_rate,
        "closed_loop_eval_scenarios": n_eval,
        "closed_loop_mean_final_dist": float(final_ds.mean()),
        "window_frame": bool(args.window_frame),
        "consistent_labels": bool(args.consistent_labels),
        "rl_grad_mode": args.grad,
        "rl_epochs": rl_epochs,
        "imitation_epochs": imi_epochs,
        "imitation_restarts": restarts,
        "imitation_selection_success": sel_rates,
        "platform": platform,
        "n_devices": 1 if mesh is None else mesh.world,
        "stage_seconds": stage_s,
    }
    trace_ctx.__exit__(None, None, None)
    timer.report()
    with open(os.path.join(outdir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(f"[pipeline] done: {json.dumps(summary)}", flush=True)
    if mesh is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
