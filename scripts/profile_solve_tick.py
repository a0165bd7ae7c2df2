"""Profile the PyTorch port's batched solve, deployment tick, closed loop and
imitation epoch on a CUDA card.

  - The batched solve at the bench.py point (B=2048, H=50, f32,
    SolverConfig(horizon=50, max_iters=60, tol=1e-4, gtol=3e-4,
    ls_adaptive=True, ls_max_trips=4, no_progress_iters=10)) on seeded
    scenarios: the host time and host syncs of --reps solves, synced (the
    DDP loop as a replayed CUDA graph, solver/ilqr_batched.py), then one
    more solve under torch.profiler, and the same solve on the eager
    loop (the host loops) under torch.profiler.
  - The 10 Hz tick at the deployed budget (PYBULLET, H=50, max_iters=30,
    secant traversal-time solver, f32, B=1) replaying
    artifacts/replay_contract.npz: one warm-up pass, one timed pass (per-tick
    host time, each tick ending in its host fetch; the host reads over the
    pass), one pass under torch.profiler (each pass on a controller made,
    and its tick graph captured, before it).
  - The closed loop (--path closed_loop): the nn3_1 DNN2 through the 128
    exported scenarios of seed 2024 x 500 steps at the accelerator settings
    of scripts/torch_bench_success.py (f32, H=50, max_iters=45), timed twice,
    with the host time of its parts (t-solver, replans, the rest) from a
    third flight on the eager step loop whose parts are synced; then the
    first 100 steps (10 replans) under torch.profiler.
  - The imitation epoch (--path imitation) at the --full width (64 scenarios,
    H=50, 10 passes, window frame, from nn_deep): 3 timed epochs' collect and
    passes, then one epoch under torch.profiler.

Each part runs in a process of its own when several are asked for, and
each profiles graphs captured before its torch.profiler session starts.
Each profiled run reports its wall time, the number of device operations,
the device's busy time and busy share (a floor: the profiler's own host
overhead inflates the wall time), and the launches and device time of K1
(rollout_kernel), K2 (riccati_fused_kernel) and the other kernels with the
most device time.  Prints one line per measurement, the card's nvidia-smi
name and power limit, then one JSON object (also written to --out).

Usage: python3 scripts/profile_solve_tick.py [--path solve,tick] [--reps 3] [--out FILE]
       (--path: any of solve, tick, closed_loop, imitation; default solve,tick)
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from profile_rl_step import profiled_step  # noqa: E402

from learningagileflight_se3_torch.config import CostWeights, QuadParams, SolverConfig, Variant  # noqa: E402
from learningagileflight_se3_torch.models.sampler import sample_scenarios, scenario_to_problem  # noqa: E402
from learningagileflight_se3_torch.sim.external_controller import ExternalSimController  # noqa: E402
from learningagileflight_se3_torch.solver.ilqr import make_batched_mpc_solver  # noqa: E402
from learningagileflight_se3_torch.utils import graphs  # noqa: E402
from learningagileflight_se3_torch.utils.weights import load_dnn2  # noqa: E402

BENCH_CFG = SolverConfig(horizon=50, max_iters=60, tol=1e-4, gtol=3e-4, ls_adaptive=True,
                         ls_max_trips=4, no_progress_iters=10)


def bench_args(seed, B):
    """The solver's arguments for B seeded bench.py-style scenarios on the card."""
    dev = torch.device("cuda")
    scen = sample_scenarios(torch.Generator(device=dev).manual_seed(seed), B)
    probs = scenario_to_problem(scen)
    x0 = probs["x0"]
    zeros = torch.zeros((B, 1), device=dev)
    tra_ang = torch.cat([zeros, scen[:, 8:9] * 0.5, zeros], dim=1)
    t = torch.clamp(torch.linalg.vector_norm(x0[:, 0:3], dim=1) / 4.0, 2.0, 4.0)
    return (x0, torch.zeros((B, 4), device=dev), probs["goal_pos"], torch.zeros((B, 3), device=dev),
            tra_ang, t)


def report(what, prof):
    print(f"{what} under torch.profiler: wall {prof['wall_s']:.4f} s, {prof['device_ops']} device "
          f"operations, device busy {prof['device_busy_s']:.4f} s, busy share {prof['busy_share']:.4f}; " +
          ", ".join(f"{k} {v['launches']} launches {v['device_ms']:.3f} ms" for k, v in prof["kernels"].items()),
          flush=True)
    for o in prof["top_other"]:
        print(f"  {o['device_ms']:.3f} ms over {o['launches']} launches: {o['name']}", flush=True)


def solve_part(reps=3):
    B = 2048
    solve = make_batched_mpc_solver(QuadParams(), CostWeights(), BENCH_CFG)
    solve(*bench_args(0, B))  # captures the solve's CUDA graph
    times, syncs = [], []
    for i in range(reps):
        args = bench_args(100 + i, B)
        torch.cuda.synchronize()
        n = graphs.host_reads
        t0 = time.perf_counter()
        sol = solve(*args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        syncs.append(graphs.host_reads - n)
        print(f"solve: B={B} {times[-1]:.4f} s (host, synced), {B / times[-1]:.1f} solves/s, mean iters "
              f"{sol.iterations.float().mean().item():.2f}, line-search trips {int(sol.ls_evals)}, "
              f"{syncs[-1]} host syncs", flush=True)
    args = bench_args(100, B)
    prof = profiled_step(lambda _: solve(*args), None)
    report("solve (graph)", prof)
    # the same solve on the eager loop (the host loops), for comparison
    n = graphs.host_reads
    eager = profiled_step(lambda _: solve.solution(solve.run_eager(*solve.setup(*args))), None)
    report("solve (eager)", eager)
    return dict(batch=B, solve_s=times, host_syncs=syncs, profiled=prof,
                eager=dict(profiled=eager, host_syncs=graphs.host_reads - n))


def tick_part():
    z = np.load(os.path.join(REPO, "artifacts", "replay_contract.npz"))
    moves, V = z["gate_moves"], z["gate_vel"]
    cfg = SolverConfig(horizon=50, max_iters=30, u_ub=float(z["solver_u_ub"]), tol=1e-4, gtol=3e-4,
                       ls_adaptive=True, ls_max_trips=4, no_progress_iters=10)

    def make():
        return ExternalSimController(
            load_dnn2(), final_point=z["final_point"],
            gate_motion=lambda i: (moves[min(i, len(moves) - 1)], V[min(i, len(moves) - 1)]),
            w_rot=float(z["w_rot"]), origin=z["origin"], variant=Variant.PYBULLET, solver_cfg=cfg,
            fixed_point_tol=float(z["fixed_point_tol"]), fixed_point_accel="secant",
            device="cuda", dtype=torch.float32)

    def replay(ctrl):
        lat = []
        for k in range(len(z["tick_steps"])):
            obs = z["observations"][k]
            t0 = time.perf_counter()
            ctrl.compute_control(step=int(z["tick_steps"][k]), cur_pos=obs[0:3], cur_quat_xyzw=obs[3:7],
                                 cur_vel=obs[10:13], cur_euler_rates=obs[13:16], cur_rpy=obs[7:10])
            lat.append(time.perf_counter() - t0)
        return np.asarray(lat) * 1e3

    replay(make())  # warm-up pass
    ctrl = make()  # the tick's graph is captured here, outside the timed pass
    syncs = graphs.host_reads
    ms = replay(ctrl)
    syncs = graphs.host_reads - syncs
    n = len(ms)
    print(f"tick: {n} ticks, per-tick ms {[round(float(x), 3) for x in ms]}; p50 {np.percentile(ms, 50):.3f} "
          f"p90 {np.percentile(ms, 90):.3f}; host reads {syncs} over the pass", flush=True)
    ctrl = make()
    prof = profiled_step(lambda _: replay(ctrl), None)
    report(f"tick pass ({n} ticks)", prof)
    return dict(ticks=n, tick_ms=ms.tolist(), p50_ms=float(np.percentile(ms, 50)),
                p90_ms=float(np.percentile(ms, 90)), host_reads=syncs, profiled=prof)


def closed_loop_part():
    from learningagileflight_se3_torch.sim import closed_loop
    from learningagileflight_se3_torch.sim.bench import flight_solver_config, fly, summarize
    from learningagileflight_se3_torch.utils.weights import bench_scenarios, bench_scenarios_path

    scen, noise = bench_scenarios(bench_scenarios_path(2024))
    model2 = load_dnn2()
    flights = []
    for _ in range(2):
        trace, metrics, wall = fly(model2, scen, noise, steps=500, seed=2024)
        out = summarize(metrics, trace.solver_iters)
        flights.append(dict(wall_s=wall, success=out["value"], strict=out["success_and_reached_2m"],
                            diverged=out["n_diverged"]))
        print(f"closed loop: 128 x 500 steps {wall:.3f} s (host, synced), success {out['value']:.4f}, "
              f"replan iterations p50 {out['replan_solver_iters_p50']} p90 {out['replan_solver_iters_p90']}",
              flush=True)

    # the host time of the parts: one more flight with the t-solver and the
    # solver wrapped in synced timers (the syncs add a little), on the eager
    # step loop (the watchers' drive: a replay of the step graphs has no
    # parts the host could time)
    parts = {"tsolve": 0.0, "solve": 0.0}
    calls = {"tsolve": 0, "solve": 0}

    def timed(name, make):
        def factory(*a, **kw):
            fn = make(*a, **kw)

            def wrapped(*b, **kb):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = fn(*b, **kb)
                torch.cuda.synchronize()
                parts[name] += time.perf_counter() - t0
                calls[name] += 1
                return r
            return wrapped
        return factory

    real = closed_loop.make_traversal_time_solver, closed_loop.make_batched_mpc_solver
    closed_loop.make_traversal_time_solver = timed("tsolve", real[0])
    closed_loop.make_batched_mpc_solver = timed("solve", real[1])
    graphs.eager_on_card = True
    try:
        _, _, wall = fly(model2, scen, noise, steps=500, seed=2024)
    finally:
        graphs.eager_on_card = False
        closed_loop.make_traversal_time_solver, closed_loop.make_batched_mpc_solver = real
    parts["rest"] = wall - parts["tsolve"] - parts["solve"]
    print(f"closed loop parts (eager step loop, host, synced): wall {wall:.3f} s: t-solver {parts['tsolve']:.3f} s over "
          f"{calls['tsolve']} calls, replans {parts['solve']:.3f} s over {calls['solve']} solves, the rest "
          f"(gate, DNN2, plant, log) {parts['rest']:.3f} s", flush=True)

    sim = closed_loop.make_closed_loop_sim(model2, solver_cfg=flight_solver_config(), steps=100)
    sim(scen, gate_noise=noise[:, :100])  # captures the step graphs before the profiler starts
    prof = profiled_step(lambda _: sim(scen, gate_noise=noise[:, :100]), None)
    report("closed loop, first 100 steps of 128 scenarios", prof)
    return dict(flights=flights, parts=parts, part_calls=calls, parts_wall_s=wall, profiled_100_steps=prof)


def imitation_part():
    from learningagileflight_se3_torch.sim.bench import flight_solver_config
    from learningagileflight_se3_torch.train.imitation import (
        make_imitation_collect, make_imitation_train_step,
    )
    from learningagileflight_se3_torch.train.rl import epoch_generator, init_generator
    from learningagileflight_se3_torch.models.mlp import make_dnn2
    from learningagileflight_se3_torch.utils.weights import NN_DEEP_DNN1, load_dnn1

    dev = torch.device("cuda")
    B, passes = 64, 10
    collect = make_imitation_collect(load_dnn1(NN_DEEP_DNN1).to(dev), QuadParams(), CostWeights(),
                                     flight_solver_config(), window_frame=True)
    model2 = make_dnn2(generator=init_generator(0)).to(dev)
    step = make_imitation_train_step(model2, torch.optim.Adam(model2.parameters(), lr=1e-3))

    def epoch(e, times=None):
        scen = sample_scenarios(epoch_generator(0, e, dev), B)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inputs, labels = collect(scen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(passes):
            step(inputs, labels)
        torch.cuda.synchronize()
        if times is not None:
            times.append((t1 - t0, time.perf_counter() - t1))

    epoch(99)  # warm-up
    times = []
    for e in range(3):
        epoch(e, times)
        print(f"imitation epoch {e}: collect {times[-1][0] * 1e3:.1f} ms, {passes} passes "
              f"{times[-1][1] * 1e3:.1f} ms (host, synced)", flush=True)
    prof = profiled_step(lambda _: epoch(3), None)
    report("imitation epoch (64 scenarios, 10 passes)", prof)
    return dict(batch=B, passes=passes, collect_s=[t[0] for t in times], passes_s=[t[1] for t in times],
                profiled=prof)


PARTS = {"solve": solve_part, "tick": tick_part, "closed_loop": closed_loop_part, "imitation": imitation_part}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--path", default="solve,tick", help="comma-separated: " + ", ".join(PARTS))
    ap.add_argument("--reps", type=int, default=3, help="timed solves")
    ap.add_argument("--out", default=None, help="also write the JSON summary here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_solve_tick: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    summary = dict(device=smi, torch=torch.__version__, cuda=torch.version.cuda)
    paths = args.path.split(",")
    for path in paths:
        if path not in PARTS:
            ap.error(f"unknown path {path!r}")
    if len(paths) == 1:
        summary[paths[0]] = PARTS[paths[0]](args.reps) if paths[0] == "solve" else PARTS[paths[0]]()
    else:
        # each part in a process of its own: on an H100 with torch 2.11 a
        # torch.profiler session over a graph with conditional nodes (the
        # tick's, a flight step's) that was captured after an earlier
        # session of the same process ended it with a segmentation fault
        with tempfile.TemporaryDirectory() as tmp:
            for path in paths:
                out = os.path.join(tmp, f"{path}.json")
                subprocess.run([sys.executable, os.path.abspath(__file__), "--path", path, "--reps",
                                str(args.reps), "--out", out], check=True)
                with open(out) as f:
                    summary[path] = json.load(f)[path]
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
