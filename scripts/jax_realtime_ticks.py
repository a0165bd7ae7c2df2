"""The tick protocol of benchmarks/bench_realtime.py on the JAX package, with
each tick's solve exit: what the timed ticks of that benchmark solve.

Drives the JAX package's ExternalSimController exactly as
bench_realtime.py's part 1 does (Variant.MAIN, its accelerator solver
config: H=50, max_iters=30, tol=1e-4, gtol=3e-4, no_progress_iters=10,
ls_adaptive, ls_max_trips=4; secant fixed point at tol 1e-3; the seed-2024
scenarios and gate keys; the host plant `euler_step_renorm` at 10 ms), on
the CPU with JAX's default 32-bit types, and prints one JSON line: per
tick the solve's exit status, iterations and cost, the first rotor
thrust, and the plant's position, then the final distance to the goal.
The port's realtime bench (learningagileflight_se3_torch/benchmarks/
realtime.py) reports the same exits as `tick_solve_status_histogram`.

Usage: python scripts/jax_realtime_ticks.py [--trajectory 0] [--steps 500]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

import learningagileflight_se3_tpu.sim.external_controller as ec  # noqa: E402
from learningagileflight_se3_tpu.config import GateMotionConfig, QuadParams, SolverConfig, Variant  # noqa: E402
from learningagileflight_se3_tpu.core.rotations import axis_angle_to_quat  # noqa: E402
from learningagileflight_se3_tpu.dynamics.quadrotor import euler_step_renorm  # noqa: E402
from learningagileflight_se3_tpu.geometry.gate import gate_from_width, gate_move, rotate_y  # noqa: E402
from learningagileflight_se3_tpu.models.mlp import make_dnn2  # noqa: E402
from learningagileflight_se3_tpu.models.sampler import sample_scenarios  # noqa: E402
from learningagileflight_se3_tpu.utils.checkpoint import load_params  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trajectory", type=int, default=0, help="which seed-2024 scenario")
    ap.add_argument("--steps", type=int, default=500)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(REPO, "benchmarks"))
    from bench_realtime import rpy_and_rates_from_state

    cfg = SolverConfig(horizon=50, max_iters=30, tol=1e-4, gtol=3e-4, no_progress_iters=10,
                       ls_adaptive=True, ls_max_trips=4)
    exits = []
    make_solver = ec.make_batched_mpc_solver

    def recording_solver(*a, **kw):  # the controller's solve, its row-0 exit kept
        solve = make_solver(*a, **kw)

        def wrapped(*args_, **kw_):
            sol = solve(*args_, **kw_)
            jax.debug.callback(lambda s, i, c: exits.append((int(s), int(i), float(c))),
                               sol.status[0], sol.iterations[0], sol.cost[0])
            return sol

        return wrapped

    ec.make_batched_mpc_solver = recording_solver
    model2 = make_dnn2()
    p2 = load_params(os.path.join(REPO, "artifacts", "nn3_1"),
                     like=model2.init(jax.random.PRNGKey(0), jnp.zeros((1, 18))))
    motion, params = GateMotionConfig(), QuadParams()
    ks, kg = jax.random.split(jax.random.PRNGKey(2024))
    scen = np.asarray(sample_scenarios(ks, 128))[args.trajectory]
    key = jax.random.split(kg, 128)[args.trajectory]
    pts0 = rotate_y(gate_from_width(jnp.asarray(scen[7])), scen[8])
    moves, V = gate_move(pts0, key, jnp.asarray(motion.velocity), motion.omega_y, T=args.steps * 0.01, dt=0.01,
                         noise_std=motion.noise_std, noise_clip=motion.noise_clip)
    moves, V = np.asarray(moves), np.asarray(V)
    ctrl = ec.ExternalSimController(model2, p2, scen[3:6], gate_motion=lambda i: (moves[i], V[i]),
                                    w_rot=motion.omega_y, variant=Variant.MAIN, solver_cfg=cfg,
                                    fixed_point_tol=1e-3, fixed_point_accel="secant")
    q0 = axis_angle_to_quat(jnp.asarray(scen[6]), jnp.array([0.0, 0.0, 1.0]))
    state = np.concatenate([scen[0:3], np.zeros(3), np.asarray(q0), np.zeros(3)])
    step_plant = jax.jit(lambda s, u: euler_step_renorm(s, u, 0.01, params))
    ticks = []
    for i in range(args.steps):
        if i % 10 == 0:
            s = np.asarray(state, dtype=np.float64)
            rpy, d_rpy = rpy_and_rates_from_state(s[6:10], s[10:13])
            ctrl.compute_control(i, s[0:3], s[[7, 8, 9, 6]], s[3:6], d_rpy, rpy)
            jax.effects_barrier()
            st, it, cost = exits[-1]
            ticks.append(dict(step=i, status=st, iterations=it, cost=cost, u=np.round(ctrl.u, 4).tolist(),
                              pos=np.round(s[0:3], 3).tolist()))
        state = np.asarray(step_plant(jnp.asarray(state), jnp.asarray(ctrl.u)))
    statuses = [t["status"] for t in ticks]
    print(json.dumps({"trajectory": args.trajectory, "status_histogram": np.bincount(statuses, minlength=5).tolist(),
                      "final_dist_m": float(np.linalg.norm(state[0:3] - scen[3:6])), "ticks": ticks}))


if __name__ == "__main__":
    main()
