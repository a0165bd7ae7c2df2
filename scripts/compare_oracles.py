"""The port's lifted-NLP oracle against the JAX package's, and what its
derivative blocks cost, on the CPU in float64.

Part 1 (the port alone, at H=50 on the first accuracy scenario): the time
of one call of
  * the shooting objective's value and gradient (`oracle/shooting.py`)
    against a backward pass through the port's eager rollout and cost;
  * the batched autograd blocks of `oracle/derivatives.py` against eager
    `torch.func.vmap(jacfwd)` / `vmap(hessian)` of the same functions,
with the largest difference between each pair.

Part 2: for each problem, the port's `solve_lifted_oracle` (method="auto",
bench_accuracy.py's maxiter=8000) and, unless --skip-jax, the JAX
package's, one after the other in this process: each one's host time,
cost, KKT residual, final method, and the largest control difference.
Problems: rows of weights/accuracy_scenarios.npz (bench_accuracy.py's
settings) and "canonical", tests/test_oracle_lifted.py's problem at H=15,
t=1.0.

Part 3 (unless --skip-jax): the shooting oracle (`solve_shooting_oracle`,
L-BFGS-B to its own stop, maxiter=2000) of both packages on the canonical
problem, from the midpoint and the hover start: each one's iterations,
stop message, cost and projected gradient (the largest gradient entry the
thrust box does not hold), and the largest control difference between the
two runs.

One JSON line per result.  Needs the JAX package unless --skip-jax; the
BLAS runs on one thread.

Usage: python scripts/compare_oracles.py [--rows canonical,0,8,16,24] [--skip-jax]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ.setdefault("OPENBLAS_NUM_THREADS", "1")
os.environ.setdefault("OMP_NUM_THREADS", "1")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from learningagileflight_se3_torch.config import CostWeights, QuadParams, SolverConfig  # noqa: E402
from learningagileflight_se3_torch.utils.weights import accuracy_scenarios  # noqa: E402

F64 = torch.float64


def problem(row: str):
    """(cfg kwargs, args) of a named problem."""
    if row == "canonical":
        x0 = np.zeros(13)
        x0[0:3] = [0.0, -8.0, 0.0]
        x0[6] = 1.0
        args = (x0, np.zeros(4), np.array([0.0, 8.0, 0.0]), np.zeros(3), np.array([0.0, 0.6, 0.0]), 1.0)
        return dict(horizon=15, max_iters=300, w_bound=float("inf")), args
    z, i = accuracy_scenarios(), int(row)
    args = (z["x0"][i], np.zeros(4), z["goal"][i], np.zeros(3), z["tra_ang"][i], float(z["t"][i]))
    return dict(horizon=50, max_iters=2000, w_bound=float("inf"), u_ub=float(z["u_ub"][i])), args


def per_call_ms(fn, n=20):
    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e3


def derivative_costs():
    """Part 1."""
    from torch.func import hessian, jacfwd, vmap

    from learningagileflight_se3_torch.core.rotations import rodrigues_to_quat
    from learningagileflight_se3_torch.costs.gate_costs import stage_cost, total_trajectory_cost
    from learningagileflight_se3_torch.dynamics.quadrotor import euler_step, rollout
    from learningagileflight_se3_torch.oracle.derivatives import batched_hessian, batched_jacobian
    from learningagileflight_se3_torch.oracle.shooting import make_shooting_objective

    kw, (x0, u_last, goal, tra_pos, tra_ang, t) = problem("0")
    cfg, p, w = SolverConfig(**kw), QuadParams(), CostWeights()
    H, dt = cfg.horizon, cfg.dt
    f64 = lambda a: torch.as_tensor(np.asarray(a), dtype=F64)  # noqa: E731
    q, tt = rodrigues_to_quat(f64(tra_ang)), torch.tensor(round(t * 10) / 10, dtype=F64)
    fun = make_shooting_objective(p, w, cfg, f64(x0), f64(u_last), f64(goal), f64(tra_pos), q, float(tt))
    U = np.random.default_rng(0).uniform(1.0, 1.4, H * 4)

    def backprop():
        Ul = f64(U).reshape(H, 4).requires_grad_()
        c = total_trajectory_cost(rollout(f64(x0), Ul, dt, p), Ul, f64(u_last), dt, tt, f64(goal),
                                  f64(tra_pos), q, w)
        (g,) = torch.autograd.grad(c, Ul)
        return float(c), g.reshape(-1).numpy()

    v1, g1 = fun(U)
    v2, g2 = backprop()
    out = dict(part="derivatives", H=H, shooting_objective_ms=per_call_ms(lambda: fun(U)),
               backprop_through_rollout_ms=per_call_ms(backprop, 5),
               shooting_grad_rel_diff=float(np.abs(g1 - g2).max() / np.abs(g2).max()),
               shooting_value_rel_diff=abs(v1 - v2) / abs(v2))
    with torch.no_grad():
        X = rollout(f64(x0), f64(U).reshape(H, 4), dt, p)
    XU = torch.cat([X[:-1], f64(U).reshape(H, 4)], dim=1)
    XUUP = torch.cat([XU, torch.cat([f64(u_last)[None], XU[:-1, 13:]])], dim=1)
    ks = torch.arange(H, dtype=F64)
    step = lambda xu: euler_step(xu[..., :13], xu[..., 13:], dt, p)  # noqa: E731
    stage = lambda xuup: stage_cost(xuup[..., :13], xuup[..., 13:17], xuup[..., 17:], ks, dt, tt,  # noqa: E731
                                    f64(goal), f64(tra_pos), q, w)
    stage_k = lambda k, xuup: stage_cost(xuup[:13], xuup[13:17], xuup[17:], k, dt, tt,  # noqa: E731
                                         f64(goal), f64(tra_pos), q, w)
    V = f64(np.random.default_rng(1).normal(size=(H, 13)))
    pairs = {
        "dynamics_jacobian": (lambda: vmap(jacfwd(step))(XU), lambda: batched_jacobian(step, XU, 13)),
        "stage_hessian": (lambda: vmap(hessian(stage_k, argnums=1))(ks, XUUP),
                          lambda: batched_hessian(stage, XUUP)),
        "constraint_hessian": (lambda: vmap(hessian(lambda xu, v: torch.dot(v, step(xu))))(XU, V),
                               lambda: batched_hessian(lambda xu: torch.sum(V * step(xu), dim=-1), XU)),
    }
    for name, (func, ours) in pairs.items():
        a, b = func(), ours()
        out[f"{name}_vmap_ms"] = per_call_ms(func, 5)
        out[f"{name}_batched_ms"] = per_call_ms(ours, 5)
        out[f"{name}_rel_diff"] = float((a - b).abs().max() / a.abs().max())
    print(json.dumps(out), flush=True)


def projected_gradient(U, g, lb, ub):
    """max |g_i| over the controls the box leaves free to descend along -g
    (interior ones, or at a bound with -g pointing inward): zero at a
    bound-constrained stationary point.  Unlike L-BFGS-B's own measure,
    |P(U - g) - U|, it is not capped by the box's width."""
    U, g = np.asarray(U).ravel(), np.asarray(g).ravel()
    held = ((U <= lb) & (g > 0)) | ((U >= ub) & (g < 0))
    return float(np.abs(np.where(held, 0.0, g)).max())


def shooting_full_runs(jcfg, j_shooting):
    """Part 3."""
    from learningagileflight_se3_torch.oracle import solve_shooting_oracle

    kw, prob = problem("canonical")
    cfg = SolverConfig(**kw)
    for start, U_init in (("midpoint", None), ("hover", np.full((15, 4), QuadParams().mass * QuadParams().g / 4))):
        out = dict(part="shooting", row="canonical", start=start)
        runs = {}
        for name, solve, c in (("port", solve_shooting_oracle, (QuadParams(), CostWeights(), cfg)),
                               ("jax", j_shooting, (jcfg.QuadParams(), jcfg.CostWeights(),
                                                    jcfg.SolverConfig(**kw)))):
            t0 = time.perf_counter()
            _, U, cost, res = solve(*c, *prob, U_init=U_init, maxiter=2000)
            runs[name] = np.asarray(U)
            out.update({f"{name}_s": time.perf_counter() - t0, f"{name}_nit": int(res.nit),
                        f"{name}_message": str(res.message), f"{name}_cost": float(cost),
                        f"{name}_projected_gradient": projected_gradient(U, res.jac, cfg.u_lb, cfg.u_ub)})
        out.update(max_control_diff=float(np.abs(runs["port"] - runs["jax"]).max()),
                   rel_cost_diff=abs(out["port_cost"] - out["jax_cost"]) / abs(out["jax_cost"]))
        print(json.dumps(out), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", default="canonical,0,8,16,24")
    ap.add_argument("--skip-jax", action="store_true")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    derivative_costs()

    from learningagileflight_se3_torch.oracle import solve_lifted_oracle

    if not args.skip_jax:
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        from learningagileflight_se3_tpu import config as jcfg
        from learningagileflight_se3_tpu.oracle import solve_lifted_oracle as j_solve
        from learningagileflight_se3_tpu.oracle import solve_shooting_oracle as j_shooting

        shooting_full_runs(jcfg, j_shooting)

    for row in args.rows.split(","):
        kw, prob = problem(row)
        maxiter = 2000 if row == "canonical" else 8000
        t0 = time.perf_counter()
        sol = solve_lifted_oracle(QuadParams(), CostWeights(), SolverConfig(**kw), *prob, maxiter=maxiter)
        out = dict(part="oracle", row=row, horizon=kw["horizon"], port_s=time.perf_counter() - t0,
                   port_cost=sol.cost, port_kkt=sol.kkt_residual, port_defect=sol.constr_violation,
                   port_method=str(getattr(sol.result, "method", "")))
        if not args.skip_jax:
            t0 = time.perf_counter()
            ref = j_solve(jcfg.QuadParams(), jcfg.CostWeights(), jcfg.SolverConfig(**kw), *prob, maxiter=maxiter)
            out.update(jax_s=time.perf_counter() - t0, jax_cost=ref.cost, jax_kkt=ref.kkt_residual,
                       jax_method=str(getattr(ref.result, "method", "")),
                       max_control_diff=float(np.abs(sol.control_traj - ref.control_traj).max()),
                       rel_cost_diff=abs(sol.cost - ref.cost) / abs(ref.cost))
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
