"""The parallel-in-time sweep against the sequential one, in both packages (CPU, needs JAX).

Solves B bench.py-style scenarios (`ops/inputs.py bench_problems`, the
port's sampler) at horizon H in float64 with `use_ddp=False` four ways: the
port's batched solver with cfg.backward "sequential" (K2's plain version)
and "parallel" (solver/parallel_riccati.py), and the JAX package's
single-problem solver, vmapped, with the same two settings (the `xla`
backend that honours cfg.backward).  Prints each solve's per-lane cost,
iterations and exit status, and a JSON summary: the share of lanes in the
blowout exit (status 4), the parallel cost over the sequential cost in each
package, and where the two packages' parallel solves agree.

Usage: python scripts/compare_parallel_sweep.py [--lanes 16] [--horizon 50] [--max-iters 60] [--seed 0]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lanes", type=int, default=16)
    ap.add_argument("--horizon", type=int, default=50)
    ap.add_argument("--max-iters", type=int, default=60)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from learningagileflight_se3_tpu import config as jcfg
    from learningagileflight_se3_tpu.solver.ilqr import make_mpc_solver
    from learningagileflight_se3_torch import config as tcfg
    from learningagileflight_se3_torch.ops.inputs import bench_problems
    from learningagileflight_se3_torch.solver.ilqr import make_batched_mpc_solver

    kw = dict(horizon=args.horizon, max_iters=args.max_iters, use_ddp=False, tol=1e-9, gtol=1e-7)
    problems = bench_problems(args.lanes, "cpu", seed=args.seed)
    out = {}
    for mode in ("sequential", "parallel"):
        t0 = time.time()
        s = make_batched_mpc_solver(tcfg.QuadParams(), tcfg.CostWeights(),
                                    tcfg.SolverConfig(backward=mode, **kw))(*problems)
        out[("port", mode)] = (s.cost.numpy(), s.iterations.numpy(), s.status.numpy(), time.time() - t0)
        t0 = time.time()
        solve = jax.jit(jax.vmap(make_mpc_solver(jcfg.QuadParams(), jcfg.CostWeights(),
                                                 jcfg.SolverConfig(backward=mode, **kw))))
        s = solve(*[jnp.asarray(a.numpy()) for a in problems])
        out[("jax", mode)] = (np.asarray(s.cost), np.asarray(s.iterations), np.asarray(s.status), time.time() - t0)
    for (pkg, mode), (cost, it, st, sec) in out.items():
        print(f"{pkg} {mode} ({sec:.1f} s): cost {np.round(cost, 3).tolist()}\n  iterations {it.tolist()}"
              f"\n  status {st.tolist()}", flush=True)

    summary = {}
    for pkg in ("port", "jax"):
        Js, Jp = out[(pkg, "sequential")][0], out[(pkg, "parallel")][0]
        rel = (Jp - Js) / np.maximum(np.abs(Js), 1.0)
        summary[pkg] = dict(parallel_blowout_share=float((out[(pkg, "parallel")][2] == 4).mean()),
                            sequential_at_cap_share=float((out[(pkg, "sequential")][2] == 0).mean()),
                            parallel_over_sequential_median=float(np.median(rel)),
                            parallel_over_sequential_max=float(rel.max()),
                            within_1pct_share=float((np.abs(rel) <= 1e-2).mean()))
    pp, jp = out[("port", "parallel")], out[("jax", "parallel")]
    summary["parallel_port_vs_jax"] = dict(
        same_status_share=float((pp[2] == jp[2]).mean()),
        same_iterations_share=float((pp[1] == jp[1]).mean()),
        cost_rel_median=float(np.median(np.abs(pp[0] - jp[0]) / np.maximum(np.abs(jp[0]), 1.0))))
    summary["settings"] = dict(lanes=args.lanes, seed=args.seed, **kw)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
