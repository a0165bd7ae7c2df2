"""The kernel path against the plain path: the port's check_pallas_tpu.py.

One batch through both paths of the batched solver: the kernels (CUDA
tensors, f32) and their plain PyTorch versions (CPU tensors, f32), on the
256 problems the JAX check draws from PRNGKey(7), at H=20, `max_iters=60`,
`tol=1e-4`, `gtol=3e-4`.  Agreement is taken at convergence, lane by lane,
under check_pallas_tpu.py's rule: the median cost and control agreement on
the lanes both paths call converged, a same-basin share, a q90 gate, and
a tail made only of basin flips and non-converged lanes.  TF32 is off (the
GPU form of the bf16 drift that check found on the TPU).

The JAX record's keys are kept: "pallas" reads "the kernel path" and "xla"
"the plain path" (`worst_lane.pallas_converged`, `.xla_converged`).
"""

from __future__ import annotations

import time

import numpy as np

from learningagileflight_se3_torch.benchmarks.harness import build_kernels, card_fields, log, prepare
from learningagileflight_se3_torch.benchmarks.problems import bench_args, scenarios
from learningagileflight_se3_torch.config import CostWeights, QuadParams, SolverConfig
from learningagileflight_se3_torch.solver.ilqr import make_batched_mpc_solver


def agreement(kernel, plain) -> dict:
    """check_pallas_tpu.py's statistics and `ok` rule for two solutions of
    the same batch (the kernel path's and the plain path's)."""
    conv_k, conv_p = kernel.converged.cpu().numpy(), plain.converged.cpu().numpy()
    both = conv_k & conv_p
    Jk, Jp = kernel.cost.double().cpu().numpy(), plain.cost.double().cpu().numpy()
    cost_rel = np.abs(Jk - Jp) / np.maximum(np.abs(Jp), 1.0)
    mae = np.abs(kernel.control_traj.double().cpu().numpy()
                 - plain.control_traj.double().cpu().numpy()).mean(axis=(1, 2))
    on_both = lambda f, x, empty: f(x[both]) if both.any() else empty  # noqa: E731
    both_frac = float(both.mean())
    med_rel = on_both(lambda x: float(np.median(x)), cost_rel, float("inf"))
    med_mae = on_both(lambda x: float(np.median(x)), mae, float("inf"))
    same_basin = on_both(lambda x: float((x < 1e-4).mean()), cost_rel, 0.0)
    q90 = on_both(lambda x: float(np.percentile(x, 90)), cost_rel, float("inf"))
    # the tail: every lane off by more than 1e-4 must be a basin flip
    # (controls 0.01 or more apart) or have a non-converged side, never a
    # numeric error (nearly equal controls with a diverging cost)
    tail = cost_rel > 1e-4
    flip, nonconv, unexplained = tail & (mae > 1e-2), tail & ~both, tail & ~(mae > 1e-2) & both
    worst = int(np.argmax(cost_rel))
    ok = (both_frac >= 0.5 and med_rel < 1e-5 and med_mae < 1e-4 and same_basin >= 0.85
          and q90 < 1e-4 and int(unexplained.sum()) == 0)
    return {
        "value": 1.0 if ok else 0.0,
        "both_converged_frac": both_frac,
        "median_cost_rel_diff_converged": med_rel,
        "q90_cost_rel_diff_converged": q90,
        "median_control_mae_converged": med_mae,
        "frac_same_basin_converged": same_basin,
        "max_cost_rel_diff": float(cost_rel.max()),
        "tail_lanes_over_1e4": int(tail.sum()),
        "tail_basin_flips": int(flip.sum()),
        "tail_not_both_converged": int(nonconv.sum()),
        "tail_unexplained": int(unexplained.sum()),
        "worst_lane": {
            "cost_rel": float(cost_rel[worst]),
            "control_mae": float(mae[worst]),
            "pallas_converged": bool(conv_k[worst]),
            "xla_converged": bool(conv_p[worst]),
            "explanation": ("basin flip" if mae[worst] > 1e-2 else
                            "non-converged side" if not both[worst] else "unexplained"),
        },
    }


def run(device="cuda", batch: int = 256, horizon: int = 20, max_iters: int = 60) -> dict:
    """check_pallas_tpu.py's JSON fields for the kernel path on `device`
    (the card unless given "cpu", where both paths are the plain one)
    against the plain path on the CPU."""
    device = prepare(device)
    build_s = build_kernels(device)
    cfg = SolverConfig(horizon=horizon, max_iters=max_iters, tol=1e-4, gtol=3e-4)
    solve = make_batched_mpc_solver(QuadParams(), CostWeights(), cfg)
    scen = scenarios(7, 256)[:batch]
    t0 = time.perf_counter()
    ks = solve(*bench_args(scen, device))
    ks.cost.cpu()  # the fetch waits for the card
    t1 = time.perf_counter()
    ps = solve(*bench_args(scen, "cpu"))
    t2 = time.perf_counter()
    out = agreement(ks, ps)
    log(f"kernel path {t1 - t0:.2f} s on {device}, plain path {t2 - t1:.2f} s on the CPU; tail "
        f"{out['tail_lanes_over_1e4']} lanes: basin flips {out['tail_basin_flips']}, not both converged "
        f"{out['tail_not_both_converged']}, unexplained {out['tail_unexplained']}")
    w = out["worst_lane"]
    log(f"worst lane: cost_rel {w['cost_rel']:.2e} mae {w['control_mae']:.3e} converged kernel/plain "
        f"{w['pallas_converged']}/{w['xla_converged']}")
    value = out.pop("value")
    return {
        "metric": "cuda_vs_plain_agreement",
        "value": value,
        "unit": "bool",
        "ok": value == 1.0,
        "compiled": device.type == "cuda",
        **card_fields(device),
        "batch": batch,
        "horizon": horizon,
        "max_iters": max_iters,
        **out,
        "kernel_path_s": round(t1 - t0, 3),
        "plain_path_s": round(t2 - t1, 3),
        "build_s": None if build_s is None else round(build_s, 3),
        "notes": {
            "paths": "pallas = the kernel path (CUDA tensors), xla = the plain path (CPU tensors); f32, TF32 off",
            "compiled": "true when the kernel path ran the CUDA kernels (false on the CPU: both paths plain)",
            "kernel_path_s": "the kernel path's solve after the kernels' build (build_s)",
        },
    }
