"""Cold-start control MAE against the lifted-NLP oracle: the port's
bench_accuracy.py.

The 32 problems of bench_accuracy.py (weights/accuracy_scenarios.npz, 8 in
each cell of {MAIN, PyBullet bounds} x {nominal, aggressive traversal
time}) at its settings: H=50, `max_iters=2000`, no omega box, the cell's
thrust bound, the squared attitude term.

  * the solve under test: the card's f64 solve (K1, K2), cold from the
    midpoint controls and from the hover thrust, the lower cost kept; the
    lanes of one thrust bound (a kernel constant) go in one batch;
  * the oracle: the port's lifted-NLP cascade (oracle/lifted_nlp.py) on the
    host in f64, one process per problem, os.cpu_count() at once, each
    with one BLAS thread (48 to 350 s of one core each);
  * `summarize(rows)`: bench_accuracy.py's summary and ok rule.  Rows whose
    oracle missed its KKT certificate (KKT > 1e-6) leave the MAE statistics
    and need DDP within 0.1% of the oracle's best iterate; of the rest, a
    control MAE of 1e-4 or more is another basin, where DDP must not lose to
    the oracle by more than 1e-9 relative; ok also needs the same-basin MAE
    under 1e-3 and a scenario with an active thrust bound.
"""

from __future__ import annotations

import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

from learningagileflight_se3_torch.benchmarks.harness import card_fields, counts_since, kernel_counts, log, prepare
from learningagileflight_se3_torch.config import CostWeights, QuadParams, SolverConfig
from learningagileflight_se3_torch.solver.ilqr import make_batched_mpc_solver
from learningagileflight_se3_torch.utils.weights import accuracy_scenarios

ORACLE_MAXITER = 8000  # bench_accuracy.py's
MAE_BASIN = 1e-4       # a larger control MAE is another stationary point
ORACLE_KKT = 1e-6      # an oracle over this missed its certificate
ACTIVE_TOL = 1e-7      # a control this close to a bound is on it
CELLS = [(v, r) for v in ("main", "pybullet_bounds") for r in ("nominal", "aggressive")]
N_PER_CELL = 8         # the npz's rows: cell c's i-th problem is row c * 8 + i


def accuracy_problem(row):
    """(params, weights, cfg, cell name, args) of an exported accuracy
    problem at bench_accuracy.py's settings: H=50, max_iters=2000, no omega
    box, the cell's thrust bound and the squared attitude term in both
    variants; args = (x0, u_last, goal, tra_pos, tra_ang, t), numpy."""
    z = accuracy_scenarios()
    cfg = SolverConfig(horizon=50, max_iters=2000, w_bound=float("inf"), u_ub=float(z["u_ub"][row]))
    args = (z["x0"][row], np.zeros(4), z["goal"][row], np.zeros(3), z["tra_ang"][row], float(z["t"][row]))
    return QuadParams(), CostWeights(), cfg, f"{z['variant'][row]}/{z['regime'][row]}", args


def compared_oracle(row):
    """The port's lifted-NLP oracle (host, float64) on accuracy problem
    `row`, as bench_accuracy.py calls it: its controls, cost, KKT residual,
    defect, final method and the seconds it took."""
    from learningagileflight_se3_torch.oracle import solve_lifted_oracle

    params, weights, cfg, _, args = accuracy_problem(row)
    t0 = time.perf_counter()
    sol = solve_lifted_oracle(params, weights, cfg, *args, maxiter=ORACLE_MAXITER)
    return dict(U=torch.from_numpy(sol.control_traj), cost=sol.cost, kkt=sol.kkt_residual,
                viol=sol.constr_violation, method=str(getattr(sol.result, "method", "")),
                seconds=time.perf_counter() - t0)


def card_solves(rows, device="cuda") -> dict:
    """The f64 solve of each accuracy problem in `rows` on `device`, cold from
    the midpoint and from the hover start, the lower cost kept: {row:
    dict(U, cost, status, iters, converged, start, iters_both)}."""
    f64 = dict(dtype=torch.float64, device=prepare(device))
    groups = {}  # the thrust bound (a kernel constant) -> rows
    for row in rows:
        groups.setdefault(accuracy_problem(row)[2].u_ub, []).append(row)
    out = {}
    for group in groups.values():
        params, weights, cfg, _, _ = accuracy_problem(group[0])
        # each problem twice: from the midpoint (the solver's own cold
        # start, given explicitly) and from the hover thrust
        args = [np.stack([accuracy_problem(r)[4][j] for r in group * 2]) for j in range(6)]
        H, n = cfg.horizon, len(group)
        U0 = np.concatenate([np.full((n, H, 4), 0.5 * (cfg.u_lb + cfg.u_ub)),
                             np.full((n, H, 4), params.mass * params.g / 4)])
        sol = make_batched_mpc_solver(params, weights, cfg)(
            *[torch.as_tensor(a, **f64) for a in args], U_init=torch.as_tensor(U0, **f64))
        cost = sol.cost.cpu().numpy()
        for j, row in enumerate(group):
            k = j if cost[j] <= cost[j + n] else j + n
            out[row] = dict(U=sol.control_traj[k].cpu().numpy(), cost=float(cost[k]), status=int(sol.status[k]),
                            iters=int(sol.iterations[k]), converged=bool(sol.converged[k]),
                            start="midpoint" if k < n else "hover",
                            iters_both=(int(sol.iterations[j]), int(sol.iterations[j + n])))
    return out


def row_record(row, ddp: dict, oracle: dict) -> dict:
    """bench_accuracy.py's row for problem `row` from the card's solve and
    the oracle's: variant, regime, mae, rel_cost_gap, kkt, n_active_bounds,
    and the details behind them."""
    _, _, cfg, name, _ = accuracy_problem(row)
    U_star = np.asarray(oracle["U"])
    variant, regime = name.split("/")
    return {
        "row": int(row),
        "variant": variant,
        "regime": regime,
        "mae": float(np.mean(np.abs(ddp["U"] - U_star))),
        "rel_cost_gap": (ddp["cost"] - oracle["cost"]) / abs(oracle["cost"]),
        "kkt": float(oracle["kkt"]),
        "n_active_bounds": int(np.sum((np.abs(U_star - cfg.u_lb) < ACTIVE_TOL)
                                      | (np.abs(U_star - cfg.u_ub) < ACTIVE_TOL))),
        "oracle_defect": float(oracle["viol"]),
        "oracle_method": oracle["method"],
        "oracle_s": round(float(oracle["seconds"]), 3),
        "ddp_status": ddp["status"],
        "ddp_iterations": ddp["iters"],
        "ddp_start": ddp["start"],
        "ddp_iterations_midpoint_hover": list(ddp["iters_both"]),
        "ddp_converged": ddp["converged"],
    }


def summarize(rows) -> dict:
    """bench_accuracy.py's JSON fields and ok rule from its rows (dicts with
    variant, regime, mae, rel_cost_gap, kkt, n_active_bounds)."""
    unconv = [r for r in rows if r["kkt"] > ORACLE_KKT]
    unconv_ok = all(r["rel_cost_gap"] <= 1e-3 for r in unconv)
    rows_c = [r for r in rows if r["kkt"] <= ORACLE_KKT]
    same = [r for r in rows_c if r["mae"] < MAE_BASIN]
    mism = [r for r in rows_c if r["mae"] >= MAE_BASIN]
    maes = np.array([r["mae"] for r in same])
    actives = np.array([r["n_active_bounds"] for r in rows])
    mism_ok = all(r["rel_cost_gap"] <= 1e-9 for r in mism)
    by_cell = {}
    for variant, regime in CELLS:
        cell = [r for r in rows_c if r["variant"] == variant and r["regime"] == regime]
        if not cell:
            by_cell[f"{variant}/{regime}"] = None
            continue
        cs = [r for r in cell if r["mae"] < MAE_BASIN]
        by_cell[f"{variant}/{regime}"] = {
            "mean_mae_same_basin": float(np.mean([r["mae"] for r in cs])) if cs else None,
            "max_mae_same_basin": float(np.max([r["mae"] for r in cs])) if cs else None,
            "n_basin_mismatch": len(cell) - len(cs),
            "n_ddp_at_or_below_oracle": int(sum(r["rel_cost_gap"] <= 1e-9 for r in cell)),
            "mean_active_bounds": round(float(np.mean([r["n_active_bounds"] for r in cell])), 1),
        }
    # `same` can be empty (every row a mismatch or an unconverged oracle):
    # the summary is still made, with ok false
    value = float(np.mean(maes)) if maes.size else float("nan")
    ok = (maes.size > 0 and value < 1e-3 and float(np.max(maes)) < 1e-3
          and mism_ok and int(np.sum(actives > 0)) >= 1 and unconv_ok)
    by_regime = lambda regime: [r["n_active_bounds"] for r in rows if r["regime"] == regime]  # noqa: E731
    return {
        "metric": "control_mae_vs_oracle",
        "value": value,
        "unit": "N",
        "vs_baseline": round(1e-3 / value, 2) if value > 0 else float("inf"),
        "ok": bool(ok),
        "mae_median": float(np.median(maes)) if maes.size else None,
        "mae_p90": float(np.percentile(maes, 90)) if maes.size else None,
        "max_mae": float(np.max(maes)) if maes.size else None,
        "n_same_basin": len(same),
        "n_basin_mismatch": len(mism),
        "n_oracle_unconverged": len(unconv),
        "oracle_unconverged_ddp_within_1e3": bool(unconv_ok),
        "oracle_unconverged_rel_cost_gaps": [round(r["rel_cost_gap"], 9) for r in unconv],
        "basin_mismatch_ddp_never_worse": bool(mism_ok),
        "basin_mismatch_rel_cost_gaps": [round(r["rel_cost_gap"], 12) for r in mism],
        "max_rel_cost_gap_same_basin": (float(np.max(np.abs([r["rel_cost_gap"] for r in same])))
                                        if same else None),
        "max_oracle_kkt": float(np.max([r["kkt"] for r in rows])),
        "n_scenarios_with_active_bounds": int(np.sum(actives > 0)),
        "mean_active_bounds_nominal": (round(float(np.mean(by_regime("nominal"))), 1)
                                       if by_regime("nominal") else None),
        "mean_active_bounds_aggressive": (round(float(np.mean(by_regime("aggressive"))), 1)
                                          if by_regime("aggressive") else None),
        "cells": by_cell,
        "cold_start": True,
        "two_start_globalization": "midpoint + hover (both solvers)",
        "unsquared_attitude_note": ("excluded from cold cells; degenerate objective - see "
                                    "artifacts/study_unsquared_degeneracy.json"),
        "oracle": "lifted_nlp cascade (shooting -> ipm -> newton crossover)",
        "n_scenarios": len(rows),
        "horizon": 50,
    }


def _one_thread():
    torch.set_num_threads(1)


def oracles(rows):
    """Start compared_oracle of every row in `rows`, one process each, as
    many at a time as the host has cores, each on one BLAS and OpenMP
    thread.  Returns a function that waits for them and returns {row:
    result}."""
    threads = {k: "1" for k in ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS", "MKL_NUM_THREADS")}
    saved = {k: os.environ.get(k) for k in threads}
    os.environ.update(threads)  # read by each process as it starts
    try:
        pool = ProcessPoolExecutor(max_workers=os.cpu_count(),
                                   mp_context=multiprocessing.get_context("spawn"), initializer=_one_thread)
        futures = {row: pool.submit(compared_oracle, row) for row in rows}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    def wait():
        try:
            return {row: f.result() for row, f in futures.items()}
        finally:
            pool.shutdown(cancel_futures=True)

    return wait


def run(device="cuda", n_per_cell: int = N_PER_CELL) -> dict:
    """bench_accuracy.py's JSON fields for the card's f64 solve on `device`
    (the card unless given "cpu") against the port's oracle on the host,
    plus the card's name and power limit, every row, and the times."""
    device = prepare(device)
    if not 1 <= n_per_cell <= N_PER_CELL:
        raise ValueError(f"n_per_cell must be 1 to {N_PER_CELL}: the exported draw holds {N_PER_CELL} a cell")
    rows = [c * N_PER_CELL + i for c in range(len(CELLS)) for i in range(n_per_cell)]
    t0 = time.perf_counter()
    wait = oracles(rows)  # on the host's cores while the card solves
    c0 = kernel_counts()
    t1 = time.perf_counter()
    ddp = card_solves(rows, device)
    solve_s = time.perf_counter() - t1
    launches = counts_since(c0)
    log(f"card: {len(rows)} problems x 2 starts in {solve_s:.2f} s, launches {launches}")
    ora = wait()
    records = []
    for row in rows:
        r = row_record(row, ddp[row], ora[row])
        records.append(r)
        log(f"[{r['variant']}/{r['regime']}] row {row}: MAE {r['mae']:.2e} rel cost gap {r['rel_cost_gap']:+.2e} "
            f"oracle kkt {r['kkt']:.1e} ({r['oracle_method']}, {r['oracle_s']:.1f} s) active bounds "
            f"{r['n_active_bounds']}/200, DDP status {r['ddp_status']} after {r['ddp_iterations']} iterations")
    return {
        **summarize(records),
        **card_fields(device),
        "solve_s": round(solve_s, 3),
        "oracle_host_s": round(sum(r["oracle_s"] for r in records), 3),
        "wall_s": round(time.perf_counter() - t0, 3),
        "oracle_processes": os.cpu_count(),
        "launches": launches,
        "rows": records,
    }
