"""The port's benchmarks (learningagileflight_se3_torch/benchmarks/) against
the JAX package's: the exported problems against the JAX sampler, bench.py's
problem construction, bench_realtime.py's state conversion, the golden
quality arithmetic against the JAX batched solver, bench_accuracy.py's
decisions, the certified tier's tile, and every key of each JAX record.

The solves here run on the CPU at small sizes; on the card the benches run
through scripts/torch_bench*.py and chip_smoke.py."""

import importlib.util
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from learningagileflight_se3_tpu import config as jcfg
from learningagileflight_se3_tpu.models.sampler import scenario_to_problem as j_scenario_to_problem
from learningagileflight_se3_tpu.solver.ilqr_batched import make_batched_mpc_solver_pallas

from learningagileflight_se3_torch import config as tcfg
from learningagileflight_se3_torch.benchmarks import accuracy, kernel_check, latency, realtime, scaling, solve
from learningagileflight_se3_torch.benchmarks.problems import BENCH_PROBLEMS, bench_args, scenarios
from learningagileflight_se3_torch.solver.ilqr import make_batched_mpc_solver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_by_path(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _record(path):
    with open(os.path.join(REPO, path)) as f:
        return json.load(f)


# dicts keyed by data (device counts), not by field names
DATA_KEYED = {"solves_per_sec", "parity_per_count"}


def _missing(want: dict, got: dict, path="") -> list:
    """The keys of `want` (recursively, through dict values present on both
    sides, except DATA_KEYED) that `got` lacks."""
    out = []
    for k, v in want.items():
        if k not in got:
            out.append(path + k)
        elif isinstance(v, dict) and isinstance(got[k], dict) and k not in DATA_KEYED:
            out += _missing(v, got[k], f"{path}{k}.")
    return out


def test_bench_problems_are_the_jax_sampler_draws():
    """weights/bench_problems.npz holds, for every PRNGKey and batch the JAX
    benchmarks draw, what the JAX sampler draws now (32-bit, as on the TPU)."""
    exporter = _load_by_path("export_bench_problems", "scripts/export_bench_problems.py")
    want = exporter.bench_problems()
    with np.load(BENCH_PROBLEMS) as z:
        assert sorted(set(z.files) - {"source"}) == sorted(want)
        assert "32-bit" in str(z["source"])
        for k, v in want.items():
            assert z[k].dtype == np.float32 and np.array_equal(z[k], v), k
    assert [k for k, n in exporter.DRAWS] == [0, 100, 101, 102, 3, 7, 0, 0]


@pytest.mark.parametrize("key,n", [(0, 2048), (3, 1), (7, 256)])
def test_bench_args_match_bench_py(key, n):
    """bench_args builds bench.py:74-85's problem (x0, u_last, goal, tra_pos,
    tra_ang, t) from the same scenarios, in f32."""
    scen = scenarios(key, n)
    with jax.enable_x64(False):
        s = jnp.asarray(scen)
        probs = jax.vmap(j_scenario_to_problem)(s)
        x0 = probs["x0"]
        want = [x0, jnp.zeros((n, 4), jnp.float32), probs["goal_pos"], jnp.zeros((n, 3), jnp.float32),
                jnp.concatenate([jnp.zeros((n, 1)), s[:, 8:9] * 0.5, jnp.zeros((n, 1))], axis=1).astype(jnp.float32),
                jnp.clip(jnp.linalg.norm(x0[:, 0:3], axis=1) / 4.0, 2.0, 4.0).astype(jnp.float32)]
        want = [np.asarray(a) for a in want]
    got = bench_args(scen, "cpu")
    for name, g, w in zip(["x0", "u_last", "goal", "tra_pos", "tra_ang", "t"], got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-7, err_msg=name)


def test_rpy_and_rates_match_bench_realtime():
    """realtime.rpy_and_rates_from_state is bench_realtime.py's conversion
    (loaded by path: it imports only numpy at module level) on 64 seeded
    states."""
    ref = _load_by_path("bench_realtime", "benchmarks/bench_realtime.py").rpy_and_rates_from_state
    rng = np.random.default_rng(10)
    for _ in range(64):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        w = rng.normal(size=3)
        (rpy, d), (rpy_r, d_r) = realtime.rpy_and_rates_from_state(q, w), ref(q, w)
        np.testing.assert_allclose(rpy, rpy_r, rtol=0, atol=1e-12)
        np.testing.assert_allclose(d, d_r, rtol=0, atol=1e-12)


def _j_cfg(cfg):
    return jcfg.SolverConfig(**{f: getattr(cfg, f) for f in ("horizon", "max_iters", "tol", "gtol", "ls_adaptive",
                                                             "ls_max_trips", "no_progress_iters")})


def _pallas_solve(cfg, args):
    """The JAX package's batched solver as bench.py runs it on the TPU (the
    Pallas kernels; here in interpret mode), the batch padded to its 128
    lanes with copies of row 0 (the lanes are independent) and cut back."""
    B = args[0].shape[0]
    solve = jax.jit(make_batched_mpc_solver_pallas(jcfg.QuadParams(), jcfg.CostWeights(), _j_cfg(cfg),
                                                   interpret=True))
    sol = solve(*[jnp.concatenate([a, jnp.repeat(a[:1], 128 - B, axis=0)]) for a in
                  (jnp.asarray(x.numpy()) for x in args)])
    return SimpleNamespace(**{k: np.asarray(getattr(sol, k))[:B] for k in ("cost", "iterations", "status",
                                                                            "converged")})


def test_golden_quality_matches_jax_batched_solver():
    """The slice as a whole: solve.quality (the budget solve at bench.py's
    operating point against the 150-iteration full-ladder golden run) on the
    CPU in f64 on the first 8 problems of bench.py's rep 0 at H=10, against
    the same arithmetic on the JAX package's batched solver as bench.py runs
    it (the Pallas solver, interpret mode, f64, CPU).

    Gated: equal converged_frac and frac_within_1pct_of_converged; per
    solve, at least 5 of 8 lanes on the same iterations and exit with costs
    within rtol 1e-9; every exit equal in the golden run and all but one in
    the budget run; every cost within 1e-3.  Not every lane can agree: at a
    converged iterate the line search's tests compare decreases at the
    rounding level of the cost, and the two packages' f64 roundings break
    those ties differently (the budget run's lanes 4 and 6 accept a step at
    iterations 20 and 15 that the JAX solver does not, the golden run's
    lanes 3, 5, 6 end 2, 1, 3 iterations apart; differences up to 9.5e-5 in
    cost, under the window's tol 1e-4 per 10 iterations)."""
    H = 10
    args = bench_args(scenarios(100, 2048)[:8], "cpu", torch.float64)
    P, W = tcfg.QuadParams(), tcfg.CostWeights()
    sol_b, sol_g, q = solve.quality(make_batched_mpc_solver(P, W, solve.bench_config(H)),
                                    make_batched_mpc_solver(P, W, solve.golden_config(H)), args)
    jb, jg = _pallas_solve(solve.bench_config(H), args), _pallas_solve(solve.golden_config(H), args)
    for mine, ref, what, max_exits_apart in ((sol_b, jb, "budget", 1), (sol_g, jg, "golden", 0)):
        same_exit = mine.status.numpy() == ref.status
        assert (~same_exit).sum() <= max_exits_apart, f"{what}: {mine.status.tolist()} against {ref.status.tolist()}"
        rel = np.abs(mine.cost.numpy() - ref.cost) / np.abs(ref.cost)
        same = same_exit & (mine.iterations.numpy() == ref.iterations) & (rel <= 1e-9)
        assert same.sum() >= 5, f"{what}: {same.sum()} lanes agree; rel {rel}"
        assert rel.max() <= 1e-3, f"{what}: rel {rel}"
    ex = solve.excess(jb.cost, jg.cost)
    assert q["frac_within_1pct_of_converged"] == round(float((ex < 0.01).mean()), 4)
    assert q["converged_frac"] == round(float(jb.converged.mean()), 4)


def test_bench_configs_are_bench_py_settings():
    """The budget, golden and r3-compat configurations are bench.py's."""
    want = {"bench": dict(max_iters=60, ls_adaptive=True, ls_max_trips=4, no_progress_iters=10),
            "golden": dict(max_iters=150, ls_adaptive=False, ls_max_trips=14, no_progress_iters=0),
            "r3": dict(max_iters=50, ls_adaptive=True, ls_max_trips=4, no_progress_iters=0)}
    for name, kw in want.items():
        cfg = getattr(solve, f"{name}_config")()
        assert cfg == tcfg.SolverConfig(horizon=50, tol=1e-4, gtol=3e-4, **kw), name


def _row(variant="main", regime="nominal", mae=1e-8, gap=1e-15, kkt=1e-12, active=20):
    return dict(variant=variant, regime=regime, mae=mae, rel_cost_gap=gap, kkt=kkt, n_active_bounds=active)


@pytest.mark.parametrize("case,rows,ok,counts", [
    ("same basin", [_row(), _row(regime="aggressive", mae=9e-8)], True, (2, 0, 0)),
    ("mismatch, DDP not worse", [_row(), _row(mae=0.2, gap=-3e-4)], True, (1, 1, 0)),
    ("mismatch, DDP worse", [_row(), _row(mae=0.2, gap=2e-9)], False, (1, 1, 0)),
    ("oracle unconverged, within 0.1%", [_row(), _row(kkt=0.099, gap=-2.55e-4, mae=0.05)], True, (1, 0, 1)),
    ("oracle unconverged, beyond 0.1%", [_row(), _row(kkt=0.099, gap=2e-3)], False, (1, 0, 1)),
    ("basin split at MAE 1e-4", [_row(mae=5e-5), _row(mae=2e-3, gap=-1e-3)], True, (1, 1, 0)),
    ("no active bound", [_row(active=0)], False, (1, 0, 0)),
])
def test_accuracy_summary_decisions(case, rows, ok, counts):
    """accuracy.summarize decides as bench_accuracy.py does: the basin split
    at MAE 1e-4, a mismatch passes only with DDP at most 1e-9 above the
    oracle, an unconverged oracle (KKT > 1e-6) leaves the MAE statistics
    and needs DDP within 0.1% of it, and ok needs an active bound."""
    out = accuracy.summarize(rows)
    assert out["ok"] is ok, case
    assert (out["n_same_basin"], out["n_basin_mismatch"], out["n_oracle_unconverged"]) == counts, case
    if counts[2]:
        assert out["oracle_unconverged_rel_cost_gaps"] == [round(rows[1]["rel_cost_gap"], 9)]


def test_rescue_tile_from_the_largest_rep():
    """The certified tier sizes its rescue tile from the largest count of
    non-KKT lanes over the reps (bench.py sized it from rep 0, then cut
    later reps down), and rescues every such lane of every rep."""
    assert solve.rescue_tile([3, 130, 7], 2048) == 256  # bench.py: 128 from rep 0
    assert solve.rescue_tile([1536, 10], 2048) == 1536
    assert solve.rescue_tile([5000], 2048) == 2048
    assert solve.rescue_tile([0, 0], 2048) == 0
    assert solve.rescue_tile([3, 5], 8, tile=4) == 8

    batch = 8
    status = [np.array([1, 1, 0, 1, 1, 1, 1, 1]), np.array([3, 1, 0, 4, 1, 1, 0, 1])]
    cost = [np.arange(batch, dtype=np.float64) + 10.0 * r for r in range(2)]
    golden_batches = []

    def fake(status_, cost_):
        return SimpleNamespace(status=torch.as_tensor(status_), cost=torch.as_tensor(cost_),
                               grad_norm=torch.zeros(len(cost_)))

    def budget(rep, lanes):
        return fake(status[int(rep[0])], cost[int(rep[0])])

    def golden(rep, lanes):
        golden_batches.append(lanes.numpy().copy())
        return fake(np.ones(len(lanes), np.int64), np.full(len(lanes), 0.5))

    reps = [(torch.full((batch,), r), torch.arange(batch)) for r in range(2)]
    out = solve.certified_tier(budget, golden, reps, status, np.full(batch, 0.5), lambda: None, tile=2)
    assert out["rescue_counts"] == [1, 4] and out["rescue_tile"] == 4
    assert [sorted(set(b)) for b in golden_batches] == [[2], [0, 2, 3, 6]]
    assert all(len(b) == 4 for b in golden_batches)
    # rep 0 against a golden cost of 0.5: lane 0 (cost 0) is under it, lane
    # 2 (cost 2) is rescued to it, the others stay over
    assert out["frac_within_1pct"] == pytest.approx(2 / 8)


@pytest.fixture(scope="module")
def tiny_runs():
    """Every bench whose run solves, at a tiny size on the CPU."""
    return {
        "solve": solve.run(device="cpu", batch=2, horizon=4, reps=1, pipeline_depth=1, pipeline_rounds=1, tile=2),
        "kernel_check": kernel_check.run(device="cpu", batch=4, horizon=4, max_iters=3),
        "latency": latency.run(device="cpu", horizon=4, queries=7, tile=3, tile_queries=4),
        "realtime": realtime.run(device="cpu", n=2, steps=30, latency_trajectories=1, max_iters=3, horizon=5),
    }


@pytest.mark.parametrize("bench,record", [
    ("solve", "BENCH_r05.json"),
    ("kernel_check", "artifacts/pallas_tpu_check.json"),
    ("latency", "artifacts/bench_latency.json"),
    ("realtime", "artifacts/bench_realtime.json"),
])
def test_run_returns_every_key_of_the_jax_record(tiny_runs, bench, record):
    """Each bench's run returns every key of its JAX record (nested ones
    too), plus the card's name and power limit, and finite numbers."""
    want = _record(record)
    want = want.get("parsed", want)
    got = tiny_runs[bench]
    assert _missing(want, got) == [], bench
    assert got["platform"] == "cpu" and "power_limit" in got
    assert got["metric"] == (want["metric"] if bench != "kernel_check" else "cuda_vs_plain_agreement")
    assert np.isfinite(got["value"])
    json.dumps(got)


@pytest.mark.parametrize("mine,record", [
    ("bench_solve", "BENCH_r05.json"),
    ("bench_kernel_check", "artifacts/pallas_tpu_check.json"),
    ("bench_latency", "artifacts/bench_latency.json"),
    ("bench_realtime", "artifacts/bench_realtime.json"),
    ("bench_accuracy", "artifacts/bench_accuracy.json"),
    ("bench_scaling", "artifacts/bench_scaling.json"),
])
def test_committed_records_hold_every_key(mine, record):
    """The card's records (learningagileflight_se3_torch/records/) hold every
    key of their JAX records and name the card and its power limit."""
    want = _record(record)
    got = _record(f"learningagileflight_se3_torch/records/{mine}.json")
    assert _missing(want.get("parsed", want), got) == [], mine
    assert got["platform"].startswith("NVIDIA") and got["power_limit"].endswith(" W")


def test_realtime_part_counts(tiny_runs):
    """The tiny realtime run flies its ticks and its success flight on the
    plain versions (CPU tensors) and reports each part's counts and each
    timed tick's solve exit."""
    r = tiny_runs["realtime"]
    assert r["n_ticks"] == 2 and r["n_scenarios"] == 2 and r["seed"] == 2024
    assert sum(r["tick_solve_status_histogram"]) == r["n_ticks"]  # one exit read after each timed tick
    for part in ("ticks", "success"):
        n = r["launches"][part]
        assert n["K1"] == 0 and n["K2"] == 0 and n["K1_plain"] > 0 and n["K2_plain"] > 0, part


def test_solve_part_counts(tiny_runs):
    """The tiny solve run reports each part's counts: one synced solve at
    the bench config (the main path) within the whole run, all on the plain
    versions (CPU tensors)."""
    n = tiny_runs["solve"]["launches"]
    assert set(n) == {"sync_rep", "golden_run", "certified_tier", "r3_compat", "bench"}
    for part, c in n.items():
        assert c["K1"] == 0 and c["K2"] == 0 and c["K1_plain"] > 0 and c["K2_plain"] > 0, part
    for k in ("K1_plain", "K2_plain"):
        assert sum(n[p][k] for p in ("sync_rep", "golden_run", "certified_tier", "r3_compat")) < n["bench"][k]


def test_scaling_solve_problem():
    """The scaling ranks' problem is bench_args of the draw, its traversal
    attitude kept for the silicon rows and zeroed for the multi-process
    rows, as numpy float32 arrays."""
    scen = scenarios(0, 64)[:6]
    ref = [a.numpy() for a in bench_args(scen, "cpu")]
    kept, zeroed = (scaling.solve_problem(scen, traversal_attitude=t) for t in (True, False))
    for i, (a, b, r) in enumerate(zip(kept, zeroed, ref)):
        assert a.dtype == np.float32 and np.array_equal(a, r)
        assert np.array_equal(b, np.zeros_like(r) if i == 4 else r)
    assert np.abs(kept[4][:, 1]).max() > 0


def test_accuracy_and_scaling_assemble_every_key():
    """accuracy.summarize (rows of every cell, one unconverged oracle) and
    scaling.assemble (one card, every multi-process row) give every key of
    the JAX records, with the one-card efficiency null."""
    rows = [_row(v, r, kkt=0.099 if (v, r, i) == ("pybullet_bounds", "aggressive", 0) else 1e-12, gap=-2e-4 if i == 0
                 else 1e-15) for v, r in accuracy.CELLS for i in range(8)]
    acc = accuracy.summarize(rows)
    assert _missing(_record("artifacts/bench_accuracy.json"), acc) == []
    assert acc["ok"] and acc["n_oracle_unconverged"] == 1 and acc["n_scenarios"] == 32
    mp = {mode: scaling.mp_row({1: 2.0, 2: 1.5}, mode, "gloo") for mode in ("solve", "trainstep")}
    sc = scaling.assemble({1: 9000.0}, 1, 8, {"platform": "cpu", "power_limit": None}, mp["solve"],
                          mp["trainstep"], mp["solve"], mp["trainstep"])
    assert _missing(_record("artifacts/bench_scaling.json"), sc) == []
    assert sc["value"] is None and sc["cards"] == 1 and sc["virtual_mesh_sharding_parity"] is None
    assert sc["multiprocess"]["parity_2proc_vs_1proc"] == 0.75
    two = scaling.assemble({1: 9000.0, 2: 16200.0}, 2, 8, {"platform": "cpu", "power_limit": None})
    assert two["value"] == 0.9 and two["devices_gated"] == 2
    assert scaling.card_counts(1) == [1] and scaling.card_counts(6) == [1, 2, 4]
