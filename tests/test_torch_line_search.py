"""The line search on the (trip, lane) grid, on the CPU.

The solver's line search rolls every trip out at once, one K1 launch over
the (trip, lane) grid (`ops/rollout.py rollout_trials`), and replays the
ladder's first-accept recurrence over the trips (`ops/line_search.py
first_accept`: K5, `csrc/line_search.cu`, on the card; its plain version,
`first_accept_plain`, on the CPU).  The reference is the
JAX package's line search, the `line_search` closure of
`learningagileflight_se3_tpu/solver/ilqr_batched.py`
(`make_batched_mpc_solver_pallas`), which cannot be called alone:
`jax_line_search` transcribes it line for line, trip j's rollout read from
row j of the grid.  `first_accept_plain` is held bit for bit against it,
`alpha_grid` against the step lengths it hands its rollouts, and whole
solves on the grid against the JAX batched Pallas solver in interpret mode.
The kernels themselves: tests/test_torch_kernel_sources.py (emulated) and
tests/test_torch_gpu.py (on the card).
"""

import functools

import numpy as np
import pytest
import torch

from learningagileflight_se3_torch.config import CostWeights, QuadParams, SolverConfig
from learningagileflight_se3_torch.ops import rollout
from learningagileflight_se3_torch.ops import line_search as ls_grid
from learningagileflight_se3_torch.ops.inputs import bench_problems
from learningagileflight_se3_torch.solver import ilqr_batched
from learningagileflight_se3_torch.solver.ilqr import make_batched_mpc_solver
from learningagileflight_se3_torch.utils import graphs

H, B = 6, 9
NZ, NU = 17, 4

# (ladder config, how the search's lanes are set up); see `search_case`
CASES = {
    "full_ladder": dict(cfg=dict(ls_max_trips=14)),
    "adaptive_ls0": dict(cfg=dict(ls_max_trips=14), ls0=True),
    "deep_stride4": dict(cfg=dict(ls_max_trips=4), ls0=True, deep=True, out_of_trips=True),
    "deep_stride5": dict(cfg=dict(ls_max_trips=5), ls0=True, deep=True, out_of_trips=True),
    "skip_lanes": dict(cfg=dict(ls_max_trips=4), ls0=True, deep=True, skip=True),
    "nan_lane": dict(cfg=dict(ls_max_trips=14), ls0=True, nan=True),
    "none_accepts": dict(cfg=dict(ls_max_trips=4), ls0=True, deep=True, none=True),
}


def _solver(**kw):
    return make_batched_mpc_solver(QuadParams(), CostWeights(), SolverConfig(horizon=H, **kw))


def search_case(name, dtype, seed=0, B=B):
    """(solver, the search's inputs, the per-trip rollouts Zn (T,H,17,B), Un
    (T,H,4,B), Jn (T,B)): random trajectories and costs, a decrease about as
    large as expected on some trials and not on others.  With "out_of_trips"
    lane 0 (ls0 12, not deep: out of rungs after 2 trips) fails its live
    trips and passes every later one, while lane 1 (deep) fails every trip
    and keeps the search going."""
    c = CASES[name]
    solver = _solver(**c["cfg"])
    T = solver.n_trips
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64)  # noqa: E731
    Z, U = r(H + 1, NZ, B), r(H, NU, B)
    J = 10.0 + r(B).abs()
    dV1, dV2 = -(r(B).abs() + 0.1), 0.3 * r(B)
    Zn, Un = r(T, H, NZ, B), r(T, H, NU, B)
    # decrease against the expected one at full step, scaled: a mix of passes and failures
    Jn = J - (-(dV1 + dV2)) * (0.25 * r(T, B))
    ls0 = torch.zeros(B, dtype=torch.int32)
    if c.get("ls0"):
        ls0 = torch.randint(0, 13, (B,), generator=g, dtype=torch.int32)
    deep = torch.zeros(B, dtype=torch.bool)
    if c.get("deep"):
        deep[[1, 4, 7]] = True
    skip = torch.zeros(B, dtype=torch.bool)
    if c.get("skip"):
        skip[[2, 4, 8]] = True
        deep[4] = False  # `deep` lanes are active ones
    if c.get("out_of_trips"):
        ls0[0], deep[0] = 12, False
        Jn[:2, 0] = J[0] + 1.0
        Jn[2:, 0] = J[0] - 100.0
        Jn[:, 1] = J[1] + 1.0
    if c.get("nan"):
        Jn[1:, 3] = float("nan")
        dV2[5] = float("nan")
    if c.get("none"):
        Jn = J + r(T, B).abs()
    cast = lambda t: t.to(dtype) if t.is_floating_point() else t  # noqa: E731
    args = [cast(t) for t in (Z, U, J, dV1, dV2)] + [ls0, deep, skip]
    return solver, args, [cast(t) for t in (Zn, Un, Jn)]


def jax_line_search(solver, args, grid, alphas_seen=None):
    """The JAX package's line search, transcribed line for line from the
    `line_search` closure of learningagileflight_se3_tpu/solver/ilqr_batched.py
    (`make_batched_mpc_solver_pallas`) in the port's layout (batch last):
    its `lax.while_loop` as a host loop, trip j's `forward` read from row j
    of the grid.  Returns (accepted, Zb, Ub, Jb, acc_idx, ls_trips)."""
    Z, U, J, dV1, dV2, ls0, deep, skip = args
    Zn_grid, Un_grid, Jn_grid = grid
    alphas_seen = [] if alphas_seen is None else alphas_seen
    cfg = solver.cfg

    def forward(alpha):
        j = len(alphas_seen)
        alphas_seen.append(alpha.clone())
        return torch.cat([Z[:1], Zn_grid[j]]), Un_grid[j], Jn_grid[j]

    n_alpha = cfg.line_search_steps
    stride = cfg.ls_max_trips
    n_deep = -(-n_alpha // stride)
    dtype = J.dtype
    tiny = torch.tensor(1e-300 if dtype == torch.float64 else 1e-30, dtype=dtype)
    alphas = torch.tensor(0.5 ** np.arange(cfg.line_search_steps), dtype=dtype)
    max_trips = torch.where(deep, n_deep, cfg.ls_max_trips)

    def cond(st):
        accepted, i, _, _, _ = st
        return bool(torch.any(
            (~accepted)
            & (torch.where(deep, i * stride, ls0 + i) < n_alpha)
            & (i < max_trips)
        ))

    def body(st):
        accepted, i, Zb, Ub, Jb = st
        alpha = alphas[torch.minimum(
            torch.where(deep, i * stride, ls0 + i), torch.tensor(n_alpha - 1)).long()]  # (B,)
        Zn, Un, Jn = forward(alpha)
        expected = -(alpha * dV1 + alpha * alpha * dV2)
        ok = (
            (Jn < J)
            & (expected > 0)
            & ((J - Jn) / torch.maximum(expected, tiny) > 0.1)
            & ~accepted
        )
        Zb = torch.where(ok, Zn, Zb)
        Ub = torch.where(ok, Un, Ub)
        Jb = torch.where(ok, Jn, Jb)
        active = ((~accepted)
                  & (torch.where(deep, i * stride, ls0 + i) < n_alpha)
                  & (i < max_trips))
        return (accepted | ok, i + active.to(i.dtype), Zb, Ub, Jb)

    st = (skip, torch.zeros(J.shape[0], dtype=torch.int32), Z, U, J)
    while cond(st):
        st = body(st)
    accepted, i_fin, Zb, Ub, Jb = st
    acc_idx = torch.where(
        accepted,
        torch.minimum(torch.where(deep, (i_fin - 1) * stride, ls0 + i_fin - 1),
                      torch.tensor(n_alpha - 1)),
        ls0,
    )
    return accepted, Zb, Ub, Jb, acc_idx, torch.max(i_fin)


def _ladder_of(solver):
    cfg = solver.cfg
    return ls_grid.Ladder(cfg.line_search_steps, cfg.ls_max_trips, solver.n_deep)


def grid_alpha(solver, args):
    Z, U, J, dV1, dV2, ls0, deep, skip = args
    alphas = 0.5 ** torch.arange(solver.cfg.line_search_steps, dtype=J.dtype)
    return ls_grid.alpha_grid(alphas, ls0, deep, solver.n_trips, _ladder_of(solver))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", list(CASES))
def test_first_accept_plain_equals_the_ladder(case, dtype):
    """K5's plain version on the grid's costs against the JAX package's
    ladder (`jax_line_search`) on the same per-trip rollouts: accepted, Zb,
    Ub, Jb, acc_idx and the trips, bit for bit (torch.equal, NaN where
    NaN)."""
    solver, args, grid = search_case(case, dtype)
    want = jax_line_search(solver, args, grid)
    Z, U, J, dV1, dV2, ls0, deep, skip = args
    got = ls_grid.first_accept(Z, U, J, *grid, grid_alpha(solver, args), dV1, dV2, ls0, deep, skip,
                               _ladder_of(solver))
    for name, a, b in zip(("accepted", "Zb", "Ub", "Jb", "acc_idx", "ls_trips"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b) or torch.equal(a.isnan(), b.isnan()) and torch.equal(
            a.nan_to_num(), b.nan_to_num()), name
    accepted, _, _, Jb, _, trips = want
    if case == "none_accepts":
        assert not bool(accepted.any()) and torch.equal(Jb, J)
    else:
        assert bool((accepted & ~skip).any())
    if CASES[case].get("out_of_trips"):
        # lane 0 accepted on a trip after its last live one, at its clamped step
        assert bool(accepted[0]) and not bool(accepted[1]) and float(Jb[0]) == float(grid[2][2, 0])
        assert int(trips) >= solver.n_deep
    if CASES[case].get("skip"):
        assert bool(accepted[skip].all()) and torch.equal(Jb[skip], J[skip])


@pytest.mark.parametrize("case", list(CASES))
def test_alpha_grid_is_the_ladders_step_lengths(case):
    """Where no trial is accepted, every lane that enters the JAX ladder
    takes at trip j the step length alpha_grid gives it at row j (past its
    last live trip, its clamped one); the ladder runs as many trips as its
    deepest lane has rungs and trips for, at most the grid's rows."""
    solver, args, (Zn, Un, Jn) = search_case(case, torch.float64)
    J, ls0, deep, skip = args[2], args[5], args[6], args[7]
    seen = []
    jax_line_search(solver, args, (Zn, Un, J + 1.0 + 0.0 * Jn), seen)
    alpha = grid_alpha(solver, args)
    assert alpha.shape == (solver.n_trips, B)
    n_alpha, stride, n_deep = _ladder_of(solver)

    def trips(b):  # a lane's trips while it has a rung and a trip left
        n = 0
        while (n * stride if deep[b] else int(ls0[b]) + n) < n_alpha and n < (n_deep if deep[b] else stride):
            n += 1
        return n

    assert len(seen) == max(trips(b) for b in range(B) if not skip[b]) <= solver.n_trips
    for j, a in enumerate(seen):
        assert torch.equal(a[~skip], alpha[j][~skip]), j


def test_the_search_takes_the_ladder_on_the_cpu_and_over_the_limit():
    """The rule, in `first_accept` alone: its plain version for CPU tensors
    (K5 for CUDA tensors, and a ValueError past the card's `max_lanes`:
    tests/test_torch_gpu.py::test_bench_point_runs_on_the_grid).  A CPU
    solve rolls each trial out with the plain K1, n_trips of them a DDP
    iteration, and takes the plain rule once an iteration."""
    solver = _solver(max_iters=3)
    T = solver.n_trips
    solver_case, args, grid = search_case("full_ladder", torch.float64)
    Z, U, J, dV1, dV2, ls0, deep, skip = args
    n = ls_grid.plain_calls
    ls_grid.first_accept(Z, U, J, *grid, grid_alpha(solver_case, args), dV1, dV2, ls0, deep, skip,
                         _ladder_of(solver_case))
    assert ls_grid.plain_calls == n + 1
    s, p, _ = solver.setup(*bench_problems(2, "cpu", seed=1))
    n1, n5 = rollout.plain_calls, ls_grid.plain_calls
    end = solver.run_blocks(s, p, 3, k=3)
    assert rollout.plain_calls - n1 == 3 * T and ls_grid.plain_calls - n5 == 3
    assert int(end.ls_n) > 0


LADDERS = {"full": dict(ls_max_trips=14, ls_adaptive=False), "cap4": dict(ls_max_trips=4, ls_adaptive=True)}


@functools.cache
def _jax_solver(ladder_name):
    """The JAX batched Pallas solver (interpret mode) at H=6, 12 iterations,
    with the ladder `ladder_name`, jitted once: every start passes U_init,
    so both starts share one compile."""
    import jax

    from learningagileflight_se3_tpu import config as jcfg
    from learningagileflight_se3_tpu.solver.ilqr_batched import make_batched_mpc_solver_pallas

    cfg = jcfg.SolverConfig(horizon=6, max_iters=12, **LADDERS[ladder_name])
    solve = make_batched_mpc_solver_pallas(jcfg.QuadParams(), jcfg.CostWeights(), cfg, interpret=True)
    return jax.jit(solve), 0.5 * (cfg.u_lb + cfg.u_ub)


@functools.cache
def _jax_solution(ladder_name, start):
    """The JAX solver's solution on tests/test_solver.py::TestBatchedPallasSolver's
    128 problems (default_rng(0)); "cold" starts from the solver's own
    hover controls, 0.5 (u_lb + u_ub), handed over as U_init (what it takes
    without one), "warm" from the cold solution's controls shifted a step.
    (solution, U_init for the port's solve or None)."""
    import jax.numpy as jnp
    from test_torch_solver import _problems

    psolve, hover = _jax_solver(ladder_name)
    args = [jnp.asarray(a) for a in _problems(np.random.default_rng(0), 128)]
    if start == "cold":
        return psolve(*args, U_init=jnp.full((128, 6, NU), hover, jnp.float64)), None
    U = np.asarray(_jax_solution(ladder_name, "cold")[0].control_traj)
    U_init = np.concatenate([U[:, 1:], U[:, -1:]], axis=1)
    return psolve(*args, U_init=jnp.asarray(U_init)), U_init


@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("ladder_name", list(LADDERS))
def test_solve_on_the_grid_equals_the_eager_ladder(ladder_name, start):
    """Whole solves on the grid (the plain K1 trial by trial, then
    first_accept_plain) against the JAX batched Pallas solver in interpret
    mode, with the full ladder and the adaptive capped one that escalates
    to the deep ladder, cold and warm: the setup and gates of
    tests/test_torch_solver.py::test_solver_matches_jax_pallas_interpret.
    The eager and blocks drives agree bit for bit in every state field.
    (JAX is imported here: tests/test_torch_gpu.py, which runs where there
    is no JAX, imports this module's search cases.)"""
    from test_torch_solver import _problems, _torch_args

    ps, U_init = _jax_solution(ladder_name, start)
    solver = make_batched_mpc_solver(QuadParams(), CostWeights(),
                                     SolverConfig(horizon=6, max_iters=12, **LADDERS[ladder_name]))
    args = _torch_args(_problems(np.random.default_rng(0), 128))
    kw = {} if U_init is None else dict(U_init=torch.tensor(U_init, dtype=torch.float64))
    eager = solver.run_eager(*solver.setup(*args, **kw))
    blocks = solver.run_blocks(*solver.setup(*args, **kw))
    assert [f for f, a, b in zip(eager._fields, eager, blocks) if not torch.equal(a, b)] == []
    ts = solver.solution(eager)
    np.testing.assert_array_equal(ts.iterations.numpy(), np.asarray(ps.iterations))
    np.testing.assert_array_equal(ts.status.numpy(), np.asarray(ps.status))
    Jp = np.asarray(ps.cost)
    rel = np.abs(ts.cost.numpy() - Jp) / np.maximum(np.abs(Jp), 1.0)
    assert (rel < 5e-5).mean() >= 0.97, f"cost-agreeing lanes {(rel < 5e-5).mean():.2%}"
    assert rel.max() < 1e-2, f"cost diverged beyond 1%: {rel.max()}"
    dU = np.abs(ts.control_traj.numpy() - np.asarray(ps.control_traj)).max(axis=(1, 2))
    assert (dU < 1e-6).mean() >= 0.95, f"control-agreeing lanes {(dU < 1e-6).mean():.2%}"
    assert int(eager.ls_n) > 0


def test_grid_iteration_with_go_false_changes_nothing():
    """An iteration gated off (`go` False, as past the loop's exit) returns
    the state unchanged, its line search on the grid included."""
    solver = _solver(max_iters=5, ls_max_trips=4, ls_adaptive=True)
    s, p, cap = solver.setup(*bench_problems(4, "cpu", seed=2))
    s = solver.run_blocks(s, p, cap, k=2)
    out = solver.iteration(s, p, torch.tensor(False))
    assert [f for f, a, b in zip(s._fields, s, out) if not torch.equal(a, b)] == []


def test_grid_counter_only_with_spans_on_a_card():
    """The solver's "ls.grid" counter is made only where spans are on and
    the device is a card: a CPU solve with spans on counts nothing there."""
    from learningagileflight_se3_torch.utils.profiling import spans

    assert ilqr_batched.grid_counter("cpu") is None
    assert not spans.on and ilqr_batched.grid_counter("cuda") is None
    solver = _solver(max_iters=2)
    spans.enable("cpu")
    try:
        solver(*bench_problems(2, "cpu", seed=1))
        assert "ls.grid" not in spans.collect()["counters"]
    finally:
        spans.disable()
    assert graphs.eager_on_card is False
