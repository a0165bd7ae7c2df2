"""The line search on the (trip, lane) grid against the solver's ladder, on the CPU.

On the card, where the n_trips x B trials of a line search take at most one
K1 block per SM, the solver rolls every trial out in one K1 launch and K5
(`csrc/line_search.cu`) replays the ladder's recurrence over the trial axis
(`ops/line_search.py`).  Here the plain versions stand in for both kernels:
`first_accept_plain` is held bit for bit against the ladder
(`BatchedSolver.line_search`, the loop the graph drives capture) fed the same
per-trip rollouts, `alpha_grid` against the step lengths the ladder hands
K1, and whole solves on the grid against the eager loop.  The kernels
themselves: tests/test_torch_kernel_sources.py (emulated) and
tests/test_torch_gpu.py (on the card).
"""

import pytest
import torch

from learningagileflight_se3_torch.config import CostWeights, QuadParams, SolverConfig
from learningagileflight_se3_torch.ops import line_search as ls_grid
from learningagileflight_se3_torch.ops import rollout
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


def ladder(solver, args, grid, alphas_seen=None):
    """The solver's ladder (no host test, as the graph drives run it) with
    trip j's rollout taken from row j of the grid."""
    Z, U, J, dV1, dV2, ls0, deep, skip = args
    Zn, Un, Jn = grid

    def forward(Z_, U_, kk, KK, p, alpha):
        j = len(alphas_seen)
        alphas_seen.append(alpha.clone())
        return torch.cat([Z_[:1], Zn[j]]), Un[j], Jn[j]

    alphas_seen = [] if alphas_seen is None else alphas_seen
    solver.forward = forward
    try:
        return solver.line_search(Z, U, J, None, None, None, dV1, dV2, ls0, deep, skip, sync=False)
    finally:
        del solver.forward


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
    """K5's plain version on the grid's costs against the ladder on the
    same per-trip rollouts: accepted, Zb, Ub, Jb, acc_idx and the trips,
    bit for bit (torch.equal, NaN where NaN)."""
    solver, args, grid = search_case(case, dtype)
    want = ladder(solver, args, grid)
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
    """Where no trial is accepted, every lane that enters the search takes
    at trip j the step length alpha_grid gives it at row j (past its last
    live trip, its clamped one); the ladder runs as many trips as the
    grid's deepest lane needs."""
    solver, args, (Zn, Un, Jn) = search_case(case, torch.float64)
    J, skip = args[2], args[7]
    seen = []
    ladder(solver, args, (Zn, Un, J + 1.0 + 0.0 * Jn), seen)
    alpha = grid_alpha(solver, args)
    assert alpha.shape == (solver.n_trips, B)
    assert len(seen) == solver.n_trips
    for j, a in enumerate(seen):
        assert torch.equal(a[~skip], alpha[j][~skip]), j


def test_the_search_takes_the_ladder_on_the_cpu_and_over_the_limit(monkeypatch):
    """The rule: the grid on a card whose K5 holds the batch's lanes (its
    limit read from the card: `max_lanes`, here set to 2,304), never on the
    CPU.  On the CPU the solver's line search runs K1 once a trip."""
    monkeypatch.setattr(ls_grid, "max_lanes", lambda index: 2304)
    assert ls_grid.holds(1, "cuda:0") and ls_grid.holds(2304, "cuda:0") and not ls_grid.holds(2305, "cuda:0")
    assert not ls_grid.holds(1, "cpu")
    solver = _solver(max_iters=3)
    args = bench_problems(2, "cpu", seed=1)
    s, p, _ = solver.setup(*args)
    called = []
    real = solver.line_search_grid
    solver.line_search_grid = lambda *a: called.append(1) or real(*a)
    n = rollout.plain_calls
    end = solver.run_blocks(s, p, 3, k=3)
    assert called == [] and rollout.plain_calls - n == 3 * solver.n_trips
    assert int(end.ls_n) > 0


LADDERS = {"full": dict(ls_max_trips=14, ls_adaptive=False), "cap4": dict(ls_max_trips=4, ls_adaptive=True)}


@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("ladder_name", list(LADDERS))
def test_solve_on_the_grid_equals_the_eager_ladder(monkeypatch, ladder_name, start):
    """Whole solves (H=6, B=8, f64, 12 iterations) with every line search
    on the grid (the rule forced on the CPU: the plain K1 trial by trial,
    then first_accept_plain), under the blocks drive, against the eager
    loop's ladder: every state field equal bit for bit, KK, ls_n, it, st
    and reg included."""
    solver = _solver(max_iters=12, tol=1e-4, gtol=3e-4, no_progress_iters=10, **LADDERS[ladder_name])
    args = bench_problems(8, "cpu", seed=1)
    U_init = None
    if start == "warm":
        U = solver.solution(solver.run_eager(*solver.setup(*args))).control_traj
        U_init = torch.cat([U[:, 1:], U[:, -1:]], dim=1)
    eager = solver.run_eager(*solver.setup(*args, U_init=U_init))
    used = []
    monkeypatch.setattr(ls_grid, "holds", lambda b, device: used.append(b) or True)
    blocks = solver.run_blocks(*solver.setup(*args, U_init=U_init), k=4)
    assert used and set(used) == {8}
    assert [f for f, a, b in zip(eager._fields, eager, blocks) if not torch.equal(a, b)] == []
    assert int(eager.ls_n) > 0


def test_grid_iteration_with_go_false_changes_nothing(monkeypatch):
    """An iteration gated off (`go` False, as past the loop's exit) whose
    line search runs on the grid returns the state unchanged."""
    monkeypatch.setattr(ls_grid, "holds", lambda *a: True)
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
