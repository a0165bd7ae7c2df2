"""The batched solver's device-side loop (solver/ilqr_batched.py) on the CPU.

On the card the DDP iterations run as replays of a captured CUDA graph of
`GRAPH_BLOCK` iterations, each line search as a fixed number of trips,
with every trip and iteration gated on the device so that the ones run past
the loop's exit change nothing.  Here, with no capture, `run_blocks` runs
the same blocks on the graph loop's schedule (block n+1 before block n's
flag is read), so these tests hold the code that is captured bit for bit
against the eager host loop (`run_eager`, which stops at a host test), in
f64 at H=10, B=8 on bench.py-style scenarios.  The JAX Pallas comparison of
both loops is tests/test_torch_solver.py's.  The graph itself is tested
on the card (tests/test_torch_gpu.py, chip_smoke.py phase 18); which solves
run as graphs is tested here.
"""

import pytest
import torch

from learningagileflight_se3_torch.config import CostWeights, QuadParams, SolverConfig
from learningagileflight_se3_torch.ops.inputs import bench_problems
from learningagileflight_se3_torch.solver import ilqr_batched
from learningagileflight_se3_torch.solver.ilqr import make_batched_mpc_solver
from learningagileflight_se3_torch.utils import graphs

H, B = 10, 8
LADDERS = {  # the golden run's full ladder; bench.py's 4-trip cap, whose failing lanes go deep
    "full": dict(ls_max_trips=14, ls_adaptive=False),
    "cap4": dict(ls_max_trips=4, ls_adaptive=True),
}
_eager = {}


def _solver(**kw):
    return make_batched_mpc_solver(QuadParams(), CostWeights(), SolverConfig(horizon=H, **kw))


def _equal_fields(a, b):
    """The fields of two states (or solutions) that are not equal bit for bit."""
    return [name for name, x, y in zip(a._fields, a, b) if not torch.equal(x, y)]


def _case(ladder, nprog, start):
    """(solver, problem, U_init, the eager loop's final state, the line
    searches' `deep` flags seen by it): 16 iterations, tol 1e-4, gtol 3e-4;
    the warm start is the cold solution's controls shifted by one step."""
    key = (ladder, nprog, start)
    if key not in _eager:
        solver = _solver(max_iters=16, tol=1e-4, gtol=3e-4, no_progress_iters=nprog, **LADDERS[ladder])
        args = bench_problems(B, "cpu", seed=1)
        U_init = None
        if start == "warm":
            U = _case(ladder, nprog, "cold")[0].solution(_case(ladder, nprog, "cold")[3]).control_traj
            U_init = torch.cat([U[:, 1:], U[:, -1:]], dim=1)
        deep = []
        real = solver.line_search

        def spy(*a):
            deep.append(bool(a[9].any()))
            return real(*a)

        solver.line_search = spy
        end = solver.run_eager(*solver.setup(*args, U_init=U_init))
        del solver.line_search
        _eager[key] = (solver, args, U_init, end, deep)
    return _eager[key]


@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("nprog", [0, 10])
@pytest.mark.parametrize("ladder", list(LADDERS))
@pytest.mark.parametrize("k", [1, 3, 7])
def test_blocks_equal_eager_loop(k, ladder, nprog, start):
    """Every field of the state, so every MPCSolution field, equal bit for
    bit: the trips and iterations the blocks run past the eager loop's exits
    (at most the rest of a block and one more block) are no-ops."""
    solver, args, U_init, end, deep = _case(ladder, nprog, start)
    if ladder == "cap4":
        assert any(deep), "no lane went deep: the escalation path is not exercised"
    n = graphs.host_reads
    blocks = solver.run_blocks(*solver.setup(*args, U_init=U_init), k=k)
    assert _equal_fields(blocks, end) == []
    # the schedule reads at most one flag per block, and none after the last
    assert graphs.host_reads - n <= -(-16 // k) - 1
    sol_b, sol_e = solver.solution(blocks), solver.solution(end)
    assert _equal_fields(sol_b, sol_e) == []


def test_go_gate_keeps_a_floor_exit_lane():
    """The batch's last live lane (lane 7) ends in the progress-window floor
    exit on an improved step, so its trajectory moved in the final
    iteration.  Without the `go` gate an iteration run after the exit (as
    the block after the last live one is) recomputes every lane's projected
    gradient on the moved trajectory and changes that lane's grad_norm;
    with the gate the state comes back unchanged."""
    solver = _solver(max_iters=30, tol=1e-3, gtol=1e-12, no_progress_iters=2, ls_max_trips=14,
                     ls_adaptive=True)
    args = bench_problems(B, "cpu", seed=1)
    s, p, cap = solver.setup(*args)
    end = solver.run_blocks(s, p, cap, k=3)
    n = int(end.it.max())
    assert end.it.tolist().count(n) == 1 and int(end.it[7]) == n and int(end.st[7]) == 3
    before = solver.run_eager(*solver.setup(*args, max_iters=n - 1))
    assert not torch.equal(end.Z[..., 7], before.Z[..., 7]), "lane 7 did not move in its last iteration"

    go = ilqr_batched.live_any(end)
    assert not bool(go)
    assert _equal_fields(solver.iteration(end, p, go), end) == []
    ungated = solver.iteration(end, p, torch.tensor(True))
    assert float(ungated.pg[7]) != float(end.pg[7])
    # an eager loop, which stops at its host test, agrees with the blocks
    assert _equal_fields(solver.run_eager(*solver.setup(*args)), end) == []


@pytest.mark.parametrize("ladder", list(LADDERS))
def test_forced_extra_trips_change_nothing(ladder):
    """Trips forced past the last live one of every line search (10 more
    than any lane can take) are gated no-ops: ls_evals, iterations, status
    and every other field as in the eager loop.  Ungated, such a trip would
    still accept a lane that has used up its trips, at a deeper step."""
    solver, args, U_init, end, _ = _case(ladder, 10, "cold")
    trips = solver.n_trips
    solver.n_trips = trips + 10
    try:
        blocks = solver.run_blocks(*solver.setup(*args, U_init=U_init), k=3)
    finally:
        solver.n_trips = trips
    sol_b, sol_e = solver.solution(blocks), solver.solution(end)
    for name in ("ls_evals", "iterations", "status"):
        assert torch.equal(getattr(sol_b, name), getattr(sol_e, name)), name
    assert _equal_fields(sol_b, sol_e) == []


def test_which_solves_run_as_graphs():
    """The graph loop's rule (BatchedSolver.graphed): CUDA tensors with
    the sequential sweep, outside the watchers; the CPU, the parallel sweep
    (its torch.linalg.solve_ex cannot be captured) and solves inside
    watched_kernels take the eager loop."""
    from learningagileflight_se3_torch.solver.watch import watched_kernels

    seq = _solver(max_iters=4)
    par = _solver(max_iters=4, use_ddp=False, backward="parallel")
    cuda = torch.device("cuda")
    assert seq.graphed(cuda) and not seq.graphed("cpu") and not par.graphed(cuda)
    with watched_kernels(lambda *a: None):
        assert not seq.graphed(cuda)
    assert seq.graphed(cuda)
