"""The flight loop's device-resident drives on the CPU.

On the card the solver's DDP loop inside a tick or a flight step, and the
closed loop's 500-step `scan`, run as CUDA graphs whose loops are chains of
conditional blocks (utils/graphs.py `while_blocks`, drive "chain"): a
block past a loop's exit is skipped on the device.  That is exact only
because every update of an iteration is gated, so a block run past the
exit leaves the carry bit for bit as it was.  Here, with no capture, the
"blocks" drive runs every block of what the chains capture, and these
tests hold it bit for bit against the eager loops (a host test before each
iteration), in f64 at a small size: the solver's chain (cold and warm, the
exit by tolerance and at the cap, a lane whose state is not finite, a
block run after the exit) and the closed loop's step graphs' code (B=4, 23
steps: three replans and a partial period, with and without the Kalman
filter).  The t-solver's fixed point is one kernel on the card (K4) and
its eager loop on the CPU under every drive: lanes that converge at
different iterations, a lane that meets the cap, a lane whose state is not
finite.  The Kalman step, whose gain is now the closed-form 4x4 Cholesky,
is held against the JAX filter to 1e-10.  The graphs themselves are tested
on the card (tests/test_torch_gpu.py, chip_smoke.py phase 19).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from learningagileflight_se3_tpu.sim import estimator as jest

from learningagileflight_se3_torch.config import CostWeights, QuadParams, SolverConfig
from learningagileflight_se3_torch.ops.inputs import bench_problems
from learningagileflight_se3_torch.sim import estimator as kal
from learningagileflight_se3_torch.sim.closed_loop import make_closed_loop_sim
from learningagileflight_se3_torch.sim.tsolver import TraversalTimeSolver, make_traversal_time_solver
from learningagileflight_se3_torch.solver import ilqr_batched
from learningagileflight_se3_torch.solver.ilqr import make_batched_mpc_solver
from learningagileflight_se3_torch.utils import graphs
from learningagileflight_se3_torch.utils.weights import bench_scenarios, bench_scenarios_path, load_dnn2

def _same(a, b):
    """Equal bit for bit, NaN where NaN."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(torch.isnan(a), torch.isnan(b)) and \
        torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


def _unequal(x, y):
    return [name for name, a, b in zip(x._fields, x, y) if not _same(a, b)]


@pytest.fixture(scope="module")
def dnn2():
    return load_dnn2().double()


def _tsolver_args(n=10, seed=7):
    """n flight situations along the approach to a moving gate; lane 3's
    state is not finite."""
    r = np.random.default_rng(seed)
    state = np.zeros((n, 13))
    state[:, 0:3] = r.normal(size=(n, 3)) * [1.5, 0.5, 0.8] + [0.0, -6.0, 0.0]
    state[:, 1] += np.linspace(0.0, 5.0, n)
    state[:, 3:6] = r.normal(size=(n, 3)) + [0.0, 2.0, 0.0]
    q = r.normal(size=(n, 4)) * 0.2
    q[:, 0] += 1.0
    state[:, 6:10] = q / np.linalg.norm(q, axis=1, keepdims=True)
    state[3, 0] = np.nan
    final = r.normal(size=(n, 3)) + [0.0, 6.0, 0.0]
    pts = np.array([[-0.5, 0.0, 1.0], [0.5, 0.0, 1.0], [0.5, 0.0, -1.0], [-0.5, 0.0, -1.0]])
    pts = pts[None] + r.normal(size=(n, 1, 3)) * 0.5
    velo = np.array([1.0, 0.3, 0.4]) + r.normal(size=(n, 3)) * 0.1
    w = np.pi / 2 + r.normal(size=n) * 0.2
    return [torch.tensor(a) for a in (state, final, pts, velo, w)]


# (accel, tol, cap): some lanes converge before the cap, at different
# iterations, and some meet it
TSOLVE_CASES = [("reference", 1e-6, 20), ("secant", 1e-9, 3)]


@pytest.mark.parametrize("accel,tol,CAP", TSOLVE_CASES, ids=[c[0] for c in TSOLVE_CASES])
def test_tsolver_blocks_equal_eager(accel, tol, CAP, dnn2):
    """On the CPU every drive a caller may name ("eager", the step graphs'
    "blocks", none) runs the eager loop: the same t bit for bit, a host
    read per loop test and [0, iterations] on the counter.  The lanes
    converge at different iterations, one meets the cap, lane 3 is NaN."""
    args = _tsolver_args()
    live_at = []  # per cap m, which lanes are still live after m iterations
    for m in range(CAP + 1):
        s = make_traversal_time_solver(dnn2, tol=tol, max_iters=m, accel=accel)
        live_at.append(s.run(*s._args(*args)).live)
    live_at = torch.stack(live_at)
    converged_at = [int((~live_at[:, i]).to(torch.int8).argmax()) for i in range(10) if not live_at[-1, i]]
    assert not live_at[0, 3], "the NaN lane is live"
    assert bool(live_at[-1].any()), "no lane meets the cap"
    assert len(set(converged_at) - {0}) >= 2, f"lanes converge together: {converged_at}"

    solver = make_traversal_time_solver(dnn2, tol=tol, max_iters=CAP, accel=accel)
    end = solver.run(*solver._args(*args))
    assert int(end.it) == CAP
    for drive in ("eager", "blocks", None):
        solver.count = torch.zeros(2, dtype=torch.int32)
        n = graphs.host_reads
        with torch.no_grad():
            t = solver(*args, drive=drive)
        assert _same(t, end.t1), drive
        assert graphs.host_reads - n == CAP + 1 and solver.count.tolist() == [0, CAP], drive


@pytest.mark.parametrize("warm", [False, True])
def test_solver_block_after_the_exit_is_a_no_op(warm):
    """A whole block (GRAPH_BLOCK gated iterations) run on the eager loop's
    final state leaves every field as it was, cold and warm-started; and the
    chain's blocks drive equals the eager loop."""
    solver = make_batched_mpc_solver(QuadParams(), CostWeights(),
                                     SolverConfig(horizon=10, max_iters=9, tol=1e-4, gtol=3e-4,
                                                  no_progress_iters=10, ls_max_trips=4, ls_adaptive=True))
    args = bench_problems(6, "cpu", seed=2)
    U_init = None
    if warm:
        U = solver(*args).control_traj
        U_init = torch.cat([U[:, 1:], U[:, -1:]], dim=1)
    s, p, cap = solver.setup(*args, U_init=U_init)
    end = solver.run_eager(s, p, cap)
    assert not bool(ilqr_batched.live_any(end))
    again = solver.run_block(end, p, ilqr_batched.GRAPH_BLOCK)
    assert _unequal(again, end) == []
    n = graphs.host_reads
    chain = solver.run_chain(*solver.setup(*args, U_init=U_init), drive="blocks")
    assert graphs.host_reads == n
    assert _unequal(chain, end) == []
    sol = solver(*args, U_init=U_init, drive="blocks")
    assert _unequal(sol, solver.solution(end)) == []


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("exit_by", ["tolerance", "cap"])
def test_solver_chain_blocks_equal_eager(exit_by, warm):
    """The chain's blocks drive (every conditional block of GRAPH_BLOCK
    gated iterations run, no host read) against the eager loop on the
    solver's body, every field bit for bit: the lanes end at different
    iterations, lane 3's state is not finite, and the loop ends with every
    lane out or at a cap that is no multiple of the block, so the last
    block runs iterations past the cap.  One more block after the exit
    changes nothing."""
    solver = make_batched_mpc_solver(QuadParams(), CostWeights(),
                                     SolverConfig(horizon=10, max_iters=30, tol=1e-4, gtol=3e-4,
                                                  no_progress_iters=10, ls_max_trips=4, ls_adaptive=True))
    args = list(bench_problems(6, "cpu", seed=5))
    args[0] = args[0].clone()
    args[0][3, 0] = float("nan")
    U_init = None
    if warm:
        U = solver(*args).control_traj
        U_init = torch.cat([U[:, 1:], U[:, -1:]], dim=1)
    cap = 90 if exit_by == "tolerance" else 15
    assert cap % ilqr_batched.GRAPH_BLOCK
    end = solver.run_eager(*solver.setup(*args, U_init=U_init, max_iters=cap))
    it = end.it.tolist()
    assert len(set(it)) >= 2, f"the lanes end together: {it}"
    # status 0: still running when the loop ended, so stopped by the cap
    assert (max(it) == cap) == bool((end.st == 0).any()) == (exit_by == "cap"), (it, end.st.tolist())
    assert not bool(torch.isfinite(end.J[3])) and bool(torch.isfinite(end.J[torch.arange(6) != 3]).all())
    n = graphs.host_reads
    chain = solver.run_chain(*solver.setup(*args, U_init=U_init, max_iters=cap), drive="blocks")
    assert graphs.host_reads == n
    assert _unequal(chain, end) == []
    s, p, _ = solver.setup(*args, U_init=U_init, max_iters=cap)
    again = graphs.while_blocks(chain, ilqr_batched.live_any, lambda st, go: solver.iteration(st, p, go),
                                ilqr_batched.GRAPH_BLOCK, 1, "blocks")
    assert _unequal(again, end) == []


@pytest.fixture(scope="module")
def flights(dnn2):
    """Seed 2024's first 4 exported scenarios for 23 steps (three replans and
    a partial period), f64, H=10, under each drive, with and without the
    Kalman filter (its observation noise handed over)."""
    scen, noise = bench_scenarios(bench_scenarios_path(2024))
    scen, noise = scen[:4], noise[:4, :23]
    obs_noise = 0.01 * np.random.default_rng(11).normal(size=(4, 23, 4, 3))
    out, real, tsolve_reads = {}, TraversalTimeSolver.run, []

    def spy(*a, **kw):  # the host reads of the t-solver's eager loops
        n = graphs.host_reads
        end = real(*a, **kw)
        tsolve_reads.append((graphs.host_reads - n, int(end.it)))
        return end

    for kalman in (False, True):
        sim = make_closed_loop_sim(dnn2, solver_cfg=SolverConfig(horizon=10, max_iters=10, tol=1e-4, gtol=3e-4,
                                                                 no_progress_iters=10),
                                   steps=23, estimate_gate_motion=kalman, device="cpu", dtype=torch.float64)
        for drive in ("eager", "blocks"):
            n = graphs.host_reads
            tsolve_reads.clear()
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(TraversalTimeSolver, "run", spy)
                log = sim(scen, gate_noise=noise, obs_noise=obs_noise if kalman else None, drive=drive)
            out[kalman, drive] = log, graphs.host_reads - n, list(tsolve_reads)
    return out


@pytest.mark.parametrize("kalman", [False, True], ids=["true velocity", "Kalman filter"])
def test_closed_loop_blocks_equal_the_eager_step_loop(kalman, flights):
    """Every ClosedLoopLog field equal bit for bit: the step graphs' code
    (static buffers, the hold and replan steps, every conditional block of
    the solves run) against the eager step loop; the blocks drive reads
    from the card only at the loop tests of the fixed points (K4 on the
    card, the eager loop here), one a step more than its iterations, the
    eager drive at every loop test of the solves too."""
    (blocks, reads_b, ts_b), (eager, reads_e, ts_e) = flights[kalman, "blocks"], flights[kalman, "eager"]
    assert _unequal(blocks, eager) == []
    assert ts_b == ts_e and len(ts_b) == 23 and all(r == it + 1 for r, it in ts_b)
    assert reads_b == sum(r for r, _ in ts_b) and reads_e > reads_b + 23
    it = eager.solver_iters
    assert bool((it[:, [0, 10, 20]] > 0).all()) and int((it > 0).sum()) == 12
    assert bool(torch.isfinite(eager.states).all())
    if kalman:  # the filter's estimate, not the true velocity, fed the planner
        assert not torch.equal(eager.gate_vel_used, flights[False, "eager"][0].gate_vel_used)


def test_kalman_step_with_the_cholesky_gain_matches_jax():
    """200 predict-and-update steps of 5 filters on noisy observations of a
    gate that moves and turns, f64: the port's closed-form 4x4 Cholesky gain
    against the JAX filter's solve, states and covariances within 1e-10."""
    r = np.random.default_rng(4)
    t = np.arange(200) * 0.01
    center = np.array([0.5, 3.0, 1.0]) + t[:, None] * np.array([1.0, 0.3, 0.4])
    obs = np.concatenate([center, (0.3 + 1.5 * t)[:, None]], axis=1)
    obs = obs[None] + r.normal(size=(5, 200, 4)) * 0.01
    kstep_j, kstep_t = jax.jit(jax.vmap(jest.make_kalman_step(dt=0.01))), kal.make_kalman_step(dt=0.01)
    ks_j = jax.vmap(lambda o: jest.kalman_init(o, dtype=jnp.float64))(jnp.asarray(obs[:, 0]))
    ks_t = kal.kalman_init(torch.tensor(obs[:, 0]), dtype=torch.float64)
    for i in range(1, 200):
        ks_j = kstep_j(ks_j, jnp.asarray(obs[:, i]))
        ks_t = kstep_t(ks_t, torch.tensor(obs[:, i]))
    np.testing.assert_allclose(ks_t.x.numpy(), np.asarray(ks_j.x), rtol=0, atol=1e-10)
    np.testing.assert_allclose(ks_t.P.numpy(), np.asarray(ks_j.P), rtol=0, atol=1e-10)
