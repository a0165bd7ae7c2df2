"""PyTorch port on a CUDA device: each hand-written kernel against its plain
PyTorch version on the card (also on the omega-box continuation's inputs),
K3 against K2, the kernel-backed solver against the plain solver, the RL
learning signals, the closed loop and the imitation
collect on the card against the CPU, the entry points' default device,
the flagship forward step on the kernels, and the solver's DDP loop as a
replayed CUDA graph against the eager host loop (equal field for field, no
aliasing, the launch counts, the parallel sweep, the watchers' eager
loop, a failed capture raising), and the flight loop's graphs (the
t-solver's chain, the tick's graph, the closed loop's step graphs) against
their eager drives.
Marked `gpu`; skipped where torch.cuda.is_available() is False.

This file imports neither JAX nor tests/conftest.py's fixtures, so it runs on
a machine without JAX:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_gpu.py
"""

import os

import numpy as np
import pytest
import torch

from learningagileflight_se3_torch.config import CostWeights, QuadParams, RewardConfig, SolverConfig
from learningagileflight_se3_torch.ops import build, riccati_fused, riccati_unfused, rollout
from learningagileflight_se3_torch.ops.inputs import as_tensors, main_path_inputs, with_failing_lanes
from learningagileflight_se3_torch.solver.ilqr import make_batched_mpc_solver
from learningagileflight_se3_torch.utils import graphs

pytestmark = pytest.mark.gpu

CONTRACT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "artifacts",
                        "replay_contract.npz")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(a, b):
    """max |a-b| / (|b| + 1e-2) over entries finite in both; NaN patterns
    must agree (tests/test_pallas.py::TestFusedRiccatiKernel's measure)."""
    a, b = a.double().cpu().numpy(), b.double().cpu().numpy()
    assert (np.isnan(a) == np.isnan(b)).all(), "NaN pattern"
    both = np.isfinite(a) & np.isfinite(b)
    return float(np.max(np.abs(a[both] - b[both]) / (np.abs(b[both]) + 1e-2), initial=0.0))


def test_kernels_build(cuda):
    lib = build.library()
    for kernel in ("rollout_kernel", "riccati_fused_kernel", "riccati_unfused_kernel"):
        assert kernel in lib.ptxas_log


@pytest.fixture(scope="module")
def main_path():
    """K1's and K2's inputs at H=50 and a ragged batch of 300 lanes: the
    solver's trajectories after 10 DDP iterations (see chip_smoke.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return main_path_inputs(50, 300, device="cuda", iters=10)


@pytest.fixture(scope="module", params=[1, 33, 300, 2048])
def main_path_b(request):
    """The same at B=1 (the tick: one warp of K2, one live scenario of K1's
    16 and K3's 8), B=33 (ragged: 33 is no multiple of K2's 4 warps, of K1's
    16 or K3's 8 scenarios a block or of their 16-byte copies), B=300 (the
    main_path fixture's) and B=2048 (the bench.py point)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if request.param == 300:
        return request.getfixturevalue("main_path")
    return main_path_inputs(50, request.param, device="cuda", iters=10)


def _assert_rollout_matches_plain(args, model, dtype, min_sane=0.95, **kw):
    """K1 against its plain version on `args` in `dtype`: one launch; on the
    lanes whose plain cost is sane (at least `min_sane` of them) 1e-9 in f64
    and tests/test_pallas.py::TestRolloutKernel's gates in f32."""
    args = [a.to(dtype) for a in args]
    n = rollout.launches
    Zn, Un, c = rollout.rollout_forward(*args, *model, **kw)
    torch.cuda.synchronize()
    assert rollout.launches == n + 1
    rZ, rU, rc = rollout.rollout_forward_plain(*args, *model, **kw)
    # lanes whose rollout blew up (the line search rejects them) are chaotic
    sane = torch.isfinite(rc) & (rc.abs() < 1e12)
    assert sane.double().mean() >= min_sane - 1e-12
    pairs = [(a[..., sane], b[..., sane]) for a, b in ((Un, rU), (Zn, rZ), (c, rc))]
    if dtype == torch.float64:
        for a, b in pairs:
            torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12)
    else:
        for (a, b), atol in zip(pairs, (2e-5, 2e-4, 1e-2)):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=atol)


def _assert_sweep_matches_plain(args, model, dtype, tols=None, **kw):
    """K2 against its plain version on `args` in `dtype`: one launch, the
    same lanes fail, 1e-8 in f64 and phase 3's gates in f32 (or `tols`)."""
    args = [a.to(dtype) for a in args]
    n = riccati_fused.launches
    out = riccati_fused.riccati_backward(*args, *model, **kw)
    torch.cuda.synchronize()
    assert riccati_fused.launches == n + 1
    ref = riccati_fused.riccati_backward_plain(*args, *model, **kw)
    tols = tols or (dict(kk=1e-8, KK=1e-8, dV1=1e-8, dV2=1e-8, pg=1e-8) if dtype == torch.float64
                    else dict(kk=5e-3, KK=8e-3, dV1=1e-3, dV2=1e-3, pg=1e-4))
    for name, a, b in zip(["kk", "KK", "dV1", "dV2", "fail", "pg"], out, ref):
        if name == "fail":
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        else:
            assert _rel_err(a, b) < tols[name], name


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_rollout_kernel_matches_plain(cuda, main_path_b, dtype):
    model = (QuadParams(), CostWeights(), SolverConfig(horizon=50))
    _assert_rollout_matches_plain(main_path_b[0], model, dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_riccati_kernel_matches_plain(cuda, main_path_b, dtype):
    model = (QuadParams(), CostWeights(), SolverConfig(horizon=50))
    _assert_sweep_matches_plain(main_path_b[1], model, dtype)


def test_riccati_kernel_f32_matches_f64(cuda, main_path_b):
    """K2 in f32 against K2 in f64 on the same inputs: phase 3's f32 gates,
    and the same lanes fail."""
    P, W, C = QuadParams(), CostWeights(), SolverConfig(horizon=50)
    out64 = riccati_fused.riccati_backward(*main_path_b[1], P, W, C)
    out32 = riccati_fused.riccati_backward(*[a.float() for a in main_path_b[1]], P, W, C)
    tols = dict(kk=5e-3, KK=8e-3, dV1=1e-3, dV2=1e-3, pg=1e-4)
    for name, a, b in zip(["kk", "KK", "dV1", "dV2", "fail", "pg"], out32, out64):
        if name == "fail":
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        else:
            assert _rel_err(a, b) < tols[name], name


# the variants of tests/test_torch_ops.py: unsquared attitude and u_ub 2.4
# (PYBULLET), goal-attitude weight and the omega-bound penalty
VARIANTS = {
    "pybullet": (dict(squared_attitude=False), dict(u_ub=2.4)),
    "wqf_wbound": (dict(wqf=2.0), dict(w_bound_weight=3.0, w_bound=0.3)),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_kernels_match_plain_in_other_variants(cuda, main_path, variant):
    wkw, skw = VARIANTS[variant]
    P, W, C = QuadParams(), CostWeights(**wkw), SolverConfig(horizon=50, **skw)
    out = rollout.rollout_forward(*main_path[0], P, W, C)
    ref = rollout.rollout_forward_plain(*main_path[0], P, W, C)
    sane = torch.isfinite(ref[2]) & (ref[2].abs() < 1e12)
    assert sane.float().mean() >= 0.95
    for a, b in zip(out, ref):
        torch.testing.assert_close(a[..., sane], b[..., sane], rtol=1e-9, atol=1e-12)
    out = riccati_fused.riccati_backward(*main_path[1], P, W, C)
    ref = riccati_fused.riccati_backward_plain(*main_path[1], P, W, C)
    for name, a, b in zip(["kk", "KK", "dV1", "dV2", "fail", "pg"], out, ref):
        if name == "fail":
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        else:
            assert _rel_err(a, b) < 1e-8, name


def test_kernel_solver_matches_plain_solver(cuda):
    r = np.random.default_rng(0)
    B = 256
    x0 = np.zeros((B, 13))
    x0[:, 0:3] = r.uniform(-0.5, 0.5, size=(B, 3)) + [0, -3, 0]
    x0[:, 6] = 1.0
    args = (x0, np.zeros((B, 4)), r.uniform(-0.5, 0.5, size=(B, 3)) + [0, 3, 0],
            r.uniform(-0.2, 0.2, size=(B, 3)), r.normal(size=(B, 3)) * 0.1, np.full(B, 0.3))
    solve = make_batched_mpc_solver(QuadParams(), CostWeights(), SolverConfig(horizon=10, max_iters=40))
    n_r, n_b = rollout.launches, riccati_fused.launches
    sg = solve(*as_tensors(args, device=cuda))
    assert rollout.launches > n_r and riccati_fused.launches > n_b
    sc = solve(*as_tensors(args))
    both = sg.converged.cpu() & sc.converged
    rel = (sg.cost.cpu() - sc.cost).abs() / sc.cost.abs().clamp_min(1.0)
    assert both.float().mean() >= 0.5 and float(rel[both].median()) < 1e-9


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_unfused_kernel_matches_plain_and_fused(cuda, main_path_b, dtype):
    """K3 against its plain version (K2's gates) and, in f64, against K2 on
    the same trajectory."""
    P, W, C = QuadParams(), CostWeights(), SolverConfig(horizon=50)
    kw = dict(dt=C.dt, lb=C.u_lb, ub=C.u_ub)
    k2 = main_path_b[1]
    derivs = [a.to(dtype) for a in riccati_unfused.derivatives_plain(*k2, P, W, C)]
    n = riccati_unfused.launches
    out = riccati_unfused.riccati_backward_unfused(*derivs, P, **kw)
    torch.cuda.synchronize()
    assert riccati_unfused.launches == n + 1
    refs = [riccati_unfused.riccati_unfused_plain(*derivs, P, **kw)]
    if dtype == torch.float64:
        refs.append(riccati_fused.riccati_backward(*k2, P, W, C))
    tols = (dict(kk=1e-8, KK=1e-8, dV1=1e-8, dV2=1e-8, pg=1e-8) if dtype == torch.float64
            else dict(kk=5e-3, KK=8e-3, dV1=1e-3, dV2=1e-3, pg=1e-4))
    for ref in refs:
        for name, a, b in zip(["kk", "KK", "dV1", "dV2", "fail", "pg"], out, ref):
            if name == "fail":
                torch.testing.assert_close(a, b, rtol=0, atol=0)
            else:
                assert _rel_err(a, b) < tols[name], name


def test_unfused_kernel_f32_matches_f64(cuda, main_path_b):
    """K3 in f32 against K3 in f64 on the same inputs: phase 3's f32 gates,
    and the same lanes fail."""
    P, W, C = QuadParams(), CostWeights(), SolverConfig(horizon=50)
    kw = dict(dt=C.dt, lb=C.u_lb, ub=C.u_ub)
    derivs = riccati_unfused.derivatives_plain(*main_path_b[1], P, W, C)
    out64 = riccati_unfused.riccati_backward_unfused(*derivs, P, **kw)
    out32 = riccati_unfused.riccati_backward_unfused(*[a.float() for a in derivs], P, **kw)
    tols = dict(kk=5e-3, KK=8e-3, dV1=1e-3, dV2=1e-3, pg=1e-4)
    for name, a, b in zip(["kk", "KK", "dV1", "dV2", "fail", "pg"], out32, out64):
        if name == "fail":
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        else:
            assert _rel_err(a, b) < tols[name], name


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_unfused_kernel_fail_pattern(cuda, main_path_b, dtype):
    """K3 where the first, a middle and the last lane fail the pivot test
    (ops/inputs.py with_failing_lanes) against its plain version: the same
    lanes fail, and the other outputs stay within K2's gates."""
    P, W, C = QuadParams(), CostWeights(), SolverConfig(horizon=50)
    kw = dict(dt=C.dt, lb=C.u_lb, ub=C.u_ub)
    Bt = main_path_b[1][0].shape[-1]
    lanes = sorted({0, Bt // 2, Bt - 1})
    derivs = riccati_unfused.derivatives_plain(*main_path_b[1], P, W, C)
    derivs = [a.to(dtype) for a in with_failing_lanes(derivs, lanes, C.u_lb, C.u_ub)]
    out = riccati_unfused.riccati_backward_unfused(*derivs, P, **kw)
    ref = riccati_unfused.riccati_unfused_plain(*derivs, P, **kw)
    assert bool(ref[4][lanes].all())
    tols = (dict(kk=1e-8, KK=1e-8, dV1=1e-8, dV2=1e-8, pg=1e-8) if dtype == torch.float64
            else dict(kk=5e-3, KK=8e-3, dV1=1e-3, dV2=1e-3, pg=1e-4))
    for name, a, b in zip(["kk", "KK", "dV1", "dV2", "fail", "pg"], out, ref):
        if name == "fail":
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        else:
            assert _rel_err(a, b) < tols[name], name


@pytest.mark.parametrize("signal", ["analytic", "fd"])
def test_learning_signal_on_card_matches_cpu(cuda, signal):
    """The RL learning signal through the kernels (CUDA, f64) against the
    plain versions (CPU, f64), on the lanes whose base solve converged on
    both: in f64 both paths run the same algorithm to 1e-9 in cost (see
    test_kernel_solver_matches_plain_solver), so rewards agree to 1e-7 and
    the signal to rtol 1e-6 per lane."""
    from learningagileflight_se3_torch.models.sampler import sample_scenarios, scenario_to_problem
    from learningagileflight_se3_torch.policy import (
        make_analytic_gradient_batched,
        make_fd_gradient_batched,
    )
    from learningagileflight_se3_torch.utils.weights import load_dnn1

    B = 32
    cfg = SolverConfig(horizon=12, max_iters=40, quantize_t=signal == "fd")
    scen = sample_scenarios(torch.Generator().manual_seed(5), B, dtype=torch.float64)
    probs = scenario_to_problem(scen)
    with torch.no_grad():
        out = load_dnn1()(scen)
    args = [probs["x0"], torch.zeros((B, 4), dtype=torch.float64), probs["goal_pos"],
            probs["gate_pts"], out[:, 0:3], out[:, 3:6], out[:, 6]]
    solve = make_batched_mpc_solver(QuadParams(), CostWeights(), cfg)
    sk = solve(*[args[i].to(cuda) for i in (0, 1, 2, 4, 5, 6)])
    sp = solve(*[args[i] for i in (0, 1, 2, 4, 5, 6)])
    both = sk.converged.cpu() & sp.converged
    assert both.float().mean() >= 0.5
    make = make_analytic_gradient_batched if signal == "analytic" else make_fd_gradient_batched
    sig = make(QuadParams(), CostWeights(), cfg, RewardConfig())
    n = (rollout.launches, riccati_fused.launches)
    gk, rk = sig(*[a.to(cuda) for a in args])
    assert rollout.launches > n[0] and riccati_fused.launches > n[1]
    gp, rp = sig(*args)
    torch.testing.assert_close(rk.cpu()[both], rp[both], rtol=1e-7, atol=1e-7)
    # per lane; the fd signal's 9 probe solves per lane may each take another
    # basin on one path (the basin flips of chip_smoke.py phase 5), so a few
    # lanes may differ there
    gk, gp = gk.cpu()[both], gp[both]
    lane_ok = ((gk - gp).abs() <= 1e-8 + 1e-6 * gp.abs()).all(dim=1)
    assert float(lane_ok.float().mean()) >= (1.0 if signal == "analytic" else 0.9)


def _assert_lanes_agree(a, b, lanes, median=1e-9, share=0.0):
    """Of the lanes compared (at least 4) the median differs by at most
    `median` and at least `share` of them by at most 1e-6."""
    diff = (a.double().cpu() - b.double().cpu()).abs().reshape(a.shape[0], -1).amax(dim=1)[lanes]
    assert diff.numel() >= 4, lanes
    assert float(diff.median()) <= median and float((diff <= 1e-6).double().mean()) >= share, diff


@pytest.mark.parametrize("solve", [0, 1], ids=["cold", "warm"])
def test_kernels_match_plain_on_closed_loop_inputs(cuda, solve):
    """K1 and K2 against their plain versions on the inputs the flight gives
    them: the 128 exported scenarios of seed 2024 in f32 at the flight's
    solver settings, the 10th DDP iteration of the cold first replan and of
    the warm-started second one (a solve's first sweeps fail until the
    regularisation has grown); in f32 and on the same inputs in f64, the
    gates of the main-path tests."""
    from learningagileflight_se3_torch.sim.bench import flight_solver_config
    from learningagileflight_se3_torch.sim.closed_loop import make_closed_loop_sim
    from learningagileflight_se3_torch.solver.watch import capture_inputs
    from learningagileflight_se3_torch.utils.weights import bench_scenarios, bench_scenarios_path, load_dnn2

    scen, noise = bench_scenarios(bench_scenarios_path(2024))
    sim = make_closed_loop_sim(load_dnn2(), solver_cfg=flight_solver_config(), steps=11, device="cuda")
    _, got = capture_inputs(lambda: sim(scen, gate_noise=noise[:, :11]), solve=solve, k2_call=10)
    (k1, k1_model, k1_kw), (k2, k2_model, k2_kw) = got["K1"], got["K2"]
    assert k2[0].shape == (50, 21, 128) and k2[0].dtype == torch.float32 and k2[0].is_cuda
    for dtype in (torch.float64, torch.float32):
        _assert_rollout_matches_plain(k1, k1_model, dtype, **k1_kw)
        _assert_sweep_matches_plain(k2, k2_model, dtype, **k2_kw)


def test_kernels_match_plain_on_continuation_inputs(cuda):
    """K1 and K2 against their plain versions on the inputs of the omega-box
    continuation's last stage (w_bound_weight = 1e6, the penalty's Hessian
    term 2e6 beside thrust weights of order 1): 64 seeded bench.py
    scenarios, H=50, f64, the 10th DDP iteration of that stage.  The sweep
    is ill-conditioned there, so K2 in f64 is held to the larger of the
    main-path gate and 10 times the plain version's own change under 1e-15
    input noise, the same lanes failing; K1 in f64 and f32 to the main-path
    gates on the lanes whose sweep did not fail; K2 in f32, where the sweep
    fails on most lanes, to the same fail pattern (see chip_smoke.py phase 11)."""
    from learningagileflight_se3_torch.ops.inputs import continuation_inputs, perturbed

    _, got = continuation_inputs(50, 64, device="cuda")
    (k1, k1_model, k1_kw), (k2, k2_model, k2_kw) = got["K1"], got["K2"]
    assert k2_model[2].w_bound_weight == 1e6 and k2[0].shape == (50, 21, 64) and k2[0].is_cuda
    ref = riccati_fused.riccati_backward_plain(*k2, *k2_model, **k2_kw)
    moved = riccati_fused.riccati_backward_plain(*perturbed(k2), *k2_model, **k2_kw)
    names = ["kk", "KK", "dV1", "dV2", "fail", "pg"]
    tols = {n: max(1e-8, 10.0 * _rel_err(a, b)) for n, a, b in zip(names, moved, ref) if n != "fail"}
    _assert_sweep_matches_plain(k2, k2_model, torch.float64, tols=tols, **k2_kw)
    swept = float((~ref[4]).double().mean())
    for dtype in (torch.float64, torch.float32):
        _assert_rollout_matches_plain(k1, k1_model, dtype, min_sane=swept, **k1_kw)
    a2 = [a.float() for a in k2]
    fail32 = riccati_fused.riccati_backward(*a2, *k2_model, **k2_kw)[4]
    torch.testing.assert_close(fail32, riccati_fused.riccati_backward_plain(*a2, *k2_model, **k2_kw)[4],
                               rtol=0, atol=0)


def test_closed_loop_on_card_matches_cpu(cuda):
    """16 exported scenarios x 30 steps (3 replans at H=50) in f64 at the
    flight's solver settings: the kernel path's states against the plain
    path's.  The two paths agree to about 1e-12 a kernel call and differ by
    rounding within a solve; a line-search or exit test that is nearly a tie
    then falls differently, and from there the paths part for good, so not
    every lane can agree (what holds the kernels on this path is
    test_kernels_match_plain_on_closed_loop_inputs; chip_smoke.py phase 9
    finds the call at which a lane parts and holds the kernels there).  The
    lanes whose every replan took the same number of iterations on both
    paths: their median within 1e-9 after the first replan and within 1e-6
    over the 30 steps; and of all 16 lanes at least 8 within 1e-6."""
    from learningagileflight_se3_torch.sim.bench import flight_solver_config
    from learningagileflight_se3_torch.sim.closed_loop import make_closed_loop_sim
    from learningagileflight_se3_torch.utils.weights import bench_scenarios, bench_scenarios_path, load_dnn2

    scen, noise = bench_scenarios(bench_scenarios_path(2024))
    logs = {}
    for dev in ("cuda", "cpu"):
        sim = make_closed_loop_sim(load_dnn2(), solver_cfg=flight_solver_config(), steps=30, device=dev,
                                   dtype=torch.float64)
        graphs.settle()
        n = (rollout.launches, riccati_fused.launches)
        logs[dev] = sim(scen[:16], gate_noise=noise[:16, :30])
        graphs.settle()  # the launches of the step graphs' conditional bodies
        launched = rollout.launches > n[0] and riccati_fused.launches > n[1]
        assert launched == (dev == "cuda")
    on_card, on_cpu = logs["cuda"], logs["cpu"]
    assert on_card.states.device.type == "cuda"
    assert torch.isfinite(on_cpu.states).all() and torch.isfinite(on_card.states).all()
    assert torch.equal((on_card.solver_iters > 0).cpu(), on_cpu.solver_iters > 0)
    for upto, median in ((10, 1e-9), (30, 1e-6)):
        same = (on_card.solver_iters.cpu()[:, :upto] == on_cpu.solver_iters[:, :upto]).all(dim=1)
        _assert_lanes_agree(on_card.states[:, :upto + 1], on_cpu.states[:, :upto + 1], same, median)
        _assert_lanes_agree(on_card.tra_times[:, :upto], on_cpu.tra_times[:, :upto], same, median)
        diff = (on_card.states.cpu() - on_cpu.states)[:, :upto + 1].abs().amax(dim=(1, 2))
        assert int((diff <= 1e-6).sum()) >= 8, diff


@pytest.mark.parametrize("accel", ["reference", "secant"])
def test_tsolver_on_card_matches_cpu(cuda, accel):
    """On the card the t-solver replays its whole fixed point as a CUDA
    graph over static buffers; it gives the CPU's (eager) times in f64
    (1e-9) and f32 (1e-3: the fixed point's own tolerance), for a batch and
    for one problem, with the pitch rate a number or a tensor, and again
    when a second call of the same shape replays the first call's graph."""
    from learningagileflight_se3_torch.models.sampler import sample_scenarios, scenario_to_problem
    from learningagileflight_se3_torch.sim.tsolver import make_traversal_time_solver
    from learningagileflight_se3_torch.utils.weights import load_dnn2

    for dtype, atol in ((torch.float64, 1e-9), (torch.float32, 1e-3)):
        solvers = {dev: make_traversal_time_solver(load_dnn2().to(device=dev, dtype=dtype), accel=accel)
                   for dev in ("cuda", "cpu")}
        prob = scenario_to_problem(sample_scenarios(torch.Generator().manual_seed(3), 64, dtype=dtype))
        velo = torch.tensor([1.0, 0.3, 0.4], dtype=dtype).expand(64, 3)
        with torch.no_grad():
            for w in (1.5707963, torch.full((64,), 1.2, dtype=dtype)):
                for shift in (0.0, 2.0):
                    x0 = prob["x0"].clone()
                    x0[:, 1] += shift
                    args = (x0, prob["goal_pos"], prob["gate_pts"], velo, w)
                    on_card = solvers["cuda"](*[a.cuda() if isinstance(a, torch.Tensor) else a for a in args])
                    assert on_card.is_cuda and on_card.shape == (64,)
                    torch.testing.assert_close(on_card.cpu(), solvers["cpu"](*args), rtol=0, atol=atol)
            one = [a[5] if isinstance(a, torch.Tensor) else a for a in args]
            on_card = solvers["cuda"](*[a.cuda() if isinstance(a, torch.Tensor) else a for a in one])
            torch.testing.assert_close(on_card.cpu(), solvers["cpu"](*one), rtol=0, atol=atol)


def test_imitation_collect_on_card_matches_cpu(cuda):
    """The collect of 32 teacher solves (H=20, window frame, f64, tol=1e-9,
    gtol=1e-7, 80 iterations): inputs and labels on the lanes both paths call
    converged, median within 1e-9 and 90% within 1e-6."""
    from learningagileflight_se3_torch.models.sampler import sample_scenarios
    from learningagileflight_se3_torch.train.imitation import make_imitation_collect
    from learningagileflight_se3_torch.utils.weights import NN_DEEP_DNN1, load_dnn1

    cfg = SolverConfig(horizon=20, max_iters=80, tol=1e-9, gtol=1e-7)
    scen = sample_scenarios(torch.Generator().manual_seed(9), 32, dtype=torch.float64)
    out = {}
    for dev in ("cuda", "cpu"):
        collect = make_imitation_collect(load_dnn1(NN_DEEP_DNN1).to(dev), QuadParams(), CostWeights(), cfg,
                                         window_frame=True)
        out[dev] = collect(scen.to(dev), with_solution=True)
    both = out["cuda"][2].converged.cpu() & out["cpu"][2].converged
    for k in (0, 1):
        _assert_lanes_agree(out["cuda"][k].reshape(32, -1), out["cpu"][k].reshape(32, -1), both, share=0.9)


def test_new_entry_points_run_on_the_card_by_default(cuda):
    """run_pretraining, run_imitation_training and make_closed_loop_sim with
    no `device` argument work on the card."""
    from learningagileflight_se3_torch.sim.closed_loop import make_closed_loop_sim
    from learningagileflight_se3_torch.train.imitation import run_imitation_training
    from learningagileflight_se3_torch.train.pretrain import run_pretraining
    from learningagileflight_se3_torch.utils.weights import NN_DEEP_DNN1, load_dnn1, load_dnn2

    quiet = lambda *_: None
    model1, losses = run_pretraining(0, steps=4, batch_size=8, log_every=2, log_fn=quiet)
    assert next(model1.parameters()).device.type == "cuda" and len(losses) == 2
    cfg = SolverConfig(horizon=10, max_iters=8)
    n = (rollout.launches, riccati_fused.launches)
    model2, imi = run_imitation_training(0, load_dnn1(NN_DEEP_DNN1), epochs=1, batch_scenarios=4,
                                         sgd_passes=2, lr=1e-3, solver_cfg=cfg, log_fn=quiet)
    assert next(model2.parameters()).device.type == "cuda" and len(imi) == 1 and np.isfinite(imi[0])
    log = make_closed_loop_sim(load_dnn2(), solver_cfg=cfg, steps=20)(
        np.array([[0.0, -8.0, 0.0, 0.0, 6.0, 0.0, 0.05, 1.0, 0.4]]), generator=torch.Generator("cuda").manual_seed(0))
    assert log.states.device.type == "cuda" and log.states.dtype == torch.float32
    assert rollout.launches > n[0] and riccati_fused.launches > n[1]


def test_single_solve_runs_on_the_card_by_default(cuda):
    """make_mpc_solver given numpy inputs and no `device` solves on the card,
    through K1 and K2, and lands where its CPU twin does (f64)."""
    from learningagileflight_se3_torch.solver.ilqr import make_mpc_solver

    x0 = np.zeros(13)
    x0[0:3], x0[6] = [0.0, -8.0, 0.0], 1.0
    args = (x0, np.zeros(4), np.array([0.0, 8.0, 0.0]), np.zeros(3), np.array([0.0, 0.6, 0.0]), 1.0)
    cfg = SolverConfig(horizon=15, max_iters=300, w_bound=float("inf"))
    n = (rollout.launches, riccati_fused.launches)
    got = make_mpc_solver(QuadParams(), CostWeights(), cfg, return_gains=False)(*args)
    assert got.control_traj.device.type == "cuda" and got.control_traj.dtype == torch.float64
    assert rollout.launches > n[0] and riccati_fused.launches > n[1]
    ref = make_mpc_solver(QuadParams(), CostWeights(), cfg, return_gains=False, device="cpu")(*args)
    assert bool(got.converged) and bool(ref.converged)
    np.testing.assert_allclose(got.control_traj.cpu().numpy(), ref.control_traj.numpy(), rtol=0, atol=1e-6)


def test_parallel_sweep_on_card_matches_cpu(cuda):
    """cfg.backward="parallel" (solver/parallel_riccati.py, plain PyTorch on
    the card's library calls) against the same code on the CPU in f64: one
    sweep on the solver's own trajectories (H=50, B=64) within 1e-9, and a
    short solve (H=20, 8 iterations, K1 on the card): at least 24 of 32
    lanes take the CPU's iterations and exit and end within 1e-9 of its
    cost (a lane parts where a line-search test ties: one of 32 ended
    6.8e-8 apart on an H100)."""
    from learningagileflight_se3_torch.ops.inputs import bench_problems
    from learningagileflight_se3_torch.solver.parallel_riccati import derivatives, make_parallel_backward

    P, W = QuadParams(), CostWeights()
    C = SolverConfig(horizon=50, use_ddp=False, backward="parallel")
    _, k2 = main_path_inputs(50, 64, device=cuda, iters=10)
    sweep = make_parallel_backward(C, C.u_lb, C.u_ub)
    out = {}
    for dev in ("cpu", cuda):
        a = [x.to(dev) for x in k2]
        out[str(dev)] = sweep(derivatives(*a[:8], P, W, C), a[0][:, 17:].contiguous(), a[8][0])
    for name, g, w in zip(("kk", "KK", "dV1", "dV2", "fail", "pg"), out["cuda"], out["cpu"]):
        assert _rel_err(g, w) < 1e-9, name

    C = SolverConfig(horizon=20, max_iters=8, use_ddp=False, backward="parallel")
    sols = {}
    n = rollout.launches
    for dev in ("cpu", cuda):
        sols[str(dev)] = make_batched_mpc_solver(P, W, C)(*bench_problems(32, dev, seed=1))
    assert rollout.launches > n
    a, b = sols["cuda"], sols["cpu"]
    # the paths part only where a line-search or exit test ties (chip_smoke.py phase 9)
    within = ((a.cost.cpu() - b.cost) / b.cost.abs().clamp_min(1.0)).abs() <= 1e-9
    within &= (a.iterations.cpu() == b.iterations) & (a.status.cpu() == b.status)
    assert int(within.sum()) >= 24, (a.cost, b.cost, a.iterations, b.iterations)


def test_nccl_world_size_one_step_equals_unsharded(cuda):
    """One NCCL rank on the card: the sharded RL step (the mesh, its
    all-reduces and gathers) against the unsharded step in both grad modes
    (parallel/dryrun.py, horizon 6, 3 iterations, 2 scenarios): the same
    rewards, and the parameters within the dry run's float32 bound (the
    reward's backward accumulates with atomics, so two runs may differ in
    the last bits of a gradient, which Adam's first step can magnify)."""
    from learningagileflight_se3_torch.parallel.dryrun import dryrun_multiprocess

    report = dryrun_multiprocess(1, device="cuda", backend="nccl")
    for mode, r in report.items():
        assert r["reward_rel"] == 0.0 and r["param_abs"] <= 1.5e-4, (mode, r)
        assert r["launches"][0][0] > 0 and r["launches"][0][1] > 0, (mode, r)


def _counts():
    return (rollout.launches, riccati_fused.launches, rollout.plain_calls, riccati_fused.plain_calls)


def _assert_kernels_only(before, what):
    """K1 and K2 launched since `before`, and no plain-version call."""
    k1, k2, p1, p2 = (a - b for a, b in zip(_counts(), before))
    assert k1 > 0 and k2 > 0 and p1 == 0 and p2 == 0, (what, k1, k2, p1, p2)


def test_solve_bench_runs_on_the_kernels(cuda):
    """benchmarks/solve.py at a small size on the card: every tier solves on
    K1 and K2 with no plain-version call, finite costs, the JSON fields, and
    each part's counts (one synced solve, the whole run) launched both."""
    from learningagileflight_se3_torch.benchmarks import solve

    n = _counts()
    out = solve.run(batch=64, horizon=10, reps=1, pipeline_depth=2, pipeline_rounds=1, tile=16)
    _assert_kernels_only(n, "solve")
    assert out["n_nonfinite_costs"] == 0 and out["platform"] != "cpu" and out["certified_tier"] is not None
    for part, c in out["launches"].items():
        assert min(c["K1"], c["K2"]) > 0 and c["K1_plain"] == c["K2_plain"] == 0, (part, c)


def test_kernel_check_bench_runs_on_the_kernels(cuda):
    """benchmarks/kernel_check.py at a small size: the kernel path launches
    K1 and K2 (the plain path is the CPU's, by design)."""
    from learningagileflight_se3_torch.benchmarks import kernel_check

    n = _counts()
    out = kernel_check.run(batch=32, horizon=10, max_iters=10)
    assert rollout.launches > n[0] and riccati_fused.launches > n[1]
    assert out["compiled"] and np.isfinite(out["max_cost_rel_diff"])


def test_latency_bench_runs_on_the_kernels(cuda):
    """benchmarks/latency.py at a small size on the card."""
    from learningagileflight_se3_torch.benchmarks import latency

    n = _counts()
    out = latency.run(horizon=10, queries=7, tile=8, tile_queries=4)
    _assert_kernels_only(n, "latency")
    assert out["value"] > 0 and out["tile_batch"] == 8


def test_realtime_bench_runs_on_the_kernels(cuda):
    """benchmarks/realtime.py at a small size on the card: the ticks and the
    success flight each launch K1 and K2, no plain-version call."""
    from learningagileflight_se3_torch.benchmarks import realtime

    n = _counts()
    out = realtime.run(n=4, steps=30, latency_trajectories=1, max_iters=5, horizon=10)
    _assert_kernels_only(n, "realtime")
    for part, c in out["launches"].items():
        assert min(c["K1"], c["K2"]) > 0 and c["K1_plain"] == c["K2_plain"] == 0, (part, c)


def test_accuracy_bench_solves_on_the_kernels(cuda):
    """benchmarks/accuracy.py's card solve (f64, both starts) on one problem
    of each thrust bound: K1 and K2, no plain-version call (the oracle is
    the host's and is not run here)."""
    from learningagileflight_se3_torch.benchmarks import accuracy

    n = _counts()
    out = accuracy.card_solves([0, 16])
    _assert_kernels_only(n, "accuracy")
    assert all(d["converged"] and np.isfinite(d["cost"]) for d in out.values()), out


def test_scaling_bench_silicon_row_runs_on_the_kernels(cuda, tmp_path):
    """benchmarks/scaling.py's silicon row on one NCCL rank at a small size:
    the rank launches K1 and K2 and calls no plain version."""
    from learningagileflight_se3_torch.benchmarks import scaling

    row = scaling.silicon_row(1, horizon=10, iters=5, reps=1, log_dir=str(tmp_path))
    assert row["solves_per_sec"] > 0
    for c in row["launches"]:
        assert min(c["K1"], c["K2"]) > 0 and c["K1_plain"] == c["K2_plain"] == 0, c


def test_entry_runs_on_the_kernels(cuda):
    """The flagship forward step (entry.py) with its example arguments on the
    card: K1 and K2, no plain-version call, first controls (8, 4) within the
    thrust bounds; in f64 the same arguments agree with the CPU plain path
    within 1e-8 (chip_smoke.py phase 17 (b), whose lanes all agree)."""
    from learningagileflight_se3_torch.entry import entry, make_forward_step

    fn, (dnn1, scen) = entry()
    n = _counts()
    u = fn(dnn1, scen)
    _assert_kernels_only(n, "entry")
    cfg = SolverConfig()
    assert u.shape == (8, 4) and u.device.type == "cuda" and bool(((u >= cfg.u_lb) & (u <= cfg.u_ub)).all())
    card = make_forward_step(device="cuda", dtype=torch.float64)(dnn1, scen)
    cpu = make_forward_step(device="cpu", dtype=torch.float64)(dnn1, scen)
    torch.testing.assert_close(card.cpu(), cpu, rtol=0, atol=1e-8)


# ---- the solver's DDP loop as a replayed CUDA graph (solver/ilqr_batched.py)

GRAPH_CFGS = {  # bench.py's point, the deployed tick, the flagship forward step
    "bench": dict(horizon=50, max_iters=60, tol=1e-4, gtol=3e-4, ls_adaptive=True, ls_max_trips=4,
                  no_progress_iters=10),
    "tick": dict(horizon=50, max_iters=30, tol=1e-4, gtol=3e-4, ls_adaptive=True, ls_max_trips=4,
                 no_progress_iters=10),
    "entry": dict(horizon=50, max_iters=30, tol=1e-6, gtol=1e-5),
}


def _graph_case(B, dtype, cfg, seed=0, **kw):
    from learningagileflight_se3_torch.ops.inputs import bench_problems

    solver = make_batched_mpc_solver(QuadParams(), CostWeights(), SolverConfig(**GRAPH_CFGS[cfg], **kw))
    return solver, bench_problems(B, "cuda", seed=seed, dtype=dtype)


def _unequal(a, b):
    return [name for name, x, y in zip(a._fields, a, b) if not torch.equal(x, y)]


@pytest.mark.parametrize("B, dtype, cfg", [(1, torch.float32, "tick"), (8, torch.float32, "entry"),
                                           (2048, torch.float32, "bench"), (64, torch.float64, "bench")],
                         ids=["B1-f32-tick", "B8-f32-entry", "B2048-f32-bench", "B64-f64-bench"])
def test_graph_solve_equals_eager_solve(cuda, B, dtype, cfg):
    """The graph loop against the eager host loop on the card, field for
    field (torch.equal): the same kernels on the same inputs, the gated
    trips and iterations no-ops; one capture; at most ceil(max_iters / k)
    + 2 host syncs."""
    from learningagileflight_se3_torch.solver import ilqr_batched

    solver, args = _graph_case(B, dtype, cfg)
    with torch.no_grad():
        eager = solver.solution(solver.run_eager(*solver.setup(*args)))
        n = graphs.host_reads
        graph = solver(*args)
        syncs = graphs.host_reads - n
    assert _unequal(graph, eager) == []
    assert solver.captures == 1 and solver.pool_bytes() > 0
    assert syncs <= -(-GRAPH_CFGS[cfg]["max_iters"] // ilqr_batched.GRAPH_BLOCK) + 2


def test_graph_solve_with_the_goal_attitude_weight(cuda):
    """CostWeights.wqf != 0 adds the terminal attitude term, whose constant
    (the identity quaternion) comes from utils/device.py's `constant` and
    not a host copy, so the block still captures; equal to the eager solve."""
    solver = make_batched_mpc_solver(QuadParams(), CostWeights(wqf=1.0), SolverConfig(**GRAPH_CFGS["entry"]))
    args = _graph_case(8, torch.float32, "entry")[1]
    with torch.no_grad():
        eager = solver.solution(solver.run_eager(*solver.setup(*args)))
        graph = solver(*args)
    assert solver.captures == 1 and _unequal(graph, eager) == []


def test_graph_solution_outlives_the_next_replay(cuda):
    """An MPCSolution owns its tensors: a second solve on the same captured
    graph, and a third warm-started from the first one's controls (the
    closed loop's and the tick's chain), leave the first one as it was."""
    solver, args = _graph_case(64, torch.float32, "bench")
    with torch.no_grad():
        first = solver(*args)
        kept = [t.clone() for t in first]
        second = solver(*_graph_case(64, torch.float32, "bench", seed=5)[1])
        solver(*args, U_init=first.control_traj)
        torch.cuda.synchronize()
    assert solver.captures == 1
    assert [name for name, a, b in zip(first._fields, first, kept) if not torch.equal(a, b)] == []
    assert not torch.equal(second.control_traj, first.control_traj)


def test_graph_launch_counts(cuda):
    """The wrappers count kernel executions: a capture launches nothing and
    each replay adds one block's K1 / K2 launches.  So a graph solve counts
    the eager solve's launches plus the gated ones: k K2 launches a block,
    n_trips K1 launches an iteration, the rest of the last live block and
    the one queued behind it."""
    from learningagileflight_se3_torch.solver import ilqr_batched

    B, k, cap = 256, ilqr_batched.GRAPH_BLOCK, GRAPH_CFGS["bench"]["max_iters"]
    solver, args = _graph_case(B, torch.float32, "bench")
    with torch.no_grad():
        solver.prepare(B, torch.float32, "cuda")
        n1, n2 = rollout.launches, riccati_fused.launches
        eager = solver.solution(solver.run_eager(*solver.setup(*args)))
        e1, e2 = rollout.launches - n1, riccati_fused.launches - n2
        n1, n2 = rollout.launches, riccati_fused.launches
        graph = solver(*args)
        g1, g2 = rollout.launches - n1, riccati_fused.launches - n2
    assert _unequal(graph, eager) == []
    iterations = int(eager.iterations.max())
    blocks = min(-(-iterations // k) + 1, -(-cap // k))
    assert (e1, e2) == (1 + int(eager.ls_evals), iterations)
    assert (g1, g2) == (1 + blocks * k * solver.n_trips, blocks * k)


def test_watchers_run_the_eager_loop_on_the_card(cuda):
    """Inside watched_kernels the card's solve takes the eager loop (the
    watcher sees every K2 call and line-search trip) and the flag is
    restored on exit; the result equals the graph solve's."""
    from learningagileflight_se3_torch.solver import ilqr_batched
    from learningagileflight_se3_torch.solver.watch import watched_kernels

    solver, args = _graph_case(8, torch.float32, "entry")
    calls = []
    with torch.no_grad():
        graph = solver(*args)
        with watched_kernels(lambda kind, *a: calls.append(kind)):
            watched = solver(*args)
    assert not graphs.eager_on_card
    assert calls.count("K2") == int(watched.iterations.max()) and calls.count("K1") == int(watched.ls_evals)
    assert calls.count("K1 cost") == 1
    assert _unequal(graph, watched) == []


@pytest.mark.parametrize("accel", ["reference", "secant"])
def test_tsolver_chain_equals_eager(cuda, accel):
    """The t-solver on the card (K4, one launch) against its eager loop on
    the card, at B=1 and B=64: in f64 t within 1e-9 and the same
    iterations, in f32 t within 1e-3 (the fixed point's own tolerance); a
    K4 solve reads nothing from the card, counts [0, the eager loop's
    iterations] and launches one kernel, inside a capture too, whose replay
    gives the same t."""
    from learningagileflight_se3_torch.models.sampler import sample_scenarios, scenario_to_problem
    from learningagileflight_se3_torch.ops import tsolve
    from learningagileflight_se3_torch.sim.tsolver import make_traversal_time_solver
    from learningagileflight_se3_torch.utils.weights import load_dnn2

    for dtype, atol in ((torch.float64, 1e-9), (torch.float32, 1e-3)):
        solver = make_traversal_time_solver(load_dnn2().to(device="cuda", dtype=dtype), accel=accel)
        prob = scenario_to_problem(sample_scenarios(torch.Generator(device="cuda").manual_seed(4), 64, dtype=dtype))
        velo = torch.tensor([1.0, 0.3, 0.4], dtype=dtype, device="cuda").expand(64, 3)
        solver.count = torch.zeros(2, dtype=torch.int32, device="cuda")
        for B in (64, 1):
            args = [a[:B] for a in (prob["x0"], prob["goal_pos"], prob["gate_pts"], velo)]
            if B == 1:
                args = [a[0] for a in args]
            counts = {}
            for drive in ("eager", "kernel"):
                solver.count.zero_()
                n, k = graphs.host_reads, tsolve.launches
                t = solver(*args, 1.5707963, drive="eager" if drive == "eager" else None)
                counts[drive] = (t, solver.count.tolist(), graphs.host_reads - n, tsolve.launches - k)
            (te, ce, re, ke), (tk, ck, rk, kk) = counts["eager"], counts["kernel"]
            torch.testing.assert_close(tk, te, rtol=0, atol=atol)
            assert rk == 0 and re == ce[1] + 1 and ck[0] == 0 and kk == 1 and ke == 0
            if dtype == torch.float64:
                assert ck[1] == ce[1], (accel, B)
            static = [a.clone() for a in args]
            g = graphs.Captures().capture(lambda: solver(*static, 1.5707963))
            solver.count.zero_()
            g.replay()
            assert torch.equal(g.out, tk) and solver.count.tolist() == ck and g.launches[3] == 1


def _tick_pass(dtype, cfg, accel):
    """One pass of ExternalSimController over the replay contract: actions,
    traversal times, host reads per tick."""
    from learningagileflight_se3_torch.config import Variant
    from learningagileflight_se3_torch.sim.external_controller import ExternalSimController
    from learningagileflight_se3_torch.utils.weights import load_dnn2

    z = np.load(CONTRACT)
    moves, V = z["gate_moves"], z["gate_vel"]
    ctrl = ExternalSimController(
        load_dnn2(), final_point=z["final_point"],
        gate_motion=lambda i: (moves[min(i, len(moves) - 1)], V[min(i, len(moves) - 1)]),
        w_rot=float(z["w_rot"]), origin=z["origin"], variant=Variant.PYBULLET, solver_cfg=cfg,
        fixed_point_tol=float(z["fixed_point_tol"]), fixed_point_accel=accel, device="cuda", dtype=dtype)
    acts, ts, reads = [], [], []
    for k in range(len(z["tick_steps"])):
        obs = z["observations"][k]
        n = graphs.host_reads
        a, t = ctrl.compute_control(step=int(z["tick_steps"][k]), cur_pos=obs[0:3], cur_quat_xyzw=obs[3:7],
                                    cur_vel=obs[10:13], cur_euler_rates=obs[13:16], cur_rpy=obs[7:10])
        reads.append(graphs.host_reads - n)
        acts.append(a)
        ts.append(t)
    return np.asarray(acts), np.asarray(ts), reads, z


def test_tick_graph_equals_eager_tick(cuda, monkeypatch):
    """The tick as one replayed graph against the same tick run eagerly on
    the card (the watchers' drive: the solve's host loop, the fixed point's
    own graph), bit for bit, in f64 on the replay
    contract (which it holds: wrench within 1e-4, t within 1e-6) and in f32
    at the deployed budget (secant, max_iters=30); one host read a tick."""
    z = np.load(CONTRACT)
    contract = SolverConfig(horizon=int(z["solver_horizon"]), max_iters=int(z["solver_max_iters"]),
                            u_ub=float(z["solver_u_ub"]))
    deployed = SolverConfig(horizon=50, max_iters=30, u_ub=float(z["solver_u_ub"]), tol=1e-4, gtol=3e-4,
                            ls_adaptive=True, ls_max_trips=4, no_progress_iters=10)
    for dtype, cfg, accel in ((torch.float64, contract, "reference"), (torch.float32, deployed, "secant")):
        acts, ts, reads, _ = _tick_pass(dtype, cfg, accel)
        monkeypatch.setattr(graphs, "eager_on_card", True)
        acts_e, ts_e, reads_e, _ = _tick_pass(dtype, cfg, accel)
        monkeypatch.setattr(graphs, "eager_on_card", False)
        assert np.array_equal(acts, acts_e) and np.array_equal(ts, ts_e), dtype
        assert set(reads) == {1} and min(reads_e) > 1
        if dtype == torch.float64:
            assert np.abs(acts - z["actions"]).max() <= 1e-4 and np.abs(ts - z["tra_times"]).max() < 1e-6


def test_step_graphs_equal_the_step_loop(cuda):
    """The closed loop's hold and replan graphs against the host step loop
    on the card (each fixed point and solve replaying its own graph): 8 exported scenarios x 30 steps (3 replans), f32 at the
    flight's settings, every ClosedLoopLog field equal bit for bit, with and
    without the Kalman filter; no host read inside a flight, the first (it
    captures) or the second; K1 and K2 launched by the graphs' bodies."""
    from learningagileflight_se3_torch.sim.bench import flight_solver_config
    from learningagileflight_se3_torch.sim.closed_loop import make_closed_loop_sim
    from learningagileflight_se3_torch.utils.weights import bench_scenarios, bench_scenarios_path, load_dnn2

    scen, noise = bench_scenarios(bench_scenarios_path(2024))
    obs_noise = 0.01 * torch.randn((8, 30, 4, 3), generator=torch.Generator().manual_seed(2))
    for kalman in (False, True):
        sim = make_closed_loop_sim(load_dnn2(), solver_cfg=flight_solver_config(), steps=30,
                                   estimate_gate_motion=kalman, device="cuda")
        kw = dict(gate_noise=noise[:8, :30], obs_noise=obs_noise if kalman else None)
        eager = sim(scen[:8], drive="eager", **kw)
        for _ in range(2):
            graphs.settle()
            n, k = graphs.host_reads, (rollout.launches, riccati_fused.launches)
            log = sim(scen[:8], **kw)
            assert graphs.host_reads == n
            torch.cuda.synchronize()
            graphs.settle()
            assert rollout.launches > k[0] and riccati_fused.launches > k[1]
            assert [f for f, a, b in zip(log._fields, log, eager) if not torch.equal(a, b)] == [], kalman
        assert sim.captures.count == 2


def test_flight_fixed_point_is_one_kernel(cuda, monkeypatch):
    """The flight's fixed point on the card is K4: (1) the captured hold and
    replan step graphs hold no conditional node for it (every IF node of
    their captures is the replan's solve's) and one K4 launch each; (2) the
    counter "flight.tsolve" of 8 exported scenarios x 30 steps in f64, with
    the spans on, reads the same iterations under the step graphs, under the
    host step loop and from the CPU's eager loop on each step's arguments,
    and "tsolve.fused" one fixed point a step, at most 8 lanes' worth of
    those iterations; (3) the tick still meets the f64 replay contract."""
    from learningagileflight_se3_torch.sim.bench import flight_solver_config
    from learningagileflight_se3_torch.sim.closed_loop import make_closed_loop_sim
    from learningagileflight_se3_torch.sim.tsolver import TraversalTimeSolver
    from learningagileflight_se3_torch.utils.profiling import spans
    from learningagileflight_se3_torch.utils.weights import bench_scenarios, bench_scenarios_path, load_dnn2

    ifs, in_tsolve, calls = [], [False], []
    real_if, real_call = graphs.if_node, TraversalTimeSolver.__call__

    def if_node(pred):
        ifs.append(in_tsolve[0])
        return real_if(pred)

    def call(self, *args, **kw):
        calls.append([a.clone() if torch.is_tensor(a) else a for a in args])
        in_tsolve[0] = True
        try:
            return real_call(self, *args, **kw)
        finally:
            in_tsolve[0] = False

    monkeypatch.setattr(graphs, "if_node", if_node)
    monkeypatch.setattr(TraversalTimeSolver, "__call__", call)
    scen, noise = bench_scenarios(bench_scenarios_path(2024))
    steps = 30
    spans.enable("cuda")
    try:
        sim = make_closed_loop_sim(load_dnn2(), solver_cfg=flight_solver_config(), steps=steps,
                                   dtype=torch.float64, device="cuda")
        sim(scen[:8], gate_noise=noise[:8, :steps])  # the captures, with their warm-ups
        got = {}
        for drive in ("graph", "eager"):
            spans.reset()
            calls.clear()
            sim(scen[:8], gate_noise=noise[:8, :steps], drive=None if drive == "graph" else drive)
            got[drive] = spans.collect()["counters"]
    finally:
        spans.disable()
    assert ifs and not any(ifs) and sim.captures.count == 2
    assert got["graph"] == got["eager"]
    cpu = TraversalTimeSolver(load_dnn2().double(), tol=1e-3, max_iters=100, accel="reference")
    cpu.count = torch.zeros(2, dtype=torch.int32)
    assert len(calls) == steps
    for args in calls:
        real_call(cpu, *[a.cpu() if torch.is_tensor(a) else a for a in args])
    it = got["eager"]["flight.tsolve"]
    assert it == [0, int(cpu.count[1])] and it[1] > steps
    fused = got["eager"]["tsolve.fused"]
    assert fused[0] == steps and it[1] <= fused[1] <= 8 * it[1]
    z = np.load(CONTRACT)
    contract = SolverConfig(horizon=int(z["solver_horizon"]), max_iters=int(z["solver_max_iters"]),
                            u_ub=float(z["solver_u_ub"]))
    acts, ts, _, _ = _tick_pass(torch.float64, contract, "reference")
    assert np.abs(acts - z["actions"]).max() <= 1e-4 and np.abs(ts - z["tra_times"]).max() < 1e-6


def test_parallel_sweep_keeps_the_eager_loop(cuda):
    """cfg.backward="parallel" solves on the card with the eager host loop
    (`BatchedSolver.graphed`): no capture, a host sync per iteration, the
    block loop's result.  The reason, checked: a capture of its block
    raises, because the batched LU of torch.linalg.solve_ex cannot be
    captured."""
    from learningagileflight_se3_torch.ops.inputs import bench_problems
    from learningagileflight_se3_torch.solver import ilqr_batched

    solver = make_batched_mpc_solver(QuadParams(), CostWeights(),
                                     SolverConfig(horizon=50, max_iters=20, use_ddp=False, backward="parallel"))
    args = bench_problems(64, "cuda", seed=2, dtype=torch.float64)
    with torch.no_grad():
        n = graphs.host_reads
        sol = solver(*args)
        syncs = graphs.host_reads - n
        blocks = solver.solution(solver.run_blocks(*solver.setup(*args)))
        assert solver.captures == 0 and syncs >= int(sol.iterations.max())
        assert _unequal(sol, blocks) == []
        with pytest.raises(RuntimeError):
            solver.run_graph(*solver.setup(*args))
    assert solver.captures == 0


def test_failed_capture_raises(cuda, monkeypatch):
    """A block that syncs with the host cannot be captured, and the solve
    raises: nothing falls back to the eager loop.  (At the end of the file
    with the parallel sweep's: a failed capture leaves the process usable,
    but nothing else depends on that here.)"""
    from learningagileflight_se3_torch.solver import ilqr_batched

    real = ilqr_batched.riccati_backward

    def syncing(*a, **kw):
        out = real(*a, **kw)
        float(out[2].sum())  # a host read: forbidden while a stream is captured
        return out

    monkeypatch.setattr(ilqr_batched, "riccati_backward", syncing)
    solver, args = _graph_case(8, torch.float32, "entry")
    with pytest.raises(RuntimeError), torch.no_grad():
        solver(*args)
    assert solver.captures == 0
