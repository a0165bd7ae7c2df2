"""PyTorch port on a CUDA device: each hand-written kernel against its plain
PyTorch version on the card (also on the omega-box continuation's inputs),
K3 against K2, the kernel-backed solver against the plain solver, the RL
learning signals, the closed loop and the imitation
collect on the card against the CPU, the entry points' default device, and
the flagship forward step on the kernels.
Marked `gpu`; skipped where torch.cuda.is_available() is False.

This file imports neither JAX nor tests/conftest.py's fixtures, so it runs on
a machine without JAX:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from learningagileflight_se3_torch.config import CostWeights, QuadParams, RewardConfig, SolverConfig
from learningagileflight_se3_torch.ops import build, riccati_fused, riccati_unfused, rollout
from learningagileflight_se3_torch.ops.inputs import as_tensors, main_path_inputs, with_failing_lanes
from learningagileflight_se3_torch.solver.ilqr import make_batched_mpc_solver

pytestmark = pytest.mark.gpu


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
        n = (rollout.launches, riccati_fused.launches)
        logs[dev] = sim(scen[:16], gate_noise=noise[:16, :30])
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
    """On the card the t-solver replays each DNN2 evaluation as a CUDA graph
    over static buffers; it gives the CPU's (eager) times in f64 (1e-9) and
    f32 (1e-3: the fixed point's own tolerance), for a batch and for one
    problem, with the pitch rate a number or a tensor, and again when a
    second call of the same shape replays the first call's graph."""
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
