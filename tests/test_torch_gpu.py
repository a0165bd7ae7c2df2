"""PyTorch port on a CUDA device: each hand-written kernel against its plain
PyTorch version on the card, K3 against K2, the kernel-backed solver against
the plain solver, and the RL learning signals on the card against the CPU.
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


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_rollout_kernel_matches_plain(cuda, main_path_b, dtype):
    P, W, C = QuadParams(), CostWeights(), SolverConfig(horizon=50)
    args = [a.to(dtype) for a in main_path_b[0]]
    n = rollout.launches
    Zn, Un, c = rollout.rollout_forward(*args, P, W, C)
    torch.cuda.synchronize()
    assert rollout.launches == n + 1
    rZ, rU, rc = rollout.rollout_forward_plain(*args, P, W, C)
    # lanes whose rollout blew up (the line search rejects them) are chaotic
    sane = torch.isfinite(rc) & (rc.abs() < 1e12)
    assert sane.float().mean() >= 0.95
    pairs = [(a[..., sane], b[..., sane]) for a, b in ((Un, rU), (Zn, rZ), (c, rc))]
    if dtype == torch.float64:
        for a, b in pairs:
            torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12)
    else:  # tests/test_pallas.py::TestRolloutKernel's f32 gates
        for (a, b), atol in zip(pairs, (2e-5, 2e-4, 1e-2)):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_riccati_kernel_matches_plain(cuda, main_path_b, dtype):
    P, W, C = QuadParams(), CostWeights(), SolverConfig(horizon=50)
    args = [a.to(dtype) for a in main_path_b[1]]
    n = riccati_fused.launches
    out = riccati_fused.riccati_backward(*args, P, W, C)
    torch.cuda.synchronize()
    assert riccati_fused.launches == n + 1
    ref = riccati_fused.riccati_backward_plain(*args, P, W, C)
    tols = (dict(kk=1e-8, KK=1e-8, dV1=1e-8, dV2=1e-8, pg=1e-8) if dtype == torch.float64
            else dict(kk=5e-3, KK=8e-3, dV1=1e-3, dV2=1e-3, pg=1e-4))
    for name, a, b in zip(["kk", "KK", "dV1", "dV2", "fail", "pg"], out, ref):
        if name == "fail":
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        else:
            assert _rel_err(a, b) < tols[name], name


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
