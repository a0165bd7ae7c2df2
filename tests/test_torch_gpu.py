"""PyTorch port on a CUDA device: each hand-written kernel against its plain
PyTorch version on the card, and the kernel-backed solver against the plain
solver.  Marked `gpu`; skipped where torch.cuda.is_available() is False.

This file imports neither JAX nor tests/conftest.py's fixtures, so it runs on
a machine without JAX:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from learningagileflight_se3_torch.config import CostWeights, QuadParams, SolverConfig
from learningagileflight_se3_torch.ops import build, riccati_fused, rollout
from learningagileflight_se3_torch.ops.inputs import as_tensors, main_path_inputs
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
    assert "rollout_kernel" in lib.ptxas_log and "riccati_fused_kernel" in lib.ptxas_log


@pytest.fixture(scope="module")
def main_path():
    """K1's and K2's inputs at H=50 and a ragged batch of 300 lanes: the
    solver's trajectories after 10 DDP iterations (see chip_smoke.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return main_path_inputs(50, 300, device="cuda", iters=10)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_rollout_kernel_matches_plain(cuda, main_path, dtype):
    P, W, C = QuadParams(), CostWeights(), SolverConfig(horizon=50)
    args = [a.to(dtype) for a in main_path[0]]
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
def test_riccati_kernel_matches_plain(cuda, main_path, dtype):
    P, W, C = QuadParams(), CostWeights(), SolverConfig(horizon=50)
    args = [a.to(dtype) for a in main_path[1]]
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
