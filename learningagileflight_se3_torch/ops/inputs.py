"""Seeded inputs for the two kernels, in their time-major, batch-last layout.

`rollout_inputs` and `backward_inputs` are numpy arrays in the style of the
JAX package's kernel tests (tests/test_pallas.py): random, moderate,
well-conditioned, with controls on both bounds, for short horizons.  The
CPU tests hold the plain versions against the JAX kernels on them.
`main_path_inputs` takes the solver's own trajectories at the full horizon;
`chip_smoke.py` and the card's tests hold each kernel against its plain
version on them.
"""

from __future__ import annotations

import numpy as np
import torch

from learningagileflight_se3_torch.config import CostWeights, QuadParams, SolverConfig
from learningagileflight_se3_torch.core.rotations import rodrigues_to_quat
from learningagileflight_se3_torch.solver.analytic import (
    attitude_curvature,
    attitude_offset,
    make_final_quadratics,
)


def rollout_inputs(H: int, B: int, seed: int = 3):
    """[Z_ref, U_ref, kk, KK, t_w, alpha, goal, tra_pos, tra_quat] of K1, fully
    random as in tests/test_pallas.py::TestRolloutKernel.  Meant for short
    horizons: over tens of steps random gains spin the vehicle up and the
    unrenormalized quaternion blows up (use `main_path_inputs` there)."""
    r = np.random.default_rng(seed)
    Z_ref = r.normal(size=(H, 17, B)) * 0.5
    q = Z_ref[:, 6:10].copy()
    q[:, 0] += 1.0
    Z_ref[:, 6:10] = q / np.linalg.norm(q, axis=1, keepdims=True)
    U_ref = r.uniform(0.0, 2.44, size=(H, 4, B))
    kk = r.normal(size=(H, 4, B)) * 0.2
    KK = r.normal(size=(H, 4, 17, B)) * 0.05
    t_w = (2.0 * np.exp(-10 * (0.1 * np.arange(H) - 0.3) ** 2))[:, None, None] * np.ones((1, 1, B))
    alpha = r.uniform(0.1, 1.0, size=(1, B))
    goal = r.normal(size=(3, B)) * 2.0
    tp = r.normal(size=(3, B))
    tq = r.normal(size=(4, B)) * 0.3
    tq[0] += 1.0
    tq /= np.linalg.norm(tq, axis=0, keepdims=True)
    return [Z_ref, U_ref, kk, KK, t_w, alpha, goal, tp, tq]


def backward_inputs(H: int, B: int, seed: int = 0, weights: CostWeights = CostWeights()):
    """[ZU, t_w, goal, tra_pos, Hatt, att0, phi_z, phi_zz, reg] of K2, random
    trajectories as in tests/test_pallas.py::_problem_data.  Meant for short
    horizons: over tens of steps the value recursion on such trajectories
    overflows even in float64."""
    r = np.random.default_rng(seed)
    Z = np.zeros((H + 1, 17, B))
    Z[:, 0:3] = r.normal(size=(H + 1, 3, B)) * 2
    Z[:, 3:6] = r.normal(size=(H + 1, 3, B)) * 0.5
    q = r.normal(size=(H + 1, 4, B)) * 0.3
    q[:, 0] += 1.0
    Z[:, 6:10] = q / np.linalg.norm(q, axis=1, keepdims=True)
    Z[:, 10:13] = r.normal(size=(H + 1, 3, B)) * 0.3
    Z[:, 13:17] = r.uniform(0, 2.44, size=(H + 1, 4, B))
    U = r.uniform(0.1, 2.3, size=(H, 4, B))
    U[0, 0] = 0.0  # clamped-at-bound cases
    U[1, 2] = 2.44
    t_w = (2.0 * np.exp(-10 * (0.1 * np.arange(H) - 0.3) ** 2))[:, None, None] * np.ones((1, 1, B))
    goal, tp = r.normal(size=(3, B)), r.normal(size=(3, B))
    tq = rodrigues_to_quat(torch.from_numpy(r.normal(size=(B, 3)) * 0.3))
    Hatt = attitude_curvature(tq).permute(1, 2, 0).numpy()
    att0 = attitude_offset(tq)[None].numpy()
    phi_z, phi_zz = make_final_quadratics(weights)(torch.from_numpy(Z[-1].T), torch.from_numpy(goal.T))
    reg = np.random.default_rng(seed + 9).uniform(0.01, 2.0, size=(1, B))
    ZU = np.concatenate([Z[:-1], U], axis=1)
    return [ZU, t_w, goal, tp, Hatt, att0, phi_z.T.numpy(), phi_zz.permute(1, 2, 0).numpy(), reg]


def with_failing_lanes(derivs, lanes, lb: float, ub: float):
    """K3's inputs (derivatives_plain's list) changed so that `lanes` fail
    the pivot test at the sweep's first step (k = H-1), with finite gains.
    There B = 0 and lu = 0, so Qu = 0 and the boxQP leaves every control free
    at 0 (U halfway between the bounds); phi_z = 0, so the DDP term vanishes;
    luu = diag(2, 3, 1.5, 1e-14), whose last pivot is under the test's
    threshold in f64 (1e-12) and f32 (1e-7); luz's row 3 = 0, so the gains
    do not see that pivot.  The other steps and lanes are unchanged."""
    A, Bm, lz, lu, lzz, luz, luu, U, ZU, phi_z, phi_zz, reg = [x.clone() for x in derivs]
    lanes = list(lanes)
    Bm[-1, :, :, lanes] = 0.0
    lu[-1, :, lanes] = 0.0
    diag = torch.tensor([2.0, 3.0, 1.5, 1e-14], dtype=luu.dtype, device=luu.device)
    luu[-1, :, :, lanes] = torch.diag(diag)[..., None]
    luz[-1, 3, :, lanes] = 0.0
    U[-1, :, lanes] = 0.5 * (lb + ub)
    phi_z[:, lanes] = 0.0
    return [A, Bm, lz, lu, lzz, luz, luu, U, ZU, phi_z, phi_zz, reg]


def perturbed(tensors, rel: float = 1e-15, seed: int = 0):
    """Each tensor times (1 + rel * N(0,1)), elementwise, from a CPU generator
    seeded with `seed`: inputs a rounding error away from the given ones.  A
    kernel and its plain version order their arithmetic differently; where
    a function is ill-conditioned, the plain version's own change under
    such a perturbation says how far apart the two may fairly be."""
    g = torch.Generator().manual_seed(seed)
    return [x * (1.0 + rel * torch.randn(x.shape, generator=g, dtype=torch.float64).to(x))
            for x in tensors]


def as_tensors(arrays, dtype=torch.float64, device="cpu"):
    """Contiguous tensors of the given dtype on `device`."""
    return [torch.tensor(np.ascontiguousarray(a, np.float64), dtype=dtype, device=device)
            for a in arrays]


def bench_problems(B: int, device="cpu", seed: int = 0, dtype=torch.float64):
    """(x0, u_last, goal, tra_pos, tra_ang, t) of B bench.py-style scenarios
    from the sampler (a CPU generator seeded with `seed`), on `device`:
    zero tra_pos and u_last, pitch-only tra_ang, t = |x0| / 4 in [2, 4]."""
    from learningagileflight_se3_torch.models.sampler import sample_scenarios, scenario_to_problem

    kw = dict(dtype=dtype, device=device)
    scen = sample_scenarios(torch.Generator().manual_seed(seed), B, dtype=torch.float64).to(**kw)
    prob = scenario_to_problem(scen)
    x0, goal = prob["x0"], prob["goal_pos"]
    zeros = torch.zeros((B, 1), **kw)
    tra_ang = torch.cat([zeros, scen[:, 8:9] * 0.5, zeros], dim=1)
    t = torch.clamp(torch.linalg.vector_norm(x0[:, :3], dim=1) / 4.0, 2.0, 4.0)
    return x0, torch.zeros((B, 4), **kw), goal, torch.zeros((B, 3), **kw), tra_ang, t


def continuation_inputs(H: int, B: int, device="cpu", seed: int = 0, dtype=torch.float64,
                        max_iters: int = 60, k2_call: int = 10):
    """(the continuation's last solution, {"K2": ..., "K1": ...}): the inputs
    K2 and K1 get at the `k2_call`-th DDP iteration of the last stage
    (w_bound_weight = 1e6) of the omega-box continuation
    (solver/constrained.py, the default ladder) of B `bench_problems`, as
    solver/watch.py capture_inputs returns them."""
    from learningagileflight_se3_torch.solver.constrained import DEFAULT_LADDER, make_w_bounded_solver
    from learningagileflight_se3_torch.solver.watch import capture_inputs

    C = SolverConfig(horizon=H, max_iters=max_iters)
    solve = make_w_bounded_solver(QuadParams(), CostWeights(), C)
    args = bench_problems(B, device, seed, dtype)
    return capture_inputs(lambda: solve(*args), solve=len(DEFAULT_LADDER) - 1, k2_call=k2_call)


def main_path_inputs(H: int, B: int, device="cpu", seed: int = 0, iters: int = 4):
    """(K1 inputs, K2 inputs) as the solver's main path gives them, float64
    on `device`: bench.py-style scenarios from the sampler, solved for
    `iters` DDP iterations (through the kernels on a CUDA device).  K2's
    inputs are that trajectory at the lanes' current regularisation; K1's
    are the same trajectory with the gains one backward sweep makes of it,
    at step lengths drawn from [0.1, 1], as a line-search trip sees them.
    Some lanes' rollouts blow up, as they do in the solver, whose line
    search rejects them."""
    from learningagileflight_se3_torch.ops.riccati_fused import riccati_backward_plain
    from learningagileflight_se3_torch.solver.ilqr import make_batched_mpc_solver

    P, W = QuadParams(), CostWeights()
    C = SolverConfig(horizon=H, max_iters=iters, tol=1e-4, gtol=3e-4)
    kw = dict(dtype=torch.float64, device=device)
    x0, u_last, goal, _, tra_ang, t = bench_problems(B, device, seed)
    sol = make_batched_mpc_solver(P, W, C)(x0, u_last, goal, torch.zeros((B, 3), **kw), tra_ang, t)

    tq = rodrigues_to_quat(tra_ang)
    t_q = torch.round(t * 10.0) / 10.0
    ks = torch.arange(H, **kw)
    t_w = (W.tra_amp * torch.exp(-W.tra_decay * (C.dt * ks[:, None] - t_q) ** 2))[:, None]
    U = sol.control_traj.permute(1, 2, 0)                                   # (H,4,B)
    u_prev = torch.cat([u_last[None], sol.control_traj.transpose(0, 1)])    # (H+1,B,4)
    Z = torch.cat([sol.state_traj.transpose(0, 1), u_prev], dim=-1).permute(0, 2, 1)
    phi_z, phi_zz = make_final_quadratics(W)(Z[-1].T, goal)
    tp = torch.zeros((3, B), **kw)
    k2 = [torch.cat([Z[:-1], U], dim=1), t_w, goal.T, tp,
          attitude_curvature(tq).permute(1, 2, 0), attitude_offset(tq)[None],
          phi_z.T, phi_zz.permute(1, 2, 0), sol.reg_final[None]]
    k2 = [x.contiguous() for x in k2]
    kk, KK, *_ = riccati_backward_plain(*k2, P, W, C)
    alpha = 0.1 + 0.9 * torch.rand((1, B), generator=torch.Generator().manual_seed(seed + 1),
                                   dtype=torch.float64).to(device)
    k1 = [Z[:-1], U, kk, KK, t_w, alpha, goal.T, tp, tq.T]
    return [x.contiguous() for x in k1], k2


# the lane kinds of `glue_inputs`, lane b of a batch of B taking kind (b + B) % 14
GLUE_LANES = ("done", "at_cap", "stationary", "stalled", "floor", "blowout", "improved", "improved_window",
              "failed", "deep", "insane", "tie_stationary", "tie_stalled", "tie_window")


def glue_inputs(H: int, B: int, cfg: SolverConfig, dtype=torch.float64, device="cpu", seed: int = 0):
    """(state, K2's outputs (KK_new, dV1, dV2, fail, pg), K5's (accepted, Z_ls,
    U_ls, J_ls, acc_idx, ls_trips)) for K6's `decide` and `commit`: random
    trajectories and gains, and per-lane scalars set up, one GLUE_LANES kind
    a lane, so that a batch of 14 lanes or more reaches every exit status
    (the floor exit where cfg has a progress window), deep lanes (where
    cfg.ls_max_trips < cfg.line_search_steps), improved, stationary and
    failed lanes, and lanes that tie each |J|-relative tolerance in `dtype`:
    decrement and the projected gradient at tol * scale and gtol * scale,
    the regularisation at 64 and reg_max, the progress window's test at its
    threshold."""
    from learningagileflight_se3_torch.solver.ilqr_batched import SolveState

    r = np.random.default_rng(seed)
    kw = dict(dtype=dtype, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(**kw).contiguous()  # noqa: E731
    cap, npi, n_alpha = 30, max(cfg.no_progress_iters, 2), cfg.line_search_steps
    J = t(10.0 + 5.0 * np.abs(r.normal(size=B)))
    scale = J.abs() + 1.0
    thr, gthr, sthr = cfg.tol * scale, cfg.gtol * scale, cfg.stall_gtol * scale  # in dtype, as the solver forms them
    dV1, dV2 = -(1.0 + t(np.abs(r.normal(size=B)))), t(0.3 * r.normal(size=B))
    pg = 0.5 * sthr
    reg, J_chk, J_ls = t(np.exp(r.uniform(-3, 3, size=B))), J + 5.0, J - t(np.abs(r.normal(size=B)))
    done, fail, accepted = (np.zeros(B, bool) for _ in range(3))
    it, n_np, w_it = r.integers(0, cap, size=B), r.integers(0, 2, size=B), r.integers(0, npi - 1, size=B)
    ls0, acc_idx = r.integers(0, n_alpha, size=B), r.integers(0, n_alpha, size=B)
    st = r.integers(0, 5, size=B) * (r.uniform(size=B) < 0.2)
    for b in range(B):
        kind = GLUE_LANES[(b + B) % len(GLUE_LANES)]
        accepted[b] = r.uniform() < 0.5
        if kind == "done":
            done[b] = True
        elif kind == "at_cap":
            it[b] = cap
        elif kind in ("stationary", "tie_stationary"):
            dV1[b], dV2[b] = -0.5 * thr[b], 0.0
            pg[b] = 0.5 * gthr[b]
            if kind == "tie_stationary":
                dV1[b], pg[b] = -thr[b], gthr[b]
        elif kind in ("stalled", "tie_stalled"):
            # a rising first-order term keeps it from being stationary
            dV1[b], dV2[b] = thr[b], -2.0 * thr[b] if kind == "tie_stalled" else -1.5 * thr[b]
            reg[b] = 64.0 if kind == "tie_stalled" else 100.0
            pg[b] = sthr[b]
            accepted[b] = False
        elif kind in ("floor", "tie_window"):
            w_it[b], accepted[b] = npi - 1, kind == "tie_window"
            if kind == "floor":
                J_chk[b] = J[b]
            else:  # J_chk - J_ls lands on the window's threshold exactly
                c = J_ls[b] + 1e-5 * torch.arange(1, 2_000_000, **kw)
                c = c[((c + cfg.tol * (c.abs() + 1.0)) - c) == cfg.tol * (c.abs() + 1.0)][int(r.integers(0, 4))]
                J_ls[b], J_chk[b] = c, c + cfg.tol * (c.abs() + 1.0)
        elif kind == "blowout":
            reg[b], accepted[b] = 2.0 * cfg.reg_max, False
        elif kind in ("improved", "improved_window"):
            accepted[b] = True
            if kind == "improved_window":
                w_it[b], reg[b] = npi - 1, cfg.reg_max
        elif kind == "failed":
            fail[b], accepted[b], reg[b] = True, True, cfg.reg_max
        elif kind == "deep":
            n_np[b] = 2 + b % 2
        elif kind == "insane":
            J[b] = (float("nan"), float("inf"), 2e12)[b % 3]
    U = t(r.uniform(0.0, 2.44, size=(H, 4, B)))
    state = SolveState(
        Z=t(r.normal(size=(H + 1, 17, B))), U=U, J=J, KK=t(r.normal(size=(H, 4, 17, B))), reg=reg,
        done=torch.as_tensor(done, device=device), it=torch.as_tensor(it, **i32),
        pg=t(r.uniform(size=B)), ls_n=torch.tensor(int(r.integers(0, 50)), **i32), ls0=torch.as_tensor(ls0, **i32),
        n_np=torch.as_tensor(n_np, **i32), J_chk=J_chk, w_it=torch.as_tensor(w_it, **i32),
        st=torch.as_tensor(st, **i32), max_iters=torch.tensor(cap, **i32))
    sweep = (t(r.normal(size=(H, 4, 17, B))), dV1, dV2, torch.as_tensor(fail, device=device), pg)
    search = (torch.as_tensor(accepted, device=device), t(r.normal(size=(H + 1, 17, B))),
              t(r.uniform(0.0, 2.44, size=(H, 4, B))), J_ls, torch.as_tensor(acc_idx, **i32),
              torch.tensor(int(r.integers(0, 5)), **i32))
    return state, sweep, search
