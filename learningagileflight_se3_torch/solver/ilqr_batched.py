"""Natively batched control-limited DDP over the two kernels.

Port of `learningagileflight_se3_tpu/solver/ilqr_batched.py`
(`make_batched_mpc_solver_pallas`).  Each DDP iteration runs

  1. K2, the fused backward sweep (`ops/riccati_fused.py`): Jacobian blocks,
     cost quadratics, the projected-gradient adjoint, boxQP and gains;
  2. up to `ls_max_trips` launches of K1, the closed-loop rollout with cost
     (`ops/rollout.py`), in a lock-step per-lane backtracking line search.

K1 with zero gains also makes the initial open-loop rollout.  The semantics
are the JAX solver's: the Tassa regularization schedule, adaptive and
capped line search with deep-ladder escalation, the progress window, the
`sane` guards, the runtime `max_iters`, `quantize_t` and the exit status.
The TPU's rule that the batch be a multiple of 128 is gone: the kernels
mask their own ragged edge.

`cfg.backward` selects the sweep, as the JAX single-problem solver's does
(`solver/ilqr.py`): "sequential" is K2, "parallel" the closed-form
derivatives followed by the parallel-in-time sweep of
`solver/parallel_riccati.py` (plain PyTorch; iLQR only, so `use_ddp=True`
raises).  The JAX package's batched Pallas solver ignores `cfg.backward`
and always runs its fused kernel; its `backend="xla"` batched solver, the
vmapped single-problem solver, honours it.  The port follows the `xla`
backend here.  The line search runs K1 either way.

Trajectories stay in the kernels' time-major, batch-last layout
(Z (H+1,17,B), U (H,4,B), KK (H,4,17,B)) for the whole solve, so no
transposing copy precedes a launch; per-lane selections broadcast over the
trailing batch axis.  The `while` tests of the outer loop and of the line
search are host syncs (`.any()`), one per iteration and one per trip.
"""

from __future__ import annotations

from typing import Optional

import torch

from learningagileflight_se3_torch.config import CostWeights, QuadParams, SolverConfig
from learningagileflight_se3_torch.core.rotations import rodrigues_to_quat
from learningagileflight_se3_torch.ops.riccati_fused import riccati_backward
from learningagileflight_se3_torch.ops.rollout import rollout_forward
from learningagileflight_se3_torch.solver.analytic import (
    attitude_curvature,
    attitude_offset,
    make_final_quadratics,
)
from learningagileflight_se3_torch.solver.ilqr import MPCSolution
from learningagileflight_se3_torch.solver.parallel_riccati import derivatives, parallel_backward

NX = 13
NU = 4
NZ = NX + NU


def make_batched_solver(params: QuadParams, weights: CostWeights, cfg: SolverConfig,
                        return_gains: bool = False):
    """solve(x0[B,13], u_last[B,4], goal[B,3], tra_pos[B,3], tra_ang[B,3],
    t[B], U_init=None|[B,H,4], max_iters=None) -> MPCSolution (leading B).

    Any batch size; the solve runs on x0's device, in x0's float dtype
    promoted to at least float32."""
    H = cfg.horizon
    dt, lb, ub = cfg.dt, cfg.u_lb, cfg.u_ub
    final_quadratics = make_final_quadratics(weights)

    def rollout(Z_ref, U_ref, kk, KK, t_w, alpha, goal, tra_pos, tra_quat):
        return rollout_forward(Z_ref, U_ref, kk, KK, t_w, alpha, goal, tra_pos, tra_quat,
                               params, weights, cfg)

    def rollout_cost(z0, U, t_w, goal, tra_pos, tra_quat):
        """Open-loop rollout with cost: K1 with zero gains.
        z0 (17,B), U (H,4,B) -> Z (H+1,17,B), J (B,)."""
        B = z0.shape[-1]
        Z_ref = z0.expand(H, NZ, B).contiguous()
        kk0 = torch.zeros((H, NU, B), dtype=z0.dtype, device=z0.device)
        KK0 = torch.zeros((H, NU, NZ, B), dtype=z0.dtype, device=z0.device)
        alpha0 = torch.zeros((1, B), dtype=z0.dtype, device=z0.device)
        Zs, _, c = rollout(Z_ref, U, kk0, KK0, t_w, alpha0, goal, tra_pos, tra_quat)
        return torch.cat([z0[None], Zs]), c

    if cfg.backward == "parallel":
        if cfg.use_ddp:
            raise ValueError(
                "cfg.backward='parallel' is a Gauss-Newton (iLQR) sweep and "
                "cannot honor use_ddp=True: the associative-scan composition "
                "has no slot for the second-order dynamics terms. Set "
                "use_ddp=False explicitly to opt into the iLQR downgrade."
            )
    elif cfg.backward != "sequential":
        raise ValueError(f"unknown cfg.backward: {cfg.backward!r}")

    def backward(Z, U, t_w, goal, tra_pos, Hatt, att0, reg):
        """The backward sweep on the current trajectory: K2 (sequential), or
        the closed-form derivatives and the parallel-in-time sweep; only the
        terminal quadratics are formed outside K2."""
        ZU = torch.cat([Z[:-1], U], dim=1)
        phi_z, phi_zz = final_quadratics(Z[-1].T, goal.T)
        phi_z, phi_zz = phi_z.T.contiguous(), phi_zz.permute(1, 2, 0).contiguous()
        if cfg.backward == "parallel":
            derivs = derivatives(ZU, t_w, goal, tra_pos, Hatt, att0, phi_z, phi_zz, params, weights, cfg)
            return parallel_backward(derivs, U, reg, cfg, lb, ub)
        return riccati_backward(
            ZU, t_w, goal, tra_pos, Hatt, att0, phi_z, phi_zz, reg[None],
            params, weights, cfg, boxqp_iters=cfg.boxqp_iters, use_ddp=cfg.use_ddp,
        )

    def forward(Z, U, kk, KK, t_w, goal, tra_pos, tra_quat, alpha):
        """Closed-loop rollout at per-lane step length alpha (B,)."""
        Zn, Un, c = rollout(Z[:-1], U, kk, KK, t_w, alpha[None], goal, tra_pos, tra_quat)
        return torch.cat([Z[:1], Zn]), Un, c

    def line_search(Z, U, J, kk, KK, t_w, goal, tra_pos, tra_quat, dV1, dV2, ls0, deep, skip):
        """Per-lane first-acceptable-alpha backtracking, each lane from its
        warm index `ls0`; `deep` lanes sweep the whole ladder at a coarse
        stride; `skip` (finished) lanes enter accepted and cost no trip."""
        n_alpha = cfg.line_search_steps
        stride = cfg.ls_max_trips
        n_deep = -(-n_alpha // stride)
        dtype, device = J.dtype, J.device
        tiny = 1e-300 if dtype == torch.float64 else 1e-30
        alphas = 0.5 ** torch.arange(n_alpha, dtype=dtype, device=device)
        max_trips = torch.where(deep, n_deep, cfg.ls_max_trips)
        depth = lambda i: torch.where(deep, i * stride, ls0 + i)
        live = lambda acc, i: (~acc) & (depth(i) < n_alpha) & (i < max_trips)

        accepted = skip
        i = torch.zeros_like(ls0)
        Zb, Ub, Jb = Z, U, J
        while bool(live(accepted, i).any()):
            alpha = alphas[torch.clamp_max(depth(i), n_alpha - 1).long()]
            Zn, Un, Jn = forward(Z, U, kk, KK, t_w, goal, tra_pos, tra_quat, alpha)
            expected = -(alpha * dV1 + alpha * alpha * dV2)
            ok = (
                (Jn < J)
                & (expected > 0)
                & ((J - Jn) / torch.clamp_min(expected, tiny) > 0.1)
                & ~accepted
            )
            Zb = torch.where(ok, Zn, Zb)
            Ub = torch.where(ok, Un, Ub)
            Jb = torch.where(ok, Jn, Jb)
            active = live(accepted, i)
            accepted = accepted | ok
            i = i + active.to(i.dtype)
        acc_idx = torch.where(
            accepted,
            torch.clamp_max(torch.where(deep, (i - 1) * stride, ls0 + i - 1), n_alpha - 1),
            ls0,
        )
        # lock-step trips this iteration = the deepest per-lane backtrack
        return accepted, Zb, Ub, Jb, acc_idx, i.max()

    def solve(x0, u_last, goal_pos, tra_pos, tra_ang, t,
              U_init: Optional[torch.Tensor] = None, max_iters: Optional[int] = None):
        """max_iters: optional runtime iteration cap (default cfg.max_iters)."""
        max_iters = cfg.max_iters if max_iters is None else int(max_iters)
        device = x0.device
        dtype = torch.promote_types(x0.dtype, torch.float32)
        as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        B = x0.shape[0]
        x0 = as_t(x0)
        u_last, goal, tra_pos, tra_ang = as_t(u_last), as_t(goal_pos), as_t(tra_pos), as_t(tra_ang)
        t = torch.as_tensor(t, device=device)
        if cfg.quantize_t:
            t = torch.round(t * 10.0) / 10.0
        tra_quat = rodrigues_to_quat(tra_ang)
        # per-problem attitude curvature: constant across solver iterations
        Hatt = attitude_curvature(tra_quat).permute(1, 2, 0).contiguous()
        att0 = attitude_offset(tra_quat)[None].contiguous()
        ks = torch.arange(H, dtype=dtype, device=device)
        t_w = weights.tra_amp * torch.exp(
            -weights.tra_decay * (dt * ks[:, None] - t[None, :].to(dtype)) ** 2
        )[:, None, :].contiguous()  # (H,1,B)
        z0 = torch.cat([x0, u_last], dim=-1).T.contiguous()
        goal_l, tp_l, tq_l = goal.T.contiguous(), tra_pos.T.contiguous(), tra_quat.T.contiguous()

        U0 = torch.full((H, NU, B), 0.5 * (lb + ub), dtype=dtype, device=device)
        if U_init is not None:
            # warm-start guard of the JAX single-problem solver (ilqr.py):
            # a lane whose warm rollout cost is not sane restarts from the
            # midpoint init (the JAX batched solver lacks this guard)
            Uw = as_t(U_init).permute(1, 2, 0).contiguous()  # (B,H,4) -> (H,4,B)
            _, Jw = rollout_cost(z0, Uw, t_w, goal_l, tp_l, tq_l)
            U0 = torch.where(torch.isfinite(Jw) & (Jw.abs() < 1e12), Uw, U0)

        Z, J = rollout_cost(z0, U0, t_w, goal_l, tp_l, tq_l)
        U = U0
        KK = torch.zeros((H, NU, NZ, B), dtype=dtype, device=device)
        reg = torch.full((B,), cfg.reg_init, dtype=dtype, device=device)
        done = torch.zeros(B, dtype=torch.bool, device=device)
        i32 = dict(dtype=torch.int32, device=device)
        it = torch.zeros(B, **i32)
        pg = torch.full((B,), float("inf"), dtype=dtype, device=device)
        ls_n = torch.zeros((), **i32)
        ls0 = torch.zeros(B, **i32)
        n_np = torch.zeros(B, **i32)
        J_chk = J
        w_it = torch.zeros(B, **i32)
        st = torch.zeros(B, **i32)

        while bool(((~done) & (it < max_iters)).any()):
            kk, KK_new, dV1, dV2, fail, pg = backward(Z, U, t_w, goal_l, tp_l, Hatt, att0, reg)

            decrement = -(dV1 + dV2)
            scale = J.abs() + 1.0
            # `sane` guards every |J|-relative tolerance: at an exploded
            # rollout cost the gates would be trivially satisfied
            sane = torch.isfinite(J) & (J.abs() < 1e12)
            grad_small = pg <= cfg.gtol * scale
            stationary = (
                (decrement <= cfg.tol * scale) & (dV1 <= 0) & grad_small & ~fail & sane
            )

            active = ~done & (it < max_iters)
            # ladder escalation for live failure streaks; no-op under a full ladder
            if cfg.ls_max_trips < cfg.line_search_steps:
                deep = (n_np >= 2) & (decrement > cfg.tol * scale) & active
            else:
                deep = torch.zeros_like(active)
            accepted, Z_ls, U_ls, J_ls, acc_idx, ls_trips = line_search(
                Z, U, J, kk, KK_new, t_w, goal_l, tp_l, tq_l, dV1, dV2, ls0, deep, ~active,
            )
            improved = accepted & ~fail & ~stationary & active

            Z_n = torch.where(improved, Z_ls, Z)
            U_n = torch.where(improved, U_ls, U)
            KK = torch.where(improved | (stationary & active), KK_new, KK)
            J_n = torch.where(improved, J_ls, J)

            reg_n = torch.where(
                active,
                torch.where(
                    improved,
                    torch.clamp_min(reg * cfg.reg_shrink, cfg.reg_min),
                    torch.clamp_max(reg * cfg.reg_grow, cfg.reg_max * 2.0),
                ),
                reg,
            )
            grad_smallish = pg <= cfg.stall_gtol * scale
            stalled = (
                ~improved & ~stationary & (decrement <= cfg.tol * scale)
                & (reg >= 64.0) & grad_smallish & sane
            )
            # progress window: terminate when a whole window of iterations
            # made less than tol cumulative progress
            np_n = torch.where(active, torch.where(improved, 0, n_np + 1), n_np)
            w_n = w_it + active.to(w_it.dtype)
            if cfg.no_progress_iters > 0:
                window_full = w_n >= cfg.no_progress_iters
            else:
                window_full = torch.zeros_like(active)
            window_progress = (J_chk - J_n) > cfg.tol * (J_n.abs() + 1.0)
            floor_exit = window_full & ~window_progress & sane
            J_chk = torch.where(window_full & active, J_n, J_chk)
            w_it = torch.where(window_full & active, 0, w_n)
            blowout = ~improved & ~stationary & (reg > cfg.reg_max)
            done = done | (active & (stationary | stalled | floor_exit | blowout))
            # exit taxonomy; each reason implies done, so writing under `active` is exact
            st = torch.where(active & stationary, 1, st)
            st = torch.where(active & ~stationary & stalled, 2, st)
            st = torch.where(active & ~stationary & ~stalled & floor_exit, 3, st)
            st = torch.where(active & ~stationary & ~stalled & ~floor_exit & blowout, 4, st)
            it = it + active.to(it.dtype)
            if cfg.ls_adaptive:
                ls0 = torch.where(improved & active, torch.clamp_min(acc_idx - 1, 0), ls0)
            Z, U, J, reg, n_np = Z_n, U_n, J_n, reg_n, np_n
            ls_n = ls_n + ls_trips

        return MPCSolution(
            state_traj=Z[:, :NX].permute(2, 0, 1).contiguous(),
            control_traj=U.permute(2, 0, 1).contiguous(),
            cost=J,
            iterations=it,
            converged=done & torch.isfinite(J) & (J.abs() < 1e12),
            gains_K=KK.permute(3, 0, 1, 2).contiguous() if return_gains
            else torch.zeros((0,), dtype=dtype, device=device),
            grad_norm=pg,
            reg_final=reg,
            ls_evals=ls_n,
            status=st,
        )

    return solve
