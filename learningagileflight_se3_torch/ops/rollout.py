"""K1: the fused closed-loop rollout with stage cost (line-search forward).

Replaces the TPU kernel `learningagileflight_se3_tpu/ops/rollout_pallas.py`
`rollout_forward_pallas` (kernel `_make_kernel`).  Per step it forms
u = clip(u_ref + alpha*k + K (z - z_ref), lb, ub), adds the full stage
cost, takes a forward-Euler step and, at the last step, adds the terminal
cost.  With zero gains it is the open-loop rollout with cost.

CUDA kernel: `csrc/rollout.cu`.  One thread per scenario walks the H
steps with its 17-float state and cost in registers.  What bounds it on
the card is the read of the per-step gains (68 + 25 floats per lane per
step, ~370 bytes in f32) and, at B=2048, latency: 64 warps are too few to
hide it on 132 SMs.  The time-major batch-last layout makes a warp's loads
of one entry 32 neighbouring addresses (coalesced); blocks of 32 threads
spread the batch over as many SMs as it fills.

Layout (time-major, batch-last), the JAX kernel's:
  Z_ref (H,17,B) states 0..H-1, U_ref / kk (H,4,B), KK (H,4,17,B),
  t_w (H,1,B), alpha (1,B), goal / tra_pos (3,B), tra_quat (4,B)
  -> Zn (H,17,B) states 1..H, Un (H,4,B), cost (B,).
"""

from __future__ import annotations

import torch

from learningagileflight_se3_torch.config import CostWeights, QuadParams, SolverConfig
from learningagileflight_se3_torch.costs.gate_costs import (
    final_cost,
    goal_cost,
    thrust_cost,
    traversal_cost,
)
from learningagileflight_se3_torch.dynamics.quadrotor import euler_step
from learningagileflight_se3_torch.ops import build

NX, NU = 13, 4
NZ = NX + NU

launches = 0     # kernel launches (CUDA tensors)
plain_calls = 0  # calls of the plain version


def rollout_forward_plain(Z_ref, U_ref, kk, KK, t_w, alpha, goal, tra_pos, tra_quat,
                          params: QuadParams, weights: CostWeights, cfg: SolverConfig):
    """Plain PyTorch version: the per-lane scan of feedback, clip and Euler
    step, batched over the lanes, then the stage costs of all steps at once.
    Same layout as the kernel."""
    global plain_calls
    plain_calls += 1
    H = Z_ref.shape[0]
    z = Z_ref[0].T
    Zs, Us = [z], []
    for k in range(H):
        dz = z - Z_ref[k].T
        u = U_ref[k].T + alpha[0, :, None] * kk[k].T + (KK[k].permute(2, 0, 1) @ dz[..., None])[..., 0]
        u = torch.clamp(u, cfg.u_lb, cfg.u_ub)
        z = torch.cat([euler_step(z[:, :NX], u, cfg.dt, params), u], dim=-1)
        Zs.append(z)
        Us.append(u)
    Z, U = torch.stack(Zs), torch.stack(Us)  # (H+1,B,17), (H,B,4)
    x, up = Z[:-1, :, :NX], Z[:-1, :, NX:]
    g = goal.T
    stage = (
        t_w[:, 0] * traversal_cost(x, tra_pos.T, tra_quat.T, weights)
        + goal_cost(x, g, weights)
        + thrust_cost(U, weights)
        + weights.w_du * torch.sum((U - up) ** 2, dim=-1)
    )
    if cfg.w_bound_weight > 0.0:
        viol = torch.clamp_min(x[..., 10:13].abs() - cfg.w_bound, 0.0)
        stage = stage + cfg.w_bound_weight * torch.sum(viol**2, dim=-1)
    c = torch.zeros_like(stage[0])
    for k in range(H):  # in step order, as the kernel sums (a reduction's order varies with B)
        c = c + stage[k]
    c = c + final_cost(z[:, :NX], g, weights)
    return Z[1:].permute(0, 2, 1).contiguous(), U.permute(0, 2, 1).contiguous(), c


def rollout_forward(Z_ref, U_ref, kk, KK, t_w, alpha, goal, tra_pos, tra_quat,
                    params: QuadParams, weights: CostWeights, cfg: SolverConfig):
    """K1 on the tensors' device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Returns (Zn, Un, cost)."""
    global launches
    H, _, B = Z_ref.shape
    tensors = dict(Z_ref=Z_ref, U_ref=U_ref, kk=kk, KK=KK, t_w=t_w, alpha=alpha,
                   goal=goal, tra_pos=tra_pos, tra_quat=tra_quat)
    shapes = dict(Z_ref=(H, NZ, B), U_ref=(H, NU, B), kk=(H, NU, B), KK=(H, NU, NZ, B),
                  t_w=(H, 1, B), alpha=(1, B), goal=(3, B), tra_pos=(3, B), tra_quat=(4, B))
    device, dtype = build.check_tensors("rollout_forward", shapes, tensors)
    if device.type == "cpu":
        return rollout_forward_plain(Z_ref, U_ref, kk, KK, t_w, alpha, goal, tra_pos,
                                     tra_quat, params, weights, cfg)
    Zn = torch.empty((H, NZ, B), dtype=dtype, device=device)
    Un = torch.empty((H, NU, B), dtype=dtype, device=device)
    cost = torch.empty((B,), dtype=dtype, device=device)
    consts = build.kernel_consts(params, weights, cfg, cfg.boxqp_iters, cfg.use_ddp)
    build.launch("laf_rollout", dtype, consts, H, B, [*tensors.values(), Zn, Un, cost], device)
    launches += 1
    return Zn, Un, cost
