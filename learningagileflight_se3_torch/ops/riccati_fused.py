"""K2: the fully fused control-limited DDP backward sweep.

Replaces the TPU kernel `learningagileflight_se3_tpu/ops/riccati_fused.py`
`riccati_backward_fused` (kernel `_make_kernel`, with the lane helpers of
`ops/riccati_pallas.py`).  In reverse time, from the raw trajectory, it
builds the block-sparse exact Jacobians and the closed-form cost
quadratics, runs the adjoint for the true projected gradient `pg`, forms
the Q expansions with the DDP second-order term and Tassa regularisation,
solves the projected-Newton boxQP, computes masked 4x4 Cholesky gains and
applies the value recursion.

CUDA kernel: `csrc/riccati_fused.cu` (device helpers in
`csrc/lane_algebra.cuh`).  One thread per scenario walks the H steps.  Its
working set (Vzz, M = Vzz A, Qzz, B^T Vzz, Quz, K, K^T Quu: ~1k values,
4 KB in f32 and 8 KB in f64) does not fit in registers, so it lives in
thread-local memory, which the hardware interleaves across a warp (each
access coalesced) and caches in L1/L2.  What bounds it on the card is that
local-memory traffic and its latency: at B=2048 there are 64 warps for 132
SMs, too few to hide it.  A warp per scenario, with the 17x17 products
spread over its lanes, is the next design.

Layout (time-major, batch-last), the JAX kernel's:
  ZU (H,21,B), t_w (H,1,B), goal / tra_pos (3,B), Hatt (4,4,B), att0 (1,B),
  phi_z (17,B), phi_zz (17,17,B), reg (1,B)
  -> kk (H,4,B), KK (H,4,17,B), dV1, dV2, fail (bool), pg, each (B,).
"""

from __future__ import annotations

import torch

from learningagileflight_se3_torch.config import CostWeights, QuadParams, SolverConfig
from learningagileflight_se3_torch.ops import build
from learningagileflight_se3_torch.solver.analytic import (
    cost_quadratics,
    explicit_h2,
    explicit_jacobians,
)
from learningagileflight_se3_torch.solver.boxqp import boxqp, masked_matrix
from learningagileflight_se3_torch.solver.chol4 import chol4_factor, chol4_solve_factored

NX, NU = 13, 4
NZ = NX + NU
NZU = NZ + NU

launches = 0     # kernel launches (CUDA tensors)
plain_calls = 0  # calls of the plain version


def riccati_backward_plain(ZU, t_w, goal, tra_pos, Hatt, att0, phi_z, phi_zz, reg,
                           params: QuadParams, weights: CostWeights, cfg: SolverConfig,
                           boxqp_iters: int = 6, use_ddp: bool = True):
    """Plain PyTorch version: `riccati_backward_reference` semantics
    (ops/riccati_pallas.py), batched over the lanes and fed by the
    closed-form derivatives of solver/analytic.py.  Same layout as the
    kernel."""
    global plain_calls
    plain_calls += 1
    dt, lb, ub = cfg.dt, cfg.u_lb, cfg.u_ub
    H = ZU.shape[0]
    zu = ZU.permute(0, 2, 1)  # (H,B,21)
    A, Bm = explicit_jacobians(zu, params, dt)
    lz, lu, lzz, luz, luu = cost_quadratics(
        zu[..., :NZ], zu[..., NZ:], t_w[:, 0], goal.T, tra_pos.T,
        Hatt.permute(2, 0, 1), att0[0], weights, cfg,
    )
    Vz = phi_z.T
    Vzz = phi_zz.permute(2, 0, 1)
    lam = Vz
    dV1 = torch.zeros_like(reg[0])
    dV2 = torch.zeros_like(reg[0])
    pg = torch.zeros_like(reg[0])
    fail = torch.zeros(reg.shape[1], dtype=torch.bool, device=reg.device)
    r = reg[0][:, None, None]
    eps_b = 1e-7 * (ub - lb)
    kk, KK = [None] * H, [None] * H
    mv = lambda M, v: (M @ v[..., None])[..., 0]
    tr = lambda M: M.transpose(-1, -2)
    for k in reversed(range(H)):
        a, bm, u_k = A[k], Bm[k], zu[k, :, NZ:]
        # adjoint for the true projected gradient
        gu = lu[k] + mv(tr(bm), lam)
        free_g = ~(((u_k <= lb + eps_b) & (gu > 0)) | ((u_k >= ub - eps_b) & (gu < 0)))
        pg = torch.maximum(pg, torch.amax(gu.abs() * free_g, dim=-1))
        lam = lz[k] + mv(tr(a), lam)

        Qz = lz[k] + mv(tr(a), Vz)
        Qu = lu[k] + mv(tr(bm), Vz)
        Qzz = lzz[k] + tr(a) @ Vzz @ a
        Quz = luz[k] + tr(bm) @ Vzz @ a
        Quu = luu[k] + tr(bm) @ Vzz @ bm
        if use_ddp:
            H2 = explicit_h2(zu[k], Vz, params, dt)
            Qzz = Qzz + H2[:, :NZ, :NZ]
            Quz = Quz + H2[:, NZ:, :NZ]
            Quu = Quu + H2[:, NZ:, NZ:]
        Quu_r = Quu + r * (tr(bm) @ bm)
        Quz_r = Quz + r * (tr(bm) @ a)
        Quu_r = 0.5 * (Quu_r + tr(Quu_r))

        # boxQP and masked-Cholesky gains in the lane layout (4,4,B)
        Quu_l = Quu_r.permute(1, 2, 0)
        kf, free = boxqp(Quu_l, Qu.T, (lb - u_k).T, (ub - u_k).T, iters=boxqp_iters)
        L, ok = chol4_factor(masked_matrix(Quu_l, free))
        K = -chol4_solve_factored(L, Quz_r.permute(1, 2, 0) * free[:, None]) * free[:, None]
        fail = fail | ~ok

        Kb, kfb = K.permute(2, 0, 1), kf.T
        Quu_kf = mv(Quu, kfb)
        Vz = Qz + mv(tr(Kb), Quu_kf) + mv(tr(Kb), Qu) + mv(tr(Quz), kfb)
        KtQuz = tr(Kb) @ Quz
        Vzz = Qzz + tr(Kb) @ Quu @ Kb + KtQuz + tr(KtQuz)
        Vzz = 0.5 * (Vzz + tr(Vzz))
        dV1 = dV1 + torch.sum(kfb * Qu, dim=-1)
        dV2 = dV2 + 0.5 * torch.sum(kfb * Quu_kf, dim=-1)
        kk[k], KK[k] = kf, K
    return torch.stack(kk), torch.stack(KK), dV1, dV2, fail, pg


def riccati_backward(ZU, t_w, goal, tra_pos, Hatt, att0, phi_z, phi_zz, reg,
                     params: QuadParams, weights: CostWeights, cfg: SolverConfig,
                     boxqp_iters: int = 6, use_ddp: bool = True):
    """K2 on the tensors' device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Returns (kk, KK, dV1, dV2, fail, pg)."""
    global launches
    H, _, B = ZU.shape
    tensors = dict(ZU=ZU, t_w=t_w, goal=goal, tra_pos=tra_pos, Hatt=Hatt, att0=att0,
                   phi_z=phi_z, phi_zz=phi_zz, reg=reg)
    shapes = dict(ZU=(H, NZU, B), t_w=(H, 1, B), goal=(3, B), tra_pos=(3, B),
                  Hatt=(4, 4, B), att0=(1, B), phi_z=(NZ, B), phi_zz=(NZ, NZ, B),
                  reg=(1, B))
    device, dtype = build.check_tensors("riccati_backward", shapes, tensors)
    if device.type == "cpu":
        return riccati_backward_plain(ZU, t_w, goal, tra_pos, Hatt, att0, phi_z, phi_zz,
                                      reg, params, weights, cfg, boxqp_iters, use_ddp)
    kw = dict(dtype=dtype, device=device)
    kk = torch.empty((H, NU, B), **kw)
    KK = torch.empty((H, NU, NZ, B), **kw)
    dV1, dV2, fail, pg = (torch.empty((B,), **kw) for _ in range(4))
    consts = build.kernel_consts(params, weights, cfg, boxqp_iters, use_ddp)
    build.launch("laf_riccati_fused", dtype, consts, H, B,
                 [*tensors.values(), kk, KK, dV1, dV2, fail, pg], device)
    launches += 1
    return kk, KK, dV1, dV2, fail > 0, pg
