"""K3: the control-limited DDP backward sweep over precomputed derivatives.

Replaces the TPU kernel `learningagileflight_se3_tpu/ops/riccati_pallas.py`
`riccati_backward_pallas` (kernel `_make_kernel`).  The sweep of K2
(`ops/riccati_fused.py`) without its first stage: the Jacobians A, B and
the cost quadratics come in from device memory instead of being formed
from the trajectory.  It is on no solver path (the solver runs K2); it is
what the fusion of K2 is measured against.

CUDA kernel: `csrc/riccati_unfused.cu`.  A block takes 8 consecutive
scenarios and streams each step's derivative tile (763 values a scenario,
3.1 KB in f32: of ZU only the DDP term's rows) through a two-stage
`cp.async` ring in shared memory, one step ahead of the recursion; 17
workers a scenario split the dense 17-wide products, and one lane per
scenario runs the boxQP and Cholesky chain with K2's device helpers
(`csrc/lane_algebra.cuh`).

The plain version is split in two, and K2's plain version is their
composition: `derivatives_plain` forms K3's inputs from K2's, and
`riccati_unfused_plain` is the sweep (`riccati_backward_reference`
semantics, ops/riccati_pallas.py).

Layout (time-major, batch-last), the JAX kernel's:
  A (H,17,17,B), B (H,17,4,B), lz (H,17,B), lu (H,4,B), lzz (H,17,17,B),
  luz (H,4,17,B), luu (H,4,4,B), U (H,4,B), ZU (H,21,B), phi_z (17,B),
  phi_zz (17,17,B), reg (1,B)
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


def derivatives_plain(ZU, t_w, goal, tra_pos, Hatt, att0, phi_z, phi_zz, reg,
                      params: QuadParams, weights: CostWeights, cfg: SolverConfig):
    """K2's inputs -> K3's: [A, B, lz, lu, lzz, luz, luu, U, ZU, phi_z,
    phi_zz, reg] in K3's layout, from the closed-form derivatives of
    solver/analytic.py."""
    zu = ZU.permute(0, 2, 1)  # (H,B,21)
    A, Bm = explicit_jacobians(zu, params, cfg.dt)
    lz, lu, lzz, luz, luu = cost_quadratics(
        zu[..., :NZ], zu[..., NZ:], t_w[:, 0], goal.T, tra_pos.T,
        Hatt.permute(2, 0, 1), att0[0], weights, cfg,
    )
    last = lambda x: x.movedim(1, -1).contiguous()  # (H,B,...) -> (H,...,B)
    return [last(A), last(Bm), last(lz), last(lu), last(lzz), last(luz), last(luu),
            ZU[:, NZ:].contiguous(), ZU, phi_z, phi_zz, reg]


def riccati_unfused_plain(A, B, lz, lu, lzz, luz, luu, U, ZU, phi_z, phi_zz, reg,
                          params: QuadParams, dt: float, lb: float, ub: float,
                          boxqp_iters: int = 6, use_ddp: bool = True):
    """Plain PyTorch version of K3: `riccati_backward_reference` semantics
    (ops/riccati_pallas.py), batched over the lanes (batch-first inside).
    Same layout as the kernel."""
    global plain_calls
    plain_calls += 1
    H = A.shape[0]
    first = lambda x: x.movedim(-1, 1)  # (H,...,B) -> (H,B,...)
    A, Bm, lz, lu, lzz, luz, luu = (first(x) for x in (A, B, lz, lu, lzz, luz, luu))
    zu, Uf = ZU.permute(0, 2, 1), U.permute(0, 2, 1)
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
        a, bm, u_k = A[k], Bm[k], Uf[k]
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


def smem_bytes(dtype) -> int:
    """The kernel's dynamic shared memory per block (its ring and working set)."""
    return build.library().lib.laf_riccati_unfused_smem_bytes(int(dtype == torch.float64))


def riccati_backward_unfused(A, B, lz, lu, lzz, luz, luu, U, ZU, phi_z, phi_zz, reg,
                             params: QuadParams, dt: float, lb: float, ub: float,
                             boxqp_iters: int = 6, use_ddp: bool = True):
    """K3 on the tensors' device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Returns (kk, KK, dV1, dV2, fail, pg)."""
    global launches
    H, _, _, Bt = A.shape
    tensors = dict(A=A, B=B, lz=lz, lu=lu, lzz=lzz, luz=luz, luu=luu, U=U, ZU=ZU,
                   phi_z=phi_z, phi_zz=phi_zz, reg=reg)
    shapes = dict(A=(H, NZ, NZ, Bt), B=(H, NZ, NU, Bt), lz=(H, NZ, Bt), lu=(H, NU, Bt),
                  lzz=(H, NZ, NZ, Bt), luz=(H, NU, NZ, Bt), luu=(H, NU, NU, Bt),
                  U=(H, NU, Bt), ZU=(H, NZU, Bt), phi_z=(NZ, Bt), phi_zz=(NZ, NZ, Bt),
                  reg=(1, Bt))
    device, dtype = build.check_tensors("riccati_backward_unfused", shapes, tensors)
    if device.type == "cpu":
        return riccati_unfused_plain(A, B, lz, lu, lzz, luz, luu, U, ZU, phi_z, phi_zz, reg,
                                     params, dt, lb, ub, boxqp_iters, use_ddp)
    kw = dict(dtype=dtype, device=device)
    kk = torch.empty((H, NU, Bt), **kw)
    KK = torch.empty((H, NU, NZ, Bt), **kw)
    dV1, dV2, fail, pg = (torch.empty((Bt,), **kw) for _ in range(4))
    # the cost weights are not read by K3: its quadratics come in precomputed
    consts = build.kernel_consts(params, CostWeights(), SolverConfig(dt=dt, u_lb=lb, u_ub=ub),
                                 boxqp_iters, use_ddp)
    build.launch("laf_riccati_unfused", dtype, consts, H, Bt,
                 [*tensors.values(), kk, KK, dV1, dV2, fail, pg], device)
    launches += 1
    return kk, KK, dV1, dV2, fail > 0, pg
