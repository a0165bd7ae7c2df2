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
`csrc/lane_algebra.cuh`).  One warp per scenario walks the H steps, with
its working set (Vzz, M = Vzz A, Qzz, B^T Vzz, Quz, K, K^T Quu: about 1,100
values) in shared memory: the lanes split the 17-wide products (a lane per
row or column), every lane runs the small scalar parts (boxQP, Cholesky),
and the next step's inputs arrive by `cp.async` while a step computes.

Layout (time-major, batch-last), the JAX kernel's:
  ZU (H,21,B), t_w (H,1,B), goal / tra_pos (3,B), Hatt (4,4,B), att0 (1,B),
  phi_z (17,B), phi_zz (17,17,B), reg (1,B)
  -> kk (H,4,B), KK (H,4,17,B), dV1, dV2, fail (bool), pg, each (B,).
"""

from __future__ import annotations

import torch

from learningagileflight_se3_torch.config import CostWeights, QuadParams, SolverConfig
from learningagileflight_se3_torch.ops import build
from learningagileflight_se3_torch.ops.riccati_unfused import derivatives_plain, riccati_unfused_plain

NX, NU = 13, 4
NZ = NX + NU
NZU = NZ + NU

launches = 0     # kernel launches (CUDA tensors)
plain_calls = 0  # calls of the plain version


def riccati_backward_plain(ZU, t_w, goal, tra_pos, Hatt, att0, phi_z, phi_zz, reg,
                           params: QuadParams, weights: CostWeights, cfg: SolverConfig,
                           boxqp_iters: int = 6, use_ddp: bool = True):
    """Plain PyTorch version: the closed-form derivatives of
    solver/analytic.py (`derivatives_plain`) followed by K3's sweep
    (`riccati_backward_reference` semantics, ops/riccati_pallas.py).  Same
    layout as the kernel."""
    global plain_calls
    plain_calls += 1
    derivs = derivatives_plain(ZU, t_w, goal, tra_pos, Hatt, att0, phi_z, phi_zz, reg,
                               params, weights, cfg)
    return riccati_unfused_plain(*derivs, params, cfg.dt, cfg.u_lb, cfg.u_ub, boxqp_iters, use_ddp)


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
    dV1, dV2, pg = (torch.empty((B,), **kw) for _ in range(3))
    fail = torch.empty((B,), dtype=torch.bool, device=device)
    consts = build.kernel_consts(params, weights, cfg, boxqp_iters, use_ddp)
    build.launch("laf_riccati_fused", dtype, consts, H, B,
                 [*tensors.values(), kk, KK, dV1, dV2, fail, pg], device)
    launches += 1
    return kk, KK, dV1, dV2, fail, pg
