"""Closed-form derivatives of the augmented dynamics and the stage cost.

Port of the explicit sparse forms of `learningagileflight_se3_tpu/solver/
analytic.py`, batched over leading dimensions.  The dynamics are an exact
cubic in (z, u) and the stage cost a quartic with one constant 4x4 attitude
curvature, so every Jacobian and Hessian the DDP backward sweep needs has a
closed form; the plain version of the fused backward kernel
(`ops/riccati_fused.py`) is built on these.

Augmented state z = [x(13); u_prev(4)] (17), zu = [z; u] (21).
"""

from __future__ import annotations

import numpy as np
import torch

from learningagileflight_se3_torch.config import CostWeights, QuadParams, SolverConfig
from learningagileflight_se3_torch.core.rotations import quat_to_dcm_w2b
from learningagileflight_se3_torch.utils.device import constant

NX, NU = 13, 4
NZ = NX + NU
NZU = NZ + NU

# Hessians of the nine DCM entries R_ij(q) (constant, q = [w, x, y, z])
_DCM_HESS = (
    ((0, 0), ((2, 2, -4), (3, 3, -4))),
    ((0, 1), ((1, 2, 2), (0, 3, 2))),
    ((0, 2), ((1, 3, 2), (0, 2, -2))),
    ((1, 0), ((1, 2, 2), (0, 3, -2))),
    ((1, 1), ((1, 1, -4), (3, 3, -4))),
    ((1, 2), ((2, 3, 2), (0, 1, 2))),
    ((2, 0), ((1, 3, 2), (0, 2, 2))),
    ((2, 1), ((2, 3, 2), (0, 1, -2))),
    ((2, 2), ((1, 1, -4), (2, 2, -4))),
)


def _stack2(rows):
    """Nested lists of (...) tensors -> (..., n, m)."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def attitude_curvature(tra_quat):
    """Hatt = hess_q tr(I - Rt^T R(q)), constant in q: (..., 4, 4).

    att(q) = 3 - sum_ij Rt_ij R_ij(q) with every R_ij an inhomogeneous
    quadratic, so Hatt = -sum_ij Rt_ij hess(R_ij)."""
    Rt = quat_to_dcm_w2b(tra_quat)
    H = torch.zeros(tra_quat.shape[:-1] + (4, 4), dtype=tra_quat.dtype, device=tra_quat.device)
    for (i, j), entries in _DCM_HESS:
        for a, b, v in entries:
            H[..., a, b] -= v * Rt[..., i, j]
            if a != b:
                H[..., b, a] -= v * Rt[..., i, j]
    return H


def attitude_offset(tra_quat):
    """att0 = 3 - tr(R(tra_quat)): att(q) = att0 + 0.5 q^T Hatt q."""
    R = quat_to_dcm_w2b(tra_quat)
    return 3.0 - (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2])


def cost_quadratics(Z, U, t_weights, goal_pos, tra_pos, Hatt, att0,
                    weights: CostWeights, cfg: SolverConfig):
    """Closed-form stage-cost derivatives from the attitude curvature.

    Z (..., 17), U (..., 4), t_weights (...), goal_pos / tra_pos (..., 3),
    Hatt (..., 4, 4), att0 (...), all broadcast together.  Returns
    (lz (...,17), lu (...,4), lzz (...,17,17), luz (...,4,17), luu (...,4,4))."""
    r, v, q, om, up = Z[..., 0:3], Z[..., 3:6], Z[..., 6:10], Z[..., 10:13], Z[..., 13:17]
    wk = t_weights
    shape = np.broadcast_shapes(Z.shape[:-1], U.shape[:-1], wk.shape,
                                goal_pos.shape[:-1], tra_pos.shape[:-1],
                                Hatt.shape[:-2], att0.shape)
    kw = dict(dtype=Z.dtype, device=Z.device)
    I3 = torch.eye(3, **kw)
    I4 = torch.eye(4, **kw)

    Hq = (q[..., None, :] @ Hatt)[..., 0, :]  # q^T Hatt (Hatt symmetric)
    att = att0 + 0.5 * torch.sum(q * Hq, dim=-1)

    lz = torch.zeros(shape + (NZ,), **kw)
    lzz = torch.zeros(shape + (NZ, NZ), **kw)

    ctp = (2.0 * weights.wrt) * wk
    lz[..., 0:3] = ctp[..., None] * (r - tra_pos) + 2.0 * weights.wrf * (r - goal_pos)
    lzz[..., 0:3, 0:3] = (ctp + 2.0 * weights.wrf)[..., None, None] * I3
    lz[..., 3:6] = 2.0 * weights.wvf * v
    lzz[..., 3:6, 3:6] = 2.0 * weights.wvf * I3
    om_lz = 2.0 * weights.wwf * om
    om_lzz = torch.full_like(om_lz, 2.0 * weights.wwf)
    if cfg.w_bound_weight > 0.0:
        viol = torch.clamp_min(om.abs() - cfg.w_bound, 0.0)
        om_lz = om_lz + 2.0 * cfg.w_bound_weight * viol * torch.sign(om)
        om_lzz = om_lzz + 2.0 * cfg.w_bound_weight * (viol > 0).to(om.dtype)
    lz[..., 10:13] = om_lz
    lzz[..., 10:13, 10:13] = om_lzz[..., None] * I3

    wq = weights.wqt * wk
    if weights.squared_attitude:
        lz[..., 6:10] = (2.0 * wq * att)[..., None] * Hq
        lzz[..., 6:10, 6:10] = (2.0 * wq)[..., None, None] * (
            Hq[..., :, None] * Hq[..., None, :] + att[..., None, None] * Hatt
        )
    else:
        lz[..., 6:10] = wq[..., None] * Hq
        lzz[..., 6:10, 6:10] = wq[..., None, None] * Hatt

    if weights.wqf != 0.0:
        gq = torch.tensor([1.0, 0.0, 0.0, 0.0], **kw)
        Hg = attitude_curvature(gq)
        lz[..., 6:10] += weights.wqf * (q @ Hg)
        lzz[..., 6:10, 6:10] += weights.wqf * Hg

    du = U - up
    lz[..., 13:17] = -2.0 * weights.w_du * du
    lzz[..., 13:17, 13:17] = 2.0 * weights.w_du * I4

    lu = 2.0 * weights.wthrust * U + 2.0 * weights.w_du * du
    luu = (2.0 * (weights.wthrust + weights.w_du) * I4).expand(shape + (NU, NU))
    luz = torch.zeros(shape + (NU, NZ), **kw)
    luz[..., :, 13:17] = -2.0 * weights.w_du * I4
    return lz, lu, lzz, luz, luu


def make_cost_quadratics(weights: CostWeights, cfg: SolverConfig):
    """quadratics(Z, U, t_weights, goal_pos, tra_pos, tra_quat) ->
    (lz, lu, lzz, luz, luu), as the JAX factory, batched over leading dims."""

    def quadratics(Z, U, t_weights, goal_pos, tra_pos, tra_quat):
        Hatt = attitude_curvature(tra_quat)
        att0 = attitude_offset(tra_quat)
        return cost_quadratics(Z, U, t_weights, goal_pos, tra_pos, Hatt, att0, weights, cfg)

    return quadratics


def make_final_quadratics(weights: CostWeights):
    """final_quadratics(zH (...,17), goal_pos (...,3)) -> (phi_z, phi_zz)."""

    def final_quadratics(zH, goal_pos):
        kw = dict(dtype=zH.dtype, device=zH.device)
        shape = np.broadcast_shapes(zH.shape[:-1], goal_pos.shape[:-1])
        I3 = torch.eye(3, **kw)
        phi_z = torch.zeros(shape + (NZ,), **kw)
        phi_zz = torch.zeros(shape + (NZ, NZ), **kw)
        phi_z[..., 0:3] = 2.0 * weights.wrf * (zH[..., 0:3] - goal_pos)
        phi_zz[..., 0:3, 0:3] = 2.0 * weights.wrf * I3
        phi_z[..., 3:6] = 2.0 * weights.wvf * zH[..., 3:6]
        phi_zz[..., 3:6, 3:6] = 2.0 * weights.wvf * I3
        phi_z[..., 10:13] = 2.0 * weights.wwf * zH[..., 10:13]
        phi_zz[..., 10:13, 10:13] = 2.0 * weights.wwf * I3
        if weights.wqf != 0.0:
            Hg = attitude_curvature(constant((1.0, 0.0, 0.0, 0.0), **kw))
            phi_z[..., 6:10] = weights.wqf * (zH[..., 6:10] @ Hg)
            phi_zz[..., 6:10, 6:10] = weights.wqf * Hg
        return phi_z, phi_zz

    return final_quadratics


def explicit_jacobians(ZU, params: QuadParams, dt: float):
    """ZU (..., 21) -> (A (..., 17, 17), B (..., 17, 4)), exact, closed form."""
    kw = dict(dtype=ZU.dtype, device=ZU.device)
    lead = ZU.shape[:-1]
    w0, x0, y0, z0 = ZU[..., 6], ZU[..., 7], ZU[..., 8], ZU[..., 9]
    ox, oy, oz = ZU[..., 10], ZU[..., 11], ZU[..., 12]
    u = ZU[..., NZ:]
    T = torch.sum(u, dim=-1)
    m = params.mass
    Jx, Jy, Jz = params.Jx, params.Jy, params.Jz
    zer = torch.zeros_like(w0)

    A = torch.zeros(lead + (NZ, NZ), **kw)
    idx = torch.arange(NX, device=ZU.device)
    A[..., idx, idx] = 1.0
    A[..., 0:3, 3:6] += dt * torch.eye(3, **kw)

    # dv/dq: dt*(T/m) * D(q), D = d c(q)/dq with c the third row of C_B_I
    s = dt * T / m
    D = _stack2([
        [2 * y0, 2 * z0, 2 * w0, 2 * x0],
        [-2 * x0, -2 * w0, 2 * z0, 2 * y0],
        [zer, -4 * x0, -4 * y0, zer],
    ])
    A[..., 3:6, 6:10] += s[..., None, None] * D

    # dq/dq: dt * 0.5 * Omega(omega)
    Om = _stack2([
        [zer, -ox, -oy, -oz],
        [ox, zer, oz, -oy],
        [oy, -oz, zer, ox],
        [oz, oy, -ox, zer],
    ])
    A[..., 6:10, 6:10] += 0.5 * dt * Om

    # dq/dom: dt * 0.5 * G(q)
    G = _stack2([
        [-x0, -y0, -z0],
        [w0, -z0, y0],
        [z0, w0, -x0],
        [-y0, x0, w0],
    ])
    A[..., 6:10, 10:13] += 0.5 * dt * G

    # dom/dom: -dt * J^-1 W, W = [om]x diag(J) - [J om]x
    W = _stack2([
        [zer, -Jy * oz + Jz * oz, Jz * oy - Jy * oy],
        [Jx * oz - Jz * oz, zer, -Jz * ox + Jx * ox],
        [-Jx * oy + Jy * oy, Jy * ox - Jx * ox, zer],
    ])
    Jd = torch.tensor([Jx, Jy, Jz], **kw)
    A[..., 10:13, 10:13] += -dt * W / Jd[:, None]

    # B: dv/du = dt*c(q)/m per column; dom/du = dt*J^-1*mixer; u_prev rows = I
    cvec = torch.stack([
        2 * (x0 * z0 + w0 * y0),
        2 * (y0 * z0 - w0 * x0),
        1 - 2 * (x0 * x0 + y0 * y0),
    ], dim=-1)
    B = torch.zeros(lead + (NZ, NU), **kw)
    B[..., 3:6, :] = ((dt / m) * cvec)[..., None]
    l2, cc = params.l / 2.0, params.c
    mix = torch.tensor([[0.0, -l2, 0.0, l2], [-l2, 0.0, l2, 0.0], [cc, -cc, cc, -cc]], **kw)
    B[..., 10:13, :] = dt * (mix / Jd[:, None])
    B[..., 13:17, :] = torch.eye(NU, **kw)
    return A, B


def explicit_h2(zu, lam, params: QuadParams, dt: float):
    """hess_zu(lam . f_aug)(zu), exact sparse closed form: zu (..., 21),
    lam (..., 17) -> (..., 21, 21)."""
    kw = dict(dtype=zu.dtype, device=zu.device)
    m = params.mass
    Jx, Jy, Jz = params.Jx, params.Jy, params.Jz
    w0, x0, y0, z0 = zu[..., 6], zu[..., 7], zu[..., 8], zu[..., 9]
    a, b, c_ = lam[..., 3], lam[..., 4], lam[..., 5]
    lq0, lq1, lq2, lq3 = lam[..., 6], lam[..., 7], lam[..., 8], lam[..., 9]
    T = torch.sum(zu[..., NZ:], dim=-1)
    zer = torch.zeros_like(a)
    H2 = torch.zeros(np.broadcast_shapes(zu.shape[:-1], lam.shape[:-1]) + (NZU, NZU), **kw)

    # (q,q): (T/m) * (lv1*S1 + lv2*S2 + lv3*S3)
    Sqq = _stack2([
        [zer, -2 * b, 2 * a, zer],
        [-2 * b, -4 * c_, zer, 2 * a],
        [2 * a, zer, -4 * c_, 2 * b],
        [zer, 2 * a, 2 * b, zer],
    ])
    H2[..., 6:10, 6:10] += (dt * (T / m))[..., None, None] * Sqq

    # (q, u_j): (dt/m) D(q)^T lv, the same for every rotor column
    zq = torch.zeros_like(w0)
    Dq = _stack2([
        [2 * y0, 2 * z0, 2 * w0, 2 * x0],
        [-2 * x0, -2 * w0, 2 * z0, 2 * y0],
        [zq, -4 * x0, -4 * y0, zq],
    ])
    h = (dt / m) * (Dq.transpose(-1, -2) @ lam[..., 3:6, None])[..., 0]
    H2[..., 6:10, NZ:] += h[..., :, None]
    H2[..., NZ:, 6:10] += h[..., None, :]

    # (q, om): 0.5 * dt * P, columns grad_q (G^T lq)_b
    P = _stack2([
        [lq1, lq2, lq3],
        [-lq0, lq3, -lq2],
        [-lq3, -lq0, lq1],
        [lq2, -lq1, -lq0],
    ])
    H2[..., 6:10, 10:13] += 0.5 * dt * P
    H2[..., 10:13, 6:10] += 0.5 * dt * P.transpose(-1, -2)

    # (om, om): -(lw/J)-weighted Hessians of (om x J om)
    d1 = (Jz - Jy) * (lam[..., 10] / Jx)
    d2 = (Jx - Jz) * (lam[..., 11] / Jy)
    d3 = (Jy - Jx) * (lam[..., 12] / Jz)
    Sww = _stack2([
        [zer, d3, d2],
        [d3, zer, d1],
        [d2, d1, zer],
    ])
    H2[..., 10:13, 10:13] += -dt * Sww
    return H2
