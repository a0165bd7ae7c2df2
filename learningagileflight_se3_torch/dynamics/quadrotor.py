"""Analytic SE(3) quadrotor dynamics on tensors.

Port of `learningagileflight_se3_tpu/dynamics/quadrotor.py`.

State  x = [r_I(3), v_I(3), q(4, wxyz), w_B(3)]  (..., 13)
Input  u = [f1, f2, f3, f4]  per-rotor thrusts   (..., 4)

Forward Euler without quaternion renormalization, as in the reference.
"""

from __future__ import annotations

import torch

from learningagileflight_se3_torch.config import QuadParams
from learningagileflight_se3_torch.core.rotations import omega_matrix, quat_to_dcm_w2b


def quad_ode(x, u, params: QuadParams):
    """Continuous-time dynamics f(x, u) -> x_dot, batched over leading dims."""
    v = x[..., 3:6]
    q = x[..., 6:10]
    w = x[..., 10:13]

    thrust = u[..., 0] + u[..., 1] + u[..., 2] + u[..., 3]
    C_B_I = quat_to_dcm_w2b(q)
    # C_I_B @ [0,0,T] is T * (third row of C_B_I)
    acc = C_B_I[..., 2, :] * (thrust / params.mass)[..., None]
    dv = torch.stack([acc[..., 0], acc[..., 1], acc[..., 2] - params.g], dim=-1)

    dq = 0.5 * (omega_matrix(w) @ q[..., None])[..., 0]

    J = torch.tensor([params.Jx, params.Jy, params.Jz], dtype=x.dtype, device=x.device)
    M = torch.stack(
        [
            (-u[..., 1] + u[..., 3]) * (params.l / 2.0),
            (-u[..., 0] + u[..., 2]) * (params.l / 2.0),
            (u[..., 0] - u[..., 1] + u[..., 2] - u[..., 3]) * params.c,
        ],
        dim=-1,
    )
    dw = (M - torch.linalg.cross(w, J * w, dim=-1)) / J
    return torch.cat([v, dv, dq, dw], dim=-1)


def euler_step(x, u, dt, params: QuadParams):
    """x_{k+1} = x_k + dt f(x_k, u_k), no quaternion renormalization."""
    return x + dt * quad_ode(x, u, params)
