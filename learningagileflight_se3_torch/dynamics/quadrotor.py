"""Analytic SE(3) quadrotor dynamics on tensors.

Port of `learningagileflight_se3_tpu/dynamics/quadrotor.py`.

State  x = [r_I(3), v_I(3), q(4, wxyz), w_B(3)]  (..., 13)
Input  u = [f1, f2, f3, f4]  per-rotor thrusts   (..., 4)

Forward Euler without quaternion renormalization, as in the reference;
`euler_step_renorm` is the closed loop's plant step and `rk4_step` the
higher-fidelity option.
"""

from __future__ import annotations

import math

import torch

from learningagileflight_se3_torch.config import QuadParams
from learningagileflight_se3_torch.core.rotations import omega_matrix, quat_to_dcm_w2b
from learningagileflight_se3_torch.utils.device import constant


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

    J = constant((params.Jx, params.Jy, params.Jz), x.dtype, x.device)
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


def euler_step_renorm(x, u, dt, params: QuadParams):
    """Euler step followed by quaternion renormalization: the plant step of
    long closed-loop runs, where the drift of |q| under the plain step
    compounds (the solver keeps the plain step)."""
    xn = x + dt * quad_ode(x, u, params)
    q = xn[..., 6:10]
    q = q / torch.clamp_min(torch.linalg.vector_norm(q, dim=-1, keepdim=True), 1e-12)
    return torch.cat([xn[..., 0:6], q, xn[..., 10:13]], dim=-1)


def rk4_step(x, u, dt, params: QuadParams, substeps: int = 4):
    """Classic RK4 with `substeps` sub-intervals."""
    h = dt / substeps
    for _ in range(substeps):
        k1 = quad_ode(x, u, params)
        k2 = quad_ode(x + 0.5 * h * k1, u, params)
        k3 = quad_ode(x + 0.5 * h * k2, u, params)
        k4 = quad_ode(x + h * k3, u, params)
        x = x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    return x


def rollout(x0, U, dt, params: QuadParams, method: str = "euler"):
    """Roll controls U (..., H, 4) from x0 (..., 13) with Euler (or, for any
    other `method`, RK4) steps; returns X (..., H+1, 13)."""
    step = euler_step if method == "euler" else rk4_step
    xs = [x0]
    for k in range(U.shape[-2]):
        xs.append(step(xs[-1], U[..., k, :], dt, params))
    return torch.stack(xs, dim=-2)


def mixer_matrix(params: QuadParams, dtype=torch.float64, device=None):
    """Rotor thrusts -> [total thrust, Mx, My, Mz], (4, 4); shared (made once
    per dtype and device by utils/device.py `constant`): read it, never
    write it."""
    l2 = params.l / 2.0
    c = params.c
    return constant(((1.0, 1.0, 1.0, 1.0), (0.0, -l2, 0.0, l2), (-l2, 0.0, l2, 0.0), (c, -c, c, -c)),
                    dtype, torch.device("cpu") if device is None else torch.device(device))


def thrust_torque(u, params: QuadParams):
    """[T, Mx, My, Mz] of rotor thrusts u (..., 4), for logging and actuation."""
    return u @ mixer_matrix(params, dtype=u.dtype, device=u.device).T


def rotor_positions(x, wing_len: float):
    """World positions of the 4 rotor tips, (..., 4, 3): the X-configuration
    body offsets (+-a, +-a, 0), a = wing_len / 2 / sqrt(2), rotated by the
    body -> world DCM."""
    r, q = x[..., 0:3], x[..., 6:10]
    a = wing_len * 0.5 / math.sqrt(2.0)
    tips_B = torch.tensor([[a, a, 0.0], [-a, a, 0.0], [-a, -a, 0.0], [a, -a, 0.0]],
                          dtype=x.dtype, device=x.device)
    # tips_B @ C_I_B^T with C_I_B = C_B_I^T
    return r[..., None, :] + tips_B @ quat_to_dcm_w2b(q)
