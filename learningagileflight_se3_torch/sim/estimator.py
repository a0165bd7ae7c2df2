"""Gate-state Kalman filter.

Port of `learningagileflight_se3_tpu/sim/estimator.py`: a constant-velocity
filter over the observable gate pose, batched over leading dimensions (one
filter per scenario),

  state  x = [center(3), v_center(3), pitch, pitch_rate]   (..., 8)
  obs    y = [center(3), pitch]                            (..., 4)  per step

with white acceleration noise and the standard discrete constant-velocity
process covariance.  The pitch measurement is an atan and wraps with period
pi; the innovation is wrapped with the sign rule of Python's `%`
(`torch.remainder`) so that the filter follows a gate that keeps turning.
The Kalman gain solves the 4x4 innovation covariance (SPD) by the closed-form
Cholesky of solver/chol4.py on every device: the batched LU of
`torch.linalg.solve` checks its pivots on the host, which a CUDA graph
cannot capture, and one formula everywhere keeps the eager and the graphed
flights equal bit for bit.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from learningagileflight_se3_torch.geometry.gate import gate_centroid, gate_pitch
from learningagileflight_se3_torch.solver.chol4 import chol4_solve

NS = 8  # [cx cy cz vx vy vz pitch pitch_rate]
NO = 4  # [cx cy cz pitch]


class KalmanState(NamedTuple):
    x: torch.Tensor  # (..., 8) mean
    P: torch.Tensor  # (..., 8, 8) covariance


def kalman_init(obs0, pos_var: float = 1.0, vel_var: float = 4.0,
                dtype=torch.float32) -> KalmanState:
    """Initialise from the first observation (..., 4): zero velocity, broad
    prior."""
    obs0 = torch.as_tensor(obs0).to(dtype)
    x = torch.zeros(obs0.shape[:-1] + (NS,), dtype=dtype, device=obs0.device)
    x[..., 0:3] = obs0[..., 0:3]
    x[..., 6] = obs0[..., 3]
    diag = torch.tensor([pos_var] * 3 + [vel_var] * 3 + [pos_var, vel_var], dtype=dtype,
                        device=obs0.device)
    return KalmanState(x=x, P=torch.diag(diag).expand(obs0.shape[:-1] + (NS, NS)).clone())


def _model_matrices(dt: float, q_accel: float, r_meas: float, dtype, device):
    """Constant-velocity F, process noise Q ([[dt^4/4, dt^3/2], [dt^3/2,
    dt^2]] * q_accel per (position, velocity) pair), observation Hm,
    measurement noise R and the identity."""
    F = torch.eye(NS, dtype=dtype)
    Q = torch.zeros((NS, NS), dtype=dtype)
    q11, q12, q22 = q_accel * dt**4 / 4.0, q_accel * dt**3 / 2.0, q_accel * dt**2
    for p, v in ((0, 3), (1, 4), (2, 5), (6, 7)):
        F[p, v] = dt
        Q[p, p], Q[p, v], Q[v, p], Q[v, v] = q11, q12, q12, q22
    Hm = torch.zeros((NO, NS), dtype=dtype)
    for o, s in ((0, 0), (1, 1), (2, 2), (3, 6)):
        Hm[o, s] = 1.0
    R = r_meas * torch.eye(NO, dtype=dtype)
    return tuple(m.to(device) for m in (F, Q, Hm, R, torch.eye(NS, dtype=dtype)))


def make_kalman_step(dt: float = 0.01, q_accel: float = 25.0, r_meas: float = 1e-4,
                     pitch_period: float = math.pi):
    """step(KalmanState, obs (..., 4)) -> KalmanState: one predict and update
    (Joseph-form covariance).  The model matrices are built once per dtype
    and device."""
    cache = {}

    def step(ks: KalmanState, obs) -> KalmanState:
        key = (ks.x.dtype, ks.x.device)
        if key not in cache:
            cache[key] = _model_matrices(dt, q_accel, r_meas, *key)
        F, Q, Hm, R, I = cache[key]
        # predict
        xp = ks.x @ F.T
        Pp = F @ ks.P @ F.T + Q
        # update
        innov = obs.to(xp.dtype) - xp @ Hm.T
        half = 0.5 * pitch_period
        pitch = torch.remainder(innov[..., 3] + half, pitch_period) - half
        innov = torch.cat([innov[..., 0:3], pitch[..., None]], dim=-1)
        S = Hm @ Pp @ Hm.T + R
        # K^T = S^-1 (Hm Pp), in chol4's layout (matrix axes first)
        KT, _ = chol4_solve(S.movedim((-2, -1), (0, 1)), (Hm @ Pp).movedim((-2, -1), (0, 1)))
        K = KT.movedim((0, 1), (-1, -2))  # (..., 8, 4)
        xn = xp + (K @ innov[..., None])[..., 0]
        IKH = I - K @ Hm
        Pn = IKH @ Pp @ IKH.transpose(-1, -2) + K @ R @ K.transpose(-1, -2)
        return KalmanState(x=xn, P=0.5 * (Pn + Pn.transpose(-1, -2)))

    return step


def gate_observation(pts, generator=None, noise_std: float = 0.0, noise=None):
    """Gate corners (..., 4, 3) -> observation [center(3), pitch] (..., 4),
    optionally with Gaussian corner noise (a stand-in for perception error):
    `noise` (the term added to the corners, made by the caller), or
    noise_std * N(0,1) drawn from `generator`."""
    if noise is not None:
        pts = pts + noise
    elif generator is not None and noise_std > 0.0:
        pts = pts + noise_std * torch.randn(pts.shape, generator=generator, dtype=pts.dtype,
                                            device=generator.device).to(pts.device)
    return torch.cat([gate_centroid(pts), gate_pitch(pts)[..., None]], dim=-1)


def estimated_velocity(ks: KalmanState):
    """(v_center (..., 3), pitch_rate (...)) from the filter state."""
    return ks.x[..., 3:6], ks.x[..., 7]
