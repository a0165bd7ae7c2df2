"""The constant-velocity gate filter, in plain PyTorch from its equations,
for the judge of flights whose planner is fed an estimate of the gate's
motion.  It imports nothing of the port.

One filter a lane over the gate's observable pose:

  state        x = [c(3), v(3), theta, omega]      the centre, its velocity,
                                                   the pitch and its rate
  observation  y = [c(3), theta]                   c the mean of the 4 corners,
                                                   theta = atan((p0z - p1z) / (p0x - p1x))

The discrete constant-velocity model with white acceleration noise
`q_accel` on each of the four (position, rate) pairs, over a step `dt`:

  F = I + dt E          E maps each rate onto its position
  Q, each pair          q_accel [[dt^4 / 4, dt^3 / 2], [dt^3 / 2, dt^2]]
  H                     picks c and theta;  R = r_meas I

A filter starts from the first observation: x = [c, 0, theta, 0],
P = diag(pos_var (3), vel_var (3), pos_var, vel_var).  Each step then

  predict     x- = F x,  P- = F P F^T + Q
  innovate    nu = y - H x-, its pitch part wrapped into [-p / 2, p / 2)
              with the sign rule of Python's `%`: a - p floor(a / p) for
              a = nu + p / 2, less p / 2 (p the pitch's period, pi: the
              observed pitch jumps by pi where the gate stands edge-on)
  gain        S = H P- H^T + R,  K^T = S^-1 (H P-) by a general (LU) solve
  update      x = x- + K nu,  P = (I - K H) P- (I - K H)^T + K R K^T, then
              (P + P^T) / 2

The numbers are the configuration's `estimator` block; every matrix product
runs in the `Arith` given (plain.py: float64, or the TF32 control).
"""

from __future__ import annotations

import torch

from flightbench.reference.plain import Arith

NS, NO = 8, 4
PAIRS = ((0, 3), (1, 4), (2, 5), (6, 7))  # (position, its rate) in the state
OBSERVED = (0, 1, 2, 6)                    # the state's entries in the observation


def observe(pts: torch.Tensor) -> torch.Tensor:
    """[c(3), theta] (..., 4) of gate corners (..., 4, 3)."""
    theta = torch.atan((pts[..., 0, 2] - pts[..., 1, 2]) / (pts[..., 0, 0] - pts[..., 1, 0]))
    return torch.cat([pts.mean(dim=-2), theta[..., None]], dim=-1)


class Filter:
    """The filter of `estimator` (a configuration's `estimator` block) at a
    step of `dt` seconds, in `ar`'s arithmetic, on `device`."""

    def __init__(self, estimator: dict, dt: float, ar: Arith, device):
        self.ar, self.est = ar, estimator
        q, f64 = estimator["q_accel"], dict(dtype=torch.float64)
        F, Q = torch.eye(NS, **f64), torch.zeros((NS, NS), **f64)
        for p, v in PAIRS:
            F[p, v] = dt
            Q[p, p], Q[p, v], Q[v, p], Q[v, v] = q * dt**4 / 4, q * dt**3 / 2, q * dt**3 / 2, q * dt**2
        H = torch.zeros((NO, NS), **f64)
        for o, s in enumerate(OBSERVED):
            H[o, s] = 1.0
        R = estimator["r_meas"] * torch.eye(NO, **f64)
        self.F, self.Q, self.H, self.R, self.I = (ar.t(m).to(device) for m in (F, Q, H, R, torch.eye(NS, **f64)))
        self.period = float(estimator["pitch_period"])

    def start(self, y0: torch.Tensor) -> tuple:
        """(x (B, 8), P (B, 8, 8)) from the first observations (B, 4)."""
        y0 = self.ar.t(y0)
        B, pv, vv = y0.shape[0], self.est["pos_var"], self.est["vel_var"]
        x = torch.zeros((B, NS), dtype=y0.dtype, device=y0.device)
        x[:, list(OBSERVED)] = y0
        P = torch.diag(torch.tensor([pv] * 3 + [vv] * 3 + [pv, vv], dtype=y0.dtype, device=y0.device))
        return x, P.expand(B, NS, NS)

    def wrap(self, a: torch.Tensor) -> torch.Tensor:
        """a wrapped into [-p / 2, p / 2) by Python's `%` rule."""
        p = self.period
        b = a + p / 2
        return b - p * torch.floor(b / p) - p / 2

    def step(self, x, P, y) -> tuple:
        """(x, P, wrapped (B,) bool) after one predict and update on the
        observations y (B, 4); wrapped: the pitch innovation was wrapped."""
        mm, F, H, R = self.ar.mm, self.F, self.H, self.R
        Ht = H.T
        xp = mm(x, F.T)
        Pp = mm(mm(F, P), F.T) + self.Q
        nu = self.ar.t(y) - mm(xp, Ht)
        pitch = self.wrap(nu[:, 3])
        wrapped = (pitch - nu[:, 3]).abs() > self.period / 2
        nu = torch.cat([nu[:, :3], pitch[:, None]], dim=1)
        S = mm(mm(H, Pp), Ht) + R
        K = torch.linalg.solve_ex(S, mm(H, Pp)).result.transpose(-1, -2)  # (B, 8, 4); LU, no host read
        xn = xp + mm(K, nu[:, :, None])[:, :, 0]
        IKH = self.I - mm(K, H)
        Pn = mm(mm(IKH, Pp), IKH.transpose(-1, -2)) + mm(mm(K, R), K.transpose(-1, -2))
        return xn, 0.5 * (Pn + Pn.transpose(-1, -2)), wrapped

    def track(self, y0: torch.Tensor, ys: torch.Tensor) -> tuple:
        """(the estimates fed to the planner (B, n, 4) [v(3), omega] after
        each update, the lane-updates whose pitch innovation was wrapped)
        of filters started from y0 (B, 4) and updated on ys (B, n, 4)."""
        x, P = self.start(y0)
        fed, wraps = [], torch.zeros((), dtype=torch.int64, device=x.device)
        for k in range(ys.shape[1]):
            x, P, wrapped = self.step(x, P, ys[:, k])
            fed.append(torch.cat([x[:, 3:6], x[:, 7:8]], dim=1))
            wraps = wraps + wrapped.sum()
        return torch.stack(fed, dim=1), int(wraps)
