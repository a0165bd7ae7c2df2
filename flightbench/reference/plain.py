"""Plain PyTorch of the system's mathematics, written from its equations
for the benchmark's judge.  It imports nothing of the port.

Every function computes in the arithmetic an `Arith` names:
  * "f64": float64 throughout (the reference);
  * "tf32": float32, each matrix product's operands rounded to TF32's
    10-bit mantissa and accumulated in float32, as a tensor core computes
    it with `allow_tf32` on (the control: the nearest precision below the
    configurations' float32).  The rounding is done here, so the control
    does not depend on which kernel cuBLAS picks.

Quadrotor: x = [r(3), v(3), q(4, wxyz), w_B(3)], u = four rotor thrusts;
forward Euler (the solver's step) and Euler with the quaternion
renormalised (the closed loop's plant).  The stage cost of the gate
traversal and the DNN2 MLP follow the reference repository's equations
(quad_OC / quad_nn): see the configurations' `source`.
"""

from __future__ import annotations

import numpy as np
import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 `x` rounded to TF32 (1 sign, 8 exponent, 10 mantissa bits),
    to nearest."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


class Arith:
    """The arithmetic a reference computation runs in: "f64" or "tf32"."""

    def __init__(self, prec: str = "f64"):
        if prec not in ("f64", "tf32"):
            raise ValueError(f"unknown precision {prec!r}")
        self.prec = prec
        self.dtype = torch.float64 if prec == "f64" else torch.float32

    def t(self, a) -> torch.Tensor:
        return torch.as_tensor(a).to(self.dtype)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.prec == "tf32":
            return round_tf32(a) @ round_tf32(b)
        return a @ b


# ---------------------------------------------------------------- rotations
def dcm_w2b(q):
    """World -> body direction cosine matrix of q (..., 4), (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    e = [1 - 2 * (y * y + z * z), 2 * (x * y + w * z), 2 * (x * z - w * y),
         2 * (x * y - w * z), 1 - 2 * (x * x + z * z), 2 * (y * z + w * x),
         2 * (x * z + w * y), 2 * (y * z - w * x), 1 - 2 * (x * x + y * y)]
    return torch.stack(e, dim=-1).unflatten(-1, (3, 3))


def omega(w):
    """Omega(w), (..., 4, 4): q_dot = 0.5 Omega(w) q."""
    a, b, c = w.unbind(-1)
    z = torch.zeros_like(a)
    rows = [[z, -a, -b, -c], [a, z, c, -b], [b, -c, z, a], [c, b, -a, z]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rodrigues_quat(v):
    """Quaternion of a Rodrigues vector v (..., 3): [1, v] / sqrt(1 + |v|^2)."""
    s = 1.0 / torch.sqrt(1.0 + torch.sum(v * v, dim=-1, keepdim=True))
    return torch.cat([s, s * v], dim=-1)


def dcm_to_quat(R):
    """Body -> world rotation (..., 3, 3) -> unit quaternion with w >= 0
    (Shepperd: the best-conditioned of the four candidates, the first on a tie)."""
    m = [[R[..., i, j] for j in range(3)] for i in range(3)]
    tr = m[0][0] + m[1][1] + m[2][2]
    mags = torch.stack([1.0 + tr, 1.0 + m[0][0] - m[1][1] - m[2][2],
                        1.0 - m[0][0] + m[1][1] - m[2][2], 1.0 - m[0][0] - m[1][1] + m[2][2]], dim=-1)
    mags = torch.clamp_min(mags, 0.0)
    a, b, c = m[2][1] - m[1][2], m[0][2] - m[2][0], m[1][0] - m[0][1]
    d, e, f = m[0][1] + m[1][0], m[0][2] + m[2][0], m[1][2] + m[2][1]
    cands = torch.stack([
        torch.stack([mags[..., 0], a, b, c], dim=-1),
        torch.stack([a, mags[..., 1], d, e], dim=-1),
        torch.stack([b, d, mags[..., 2], f], dim=-1),
        torch.stack([c, e, f, mags[..., 3]], dim=-1)], dim=-2)
    idx = torch.argmax(mags, dim=-1, keepdim=True)
    q = torch.gather(cands, -2, idx[..., None].expand(*idx.shape[:-1], 1, 4))[..., 0, :]
    q = q / (2.0 * torch.sqrt(torch.clamp_min(torch.gather(mags, -1, idx), 1e-12)))
    return torch.where(q[..., :1] < 0, -q, q)


# ---------------------------------------------------------------- dynamics
def quad_ode(x, u, quad: dict, ar: Arith):
    """f(x, u) of the rigid quadrotor: thrust along body z, gravity, the
    quaternion kinematics and Euler's equations with the X-mixer's moments."""
    v, q, w = x[..., 3:6], x[..., 6:10], x[..., 10:13]
    T = u.sum(dim=-1)
    zero = torch.zeros_like(T)
    ez = torch.stack([zero, zero, T / quad["mass"]], dim=-1)
    acc = ar.mm(dcm_w2b(q).transpose(-1, -2), ez[..., None])[..., 0]
    acc = acc - ar.t(torch.tensor([0.0, 0.0, quad["g"]], dtype=torch.float64)).to(x.device)
    dq = 0.5 * ar.mm(omega(w), q[..., None])[..., 0]
    l2, c = quad["l"] / 2.0, quad["c"]
    mixer = ar.t(torch.tensor([[0.0, -l2, 0.0, l2], [-l2, 0.0, l2, 0.0], [c, -c, c, -c]], dtype=torch.float64)).to(x.device)
    M = ar.mm(mixer, u[..., None])[..., 0]
    J = ar.t(torch.tensor([quad["Jx"], quad["Jy"], quad["Jz"]], dtype=torch.float64)).to(x.device)
    dw = (M - torch.linalg.cross(w, J * w, dim=-1)) / J
    return torch.cat([v, acc, dq, dw], dim=-1)


def euler(x, u, dt, quad, ar):
    return x + dt * quad_ode(x, u, quad, ar)


def euler_renorm(x, u, dt, quad, ar):
    xn = euler(x, u, dt, quad, ar)
    q = xn[..., 6:10]
    q = q / torch.clamp_min(torch.linalg.vector_norm(q, dim=-1, keepdim=True), 1e-12)
    return torch.cat([xn[..., 0:6], q, xn[..., 10:13]], dim=-1)


# ---------------------------------------------------------------- cost
def attitude_error(q, q_goal):
    """tr(I - R(q_goal)^T R(q))."""
    return 3.0 - torch.sum(dcm_w2b(q_goal) * dcm_w2b(q), dim=(-2, -1))


def goal_cost(x, goal, cost: dict):
    r, v, q, w = x[..., 0:3], x[..., 3:6], x[..., 6:10], x[..., 10:13]
    c = (cost["wrf"] * torch.sum((r - goal) ** 2, dim=-1) + cost["wvf"] * torch.sum(v * v, dim=-1)
         + cost["wwf"] * torch.sum(w * w, dim=-1))
    if cost["wqf"] != 0.0:
        ident = torch.cat([torch.ones_like(q[..., :1]), torch.zeros_like(q[..., 1:])], dim=-1)
        c = c + cost["wqf"] * attitude_error(q, ident)
    return c


def trajectory_cost(x0, u_last, U, goal, tra_pos, tra_ang, t, config: dict, ar: Arith):
    """The MPC objective of controls U (B, H, 4) from x0 (B, 13), its
    first control rate against u_last (B, 4):
      sum_k amp exp(-decay (dt k - t)^2) [wrt |r_k - tra_pos|^2 + wqt att_k^p]
            + goal_k + wthrust |u_k|^2 + w_du |u_k - u_{k-1}|^2,  + goal_H,
    att the attitude error against the traversal pose quat(tra_ang), p 2 or
    1 (`squared_attitude`), goal the goal cost, t rounded to 0.1 s in the
    inputs' own precision when `quantize_t`.  U is not clipped: the bounds
    are judged apart.  Returns the cost (B,) in `ar`'s dtype."""
    cost, dt = config["cost"], config["dt"]
    if config.get("quantize_t", True):
        t = torch.round(t * 10.0) / 10.0  # in the problem's dtype, as stated
    x0, u_last, U, goal, tra_pos, t = (ar.t(a) for a in (x0, u_last, U, goal, tra_pos, t))
    tra_q = rodrigues_quat(ar.t(tra_ang))
    H = U.shape[1]
    x, up, total = x0, u_last, torch.zeros_like(t)
    for k in range(H):
        u = U[:, k]
        r, q = x[:, 0:3], x[:, 6:10]
        att = attitude_error(q, tra_q)
        att_term = att * att if cost["squared_attitude"] else att
        w_k = cost["tra_amp"] * torch.exp(-cost["tra_decay"] * (dt * k - t) ** 2)
        total = total + (w_k * (cost["wrt"] * torch.sum((r - tra_pos) ** 2, dim=-1) + cost["wqt"] * att_term)
                         + goal_cost(x, goal, cost) + cost["wthrust"] * torch.sum(u * u, dim=-1)
                         + cost["w_du"] * torch.sum((u - up) ** 2, dim=-1))
        x, up = euler(x, u, dt, config["quad"], ar), u
    return total + goal_cost(x, goal, cost)


def projected_gradient(problem: tuple, U, config: dict, ar: Arith):
    """(cost (B,), the KKT residual (B,)): the largest |dJ/du| over the
    controls that are free to move against it, a control within
    1e-7 (ub - lb) of a bound counting as on it."""
    x0, u_last, goal, tra_pos, tra_ang, t = problem
    U = ar.t(U).detach().requires_grad_(True)
    with torch.enable_grad():
        J = trajectory_cost(x0, u_last, U, goal, tra_pos, tra_ang, t, config, ar)
        (g,) = torch.autograd.grad(J.sum(), U)
    lb, ub = config["bounds"]["u_lb"], config["bounds"]["u_ub"]
    eps = 1e-7 * (ub - lb)
    held = ((U <= lb + eps) & (g > 0)) | ((U >= ub - eps) & (g < 0))
    pg = torch.where(held, torch.zeros_like(g), g.abs()).flatten(1).amax(dim=1)
    return J.detach(), pg.detach()


# ---------------------------------------------------------------- DNN2
class MLP:
    """Dense layers from a flax export (`params/Dense_i/kernel` (in, out),
    `params/Dense_i/bias`), ReLU between them."""

    def __init__(self, path: str, ar: Arith, device):
        with np.load(path) as z:
            n = len([k for k in z.files if k.endswith("/kernel")])
            self.layers = [(ar.t(torch.from_numpy(z[f"params/Dense_{i}/kernel"])).to(device),
                            ar.t(torch.from_numpy(z[f"params/Dense_{i}/bias"])).to(device)) for i in range(n)]
        self.ar = ar

    def __call__(self, x):
        x = self.ar.t(x)
        for i, (W, b) in enumerate(self.layers):
            x = self.ar.mm(x, W) + b
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


# ---------------------------------------------------------------- the gate
def gate_from_width(width, pitch, half_height: float = 1.0):
    """Corners (..., 4, 3) of a gate at the origin, pitched about y."""
    w2, z = width / 2.0, torch.zeros_like(width)
    h = torch.full_like(width, half_height)
    pts = torch.stack([torch.stack(p, dim=-1) for p in
                       ((-w2, z, h), (w2, z, h), (w2, z, -h), (-w2, z, -h))], dim=-2)
    return rotate_y(pts, pitch)


def rotate_y(pts, angle):
    """Corners rotated about their centroid in the x-z plane."""
    c = pts.mean(dim=-2, keepdim=True)
    rel = pts - c
    ca, sa = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    x = ca * rel[..., 0] - sa * rel[..., 2]
    z = sa * rel[..., 0] + ca * rel[..., 2]
    return torch.stack([x, rel[..., 1], z], dim=-1) + c


def gate_moves(pts0, velocity, omega_y: float, noise, dt: float):
    """(moves (B, n+1, 4, 3), velocities (B, n+1, 3)): each step the gate
    turns by dt omega_y about its centroid, then moves by dt (v + noise_k)."""
    v = torch.as_tensor(velocity, dtype=pts0.dtype, device=pts0.device).expand(pts0.shape[0], 3)
    angle = torch.full(pts0.shape[:1], omega_y * dt, dtype=pts0.dtype, device=pts0.device)
    moves, V = [pts0], [v]
    for k in range(noise.shape[1]):
        vel = v + noise[:, k]
        moves.append(rotate_y(moves[-1], angle) + dt * vel[:, None, :])
        V.append(vel)
    return torch.stack(moves, dim=1), torch.stack(V, dim=1)


def gate_frame(pts):
    """World -> window rotation, rows [ax, ay, az]: ay the gate's normal,
    az world z, ax = ay x az."""
    n = torch.linalg.cross(pts[..., 1, :] - pts[..., 0, :], pts[..., 2, :] - pts[..., 1, :], dim=-1)
    ay = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    az = torch.zeros_like(ay)
    az[..., 2] = 1.0
    return torch.stack([torch.linalg.cross(ay, az, dim=-1), ay, az], dim=-2)


def window_inputs(pts, state, final, ar: Arith):
    """DNN2's 18 inputs: the state (13) and the goal (3) in the window
    frame, the gate's width and its pitch estimate."""
    R = gate_frame(pts)
    c = pts.mean(dim=-2)
    mv = lambda M, v: ar.mm(M, v[..., None])[..., 0]  # noqa: E731
    r, v = mv(R, state[..., 0:3] - c), mv(R, state[..., 3:6])
    q = dcm_to_quat(ar.mm(R, dcm_w2b(state[..., 6:10]).transpose(-1, -2)))
    width = torch.linalg.vector_norm(pts[..., 0, :] - pts[..., 1, :], dim=-1)
    pitch = torch.atan((pts[..., 0, 2] - pts[..., 1, 2]) / (pts[..., 0, 0] - pts[..., 1, 0]))
    return torch.cat([r, v, q, state[..., 10:13], mv(R, final - c), width[..., None], pitch[..., None]], dim=-1)


def predicted_inputs(pts, vel, w, t, state, final, ar: Arith):
    """DNN2's inputs at the gate pose predicted t seconds ahead: moved by
    t vel, turned by t w."""
    return window_inputs(rotate_y(pts + (t[..., None] * vel)[..., None, :], t * w), state, final, ar)


def scorecard(states, moves, goal):
    """(traversed (B,), diverged (B,)) of flights: states (B, N+1, 13) after
    the start, moves (B, >=N, 4, 3).  Traversed: the centre crosses the
    moving gate's plane, either way, first inside its rectangle (clearance
    in the window's x and z above 0); diverged: a state not finite or a
    position beyond 50 m."""
    s = states[:, 1:]
    N = s.shape[1]
    mv = moves[:, :N]
    rel = (gate_frame(mv) @ (s[..., 0:3] - mv.mean(dim=-2))[..., None])[..., 0]
    widths = torch.linalg.vector_norm(mv[..., 0, :] - mv[..., 1, :], dim=-1)
    half_h = 0.5 * torch.linalg.vector_norm(mv[..., 0, :] - mv[..., 3, :], dim=-1)
    rel_y = torch.where(torch.isfinite(rel[..., 1]), rel[..., 1], torch.inf)
    behind = rel_y < 0
    crossed = behind[:, :-1] != behind[:, 1:]
    ci = (torch.argmax(crossed.to(torch.int8), dim=1) + 1)[:, None]
    at = lambda a: torch.gather(a, 1, ci)[:, 0]  # noqa: E731
    margin = torch.minimum(at(widths) / 2.0 - at(rel[..., 0]).abs(), at(half_h) - at(rel[..., 2]).abs())
    pos = s[..., 0:3]
    diverged = (~torch.isfinite(s).all(dim=(1, 2))) | (
        torch.where(torch.isfinite(pos), pos, torch.full_like(pos, 1e9)).abs().amax(dim=(1, 2)) > 50.0)
    return crossed.any(dim=1) & (margin > 0), diverged


def rel_gap(a, b):
    """|a - b| / (1 + |b|), elementwise."""
    return (a - b).abs() / (1.0 + b.abs())

