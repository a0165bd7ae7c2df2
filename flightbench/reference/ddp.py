"""A plain control-limited iLQR of the MPC problem, for the solve cell's
judge.  It imports nothing of the port and is written from the problem's
equations (`plain.trajectory_cost`), not from the port's solver: a
Gauss-Newton iLQR on the augmented state z = [x (13), previous control
(4)], state-space regularisation (V_zz + mu I, Tassa 2012), a projected-
Newton box QP for the control bounds, and a line search that tries every
step length of its ladder at once.

Two uses:
  * `polish`: from an answer's controls, a fixed number of iterations in
    float64; what it gains is how far the answer lies from a local optimum
    of its own problem;
  * `solve`: a cold solve at a cell's solver settings (the midpoint start,
    `max_iters`, `tol`), in an `Arith`'s precision: the control, the
    reference in TF32 put in the port's place.

Layout batch-first: Z (B, H+1, 17), U (B, H, 4).  Derivatives are taken by
`torch.func` in float64 and rounded to the arithmetic's dtype; the
backward pass, the box QP's products and the rollouts use the `Arith`'s
products.
"""

from __future__ import annotations

import torch
from torch.func import hessian, jacfwd, jacrev, vmap

from flightbench.reference.plain import Arith, attitude_error, euler, goal_cost, rodrigues_quat

NX, NU = 13, 4
NZ = NX + NU
ALPHAS = 10          # step lengths 1, 1/2, ..., 1/512
MU_INIT, MU_MIN, MU_MAX = 1.0, 1e-9, 1e10
MU_SHRINK, MU_GROW = 0.2, 10.0
BOXQP_ITERS = 6
CHUNK = 8192          # samples a vmapped derivative call holds at once


class Problem:
    """The fixed parts of a batch of problems (x0, u_last, goal, tra_pos,
    tra_ang, t), in the arithmetic's dtype."""

    def __init__(self, problem: tuple, config: dict, ar: Arith):
        x0, u_last, goal, tra_pos, tra_ang, t = problem
        if config.get("quantize_t", True):
            t = torch.round(t * 10.0) / 10.0  # in the problem's dtype, as stated
        cost, H, dt = config["cost"], config["horizon"], config["dt"]
        self.z0 = torch.cat([ar.t(x0), ar.t(u_last)], dim=-1)
        ks = torch.arange(H, dtype=ar.dtype, device=x0.device)
        self.w = cost["tra_amp"] * torch.exp(-cost["tra_decay"] * (dt * ks[None] - ar.t(t)[:, None]) ** 2)
        self.goal, self.tra_pos = ar.t(goal), ar.t(tra_pos)
        self.tra_q = rodrigues_quat(ar.t(tra_ang))
        self.lb, self.ub = config["bounds"]["u_lb"], config["bounds"]["u_ub"]
        self.B, self.H = x0.shape[0], H


def stage(z, u, w, goal, tra_pos, tra_q, config: dict):
    """The stage cost l(z, u) (leading dims broadcast)."""
    cost = config["cost"]
    x, up = z[..., :NX], z[..., NX:]
    att = attitude_error(x[..., 6:10], tra_q)
    att_term = att * att if cost["squared_attitude"] else att
    return (w * (cost["wrt"] * torch.sum((x[..., 0:3] - tra_pos) ** 2, dim=-1) + cost["wqt"] * att_term)
            + goal_cost(x, goal, cost) + cost["wthrust"] * torch.sum(u * u, dim=-1)
            + cost["w_du"] * torch.sum((u - up) ** 2, dim=-1))


def step(z, u, config: dict, ar: Arith):
    """z' = [euler(x, u), u]."""
    return torch.cat([euler(z[..., :NX], u, config["dt"], config["quad"], ar), u], dim=-1)


def rollout(p: Problem, Z, U, kff, K, alphas, config: dict, ar: Arith):
    """Closed-loop rollouts u = clip(U + a kff + K (z - Z)) about Z (B, H+1,
    17), U (B, H, 4) with gains kff (B, H, 4), K (B, H, 4, 17), at every
    step length a of `alphas` (A,): (Z (A, B, H+1, 17), U (A, B, H, 4),
    J (A, B))."""
    a = alphas[:, None, None]
    z = p.z0.expand(alphas.shape[0], p.B, NZ)
    J = torch.zeros(z.shape[:2], dtype=ar.dtype, device=z.device)
    Zs, Us = [z], []
    for k in range(p.H):
        u = U[:, k] + a * kff[:, k] + ar.mm(K[:, k], (z - Z[:, k])[..., None])[..., 0]
        u = torch.clamp(u, p.lb, p.ub)
        J = J + stage(z, u, p.w[:, k], p.goal, p.tra_pos, p.tra_q, config)
        z = step(z, u, config, ar)
        Zs.append(z)
        Us.append(u)
    J = J + goal_cost(z[..., :NX], p.goal, config["cost"])
    return torch.stack(Zs, dim=2), torch.stack(Us, dim=2), J


def open_loop(p: Problem, U, config: dict, ar: Arith):
    """(Z (B, H+1, 17), J (B,)) of controls U (B, H, 4) within the bounds."""
    zeros = lambda *shape: torch.zeros(shape, dtype=ar.dtype, device=U.device)  # noqa: E731
    Z, _, J = rollout(p, zeros(p.B, p.H + 1, NZ), U, zeros(p.B, p.H, NU), zeros(p.B, p.H, NU, NZ),
                      zeros(1), config, ar)
    return Z[0], J[0]


def derivatives(p: Problem, Z, U, config: dict, ar: Arith):
    """fz (B,H,17,17), fu (B,H,17,4), l_zu (B,H,21), l_zu_zu (B,H,21,21) and
    the terminal V_z (B,17), V_zz (B,17,17), in `ar`'s dtype; taken in
    float64 with exact products (TF32's rounding has no derivative)."""
    ex = Arith("f64")
    B, H = p.B, p.H
    d = lambda a: a.to(torch.float64)  # noqa: E731
    zf, uf = d(Z[:, :H].reshape(B * H, NZ)), d(U.reshape(B * H, NU))
    rep = lambda a: d(a)[:, None].expand(B, H, *a.shape[1:]).reshape(B * H, *a.shape[1:])  # noqa: E731
    wf = d(p.w.reshape(B * H))
    goal, tra_pos, tra_q = rep(p.goal), rep(p.tra_pos), rep(p.tra_q)

    def f(z, u):
        return step(z, u, config, ex)

    def l(zu, w, g, tp, tq):
        return stage(zu[:NZ], zu[NZ:], w, g, tp, tq, config)

    fz, fu = vmap(jacfwd(f, argnums=(0, 1)), chunk_size=CHUNK)(zf, uf)
    zu = torch.cat([zf, uf], dim=-1)
    lg = vmap(jacrev(l), chunk_size=CHUNK)(zu, wf, goal, tra_pos, tra_q)
    lh = vmap(hessian(l), chunk_size=CHUNK)(zu, wf, goal, tra_pos, tra_q)

    def phi(z, g):
        return goal_cost(z[:NX], g, config["cost"])

    Vz = vmap(jacrev(phi))(d(Z[:, H]), d(p.goal)).to(ar.dtype)
    Vzz = vmap(hessian(phi))(d(Z[:, H]), d(p.goal)).to(ar.dtype)
    sh = lambda a: a.reshape(B, H, *a.shape[1:]).to(ar.dtype)  # noqa: E731
    return sh(fz), sh(fu), sh(lg), sh(lh), Vz, Vzz


def _mv(ar, M, v):
    return ar.mm(M, v[..., None])[..., 0]


def _masked(M, free):
    f = free.to(M.dtype)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    return M * f[..., :, None] * f[..., None, :] + eye * (1.0 - f)[..., None, :]


def boxqp(Hm, g, lo, hi, ar: Arith):
    """min 0.5 d^T H d + g^T d on lo <= d <= hi, projected Newton with a
    projected step of lengths 1, 1/2, 1/4, 1/8 tried together: (d (B,4),
    free (B,4) bool)."""
    obj = lambda x: 0.5 * torch.sum(x * _mv(ar, Hm, x), dim=-1) + torch.sum(g * x, dim=-1)  # noqa: E731
    scales = torch.tensor([1.0, 0.5, 0.25, 0.125], dtype=g.dtype, device=g.device)[:, None, None]
    d = torch.clamp(torch.zeros_like(g), lo, hi)
    best = obj(d)
    for _ in range(BOXQP_ITERS):
        grad = g + _mv(ar, Hm, d)
        free = ~(((d <= lo) & (grad > 0)) | ((d >= hi) & (grad < 0)))
        L, _ = torch.linalg.cholesky_ex(_masked(Hm, free))
        stp = torch.cholesky_solve((-grad * free)[..., None], L)[..., 0] * free
        cand = torch.clamp(d + scales * stp, lo, hi)
        vals = obj(cand)
        i = torch.argmin(vals, dim=0)
        val = vals.gather(0, i[None])[0]
        take = val < best
        d = torch.where(take[:, None], cand[i, torch.arange(g.shape[0], device=g.device)], d)
        best = torch.where(take, val, best)
    grad = g + _mv(ar, Hm, d)
    return d, ~(((d <= lo) & (grad > 0)) | ((d >= hi) & (grad < 0)))


def backward(p: Problem, Z, U, mu, config: dict, ar: Arith):
    """The backward pass at regularisation mu (B,): (kff (B,H,4), K
    (B,H,4,17), dV1 (B,), dV2 (B,), fail (B,) bool)."""
    fz, fu, lg, lh, Vz, Vzz = derivatives(p, Z, U, config, ar)
    B, H = p.B, p.H
    T = lambda M: M.transpose(-1, -2)  # noqa: E731
    kff = torch.zeros((B, H, NU), dtype=ar.dtype, device=Z.device)
    K = torch.zeros((B, H, NU, NZ), dtype=ar.dtype, device=Z.device)
    dV1 = torch.zeros(B, dtype=ar.dtype, device=Z.device)
    dV2 = torch.zeros_like(dV1)
    fail = torch.zeros(B, dtype=torch.bool, device=Z.device)
    m = mu[:, None, None]
    for k in reversed(range(H)):
        A, Bm = fz[:, k], fu[:, k]
        lz, lu = lg[:, k, :NZ], lg[:, k, NZ:]
        lzz, luu, luz = lh[:, k, :NZ, :NZ], lh[:, k, NZ:, NZ:], lh[:, k, NZ:, :NZ]
        Qz, Qu = lz + _mv(ar, T(A), Vz), lu + _mv(ar, T(Bm), Vz)
        VA, VB = ar.mm(Vzz, A), ar.mm(Vzz, Bm)
        Qzz = lzz + ar.mm(T(A), VA)
        Quu = luu + ar.mm(T(Bm), VB)
        Quz = luz + ar.mm(T(Bm), VA)
        Quu_r = Quu + m * ar.mm(T(Bm), Bm)
        Quz_r = Quz + m * ar.mm(T(Bm), A)
        Quu_r = 0.5 * (Quu_r + T(Quu_r))
        _, info = torch.linalg.cholesky_ex(Quu_r)
        fail = fail | (info != 0)
        d, free = boxqp(Quu_r, Qu, p.lb - U[:, k], p.ub - U[:, k], ar)
        Lf, _ = torch.linalg.cholesky_ex(_masked(Quu_r, free))
        Kk = -torch.cholesky_solve(Quz_r * free[..., None], Lf) * free[..., None]
        kff[:, k], K[:, k] = d, Kk
        dV1 = dV1 + torch.sum(d * Qu, dim=-1)
        dV2 = dV2 + 0.5 * torch.sum(d * _mv(ar, Quu, d), dim=-1)
        Vz = Qz + _mv(ar, T(Kk), _mv(ar, Quu, d)) + _mv(ar, T(Kk), Qu) + _mv(ar, T(Quz), d)
        Vzz = Qzz + ar.mm(T(Kk), ar.mm(Quu, Kk)) + ar.mm(T(Kk), Quz) + ar.mm(T(Quz), Kk)
        Vzz = 0.5 * (Vzz + T(Vzz))
    fail = fail | ~torch.isfinite(dV1) | ~torch.isfinite(dV2)
    return kff, K, dV1, dV2, fail


def iterate(p: Problem, Z, U, J, mu, live, config: dict, ar: Arith):
    """One iLQR iteration on the live lanes: (Z, U, J, mu, whether the
    backward pass failed, its expected decrement)."""
    kff, K, dV1, dV2, fail = backward(p, Z, U, mu, config, ar)
    alphas = 0.5 ** torch.arange(ALPHAS, dtype=ar.dtype, device=Z.device)
    Zn, Un, Jn = rollout(p, Z, U, kff, K, alphas, config, ar)
    expected = -(alphas[:, None] * dV1 + alphas[:, None] ** 2 * dV2)
    ok = (Jn < J) & (expected > 0) & ((J - Jn) > 0.1 * expected) & ~fail & live
    first = torch.argmax(ok.to(torch.int8), dim=0)
    acc = ok.any(dim=0)
    pick = lambda a: a[first, torch.arange(p.B, device=Z.device)]  # noqa: E731
    Z = torch.where(acc[:, None, None], pick(Zn), Z)
    U = torch.where(acc[:, None, None], pick(Un), U)
    J = torch.where(acc, pick(Jn), J)
    mu = torch.where(live, torch.where(acc, torch.clamp_min(mu * MU_SHRINK, MU_MIN), mu * MU_GROW), mu)
    return Z, U, J, mu, fail, -(dV1 + dV2)


def polish(problem: tuple, U0, config: dict, iters: int):
    """The float64 reference from controls U0 (B, H, 4), clipped to the
    bounds: (J of U0 (B,), J after `iters` iterations (B,)), both the
    reference's costs."""
    ar = Arith("f64")
    p = Problem(problem, config, ar)
    U = torch.clamp(ar.t(U0), p.lb, p.ub)
    Z, J0 = open_loop(p, U, config, ar)
    J, mu = J0, torch.full_like(J0, MU_INIT)
    for _ in range(iters):
        live = torch.isfinite(J) & (mu <= MU_MAX)
        if not bool(live.any()):
            break
        Z, U, J, mu, *_ = iterate(p, Z, U, J, mu, live, config, ar)
    return J0, J


def solve(problem: tuple, config: dict, solver: dict, ar: Arith):
    """A cold solve from the midpoint of the bounds at the cell's
    `max_iters` and `tol`, in `ar`: (U (B,H,4), J (B,) in `ar`'s own
    arithmetic, status (B,): 1 converged (the expected decrement of a
    backward pass that did not fail under tol (1 + |J|)), 0 at the cap, 4
    regularisation past its largest)."""
    p = Problem(problem, config, ar)
    U = torch.full((p.B, p.H, NU), 0.5 * (p.lb + p.ub), dtype=ar.dtype, device=p.z0.device)
    Z, J = open_loop(p, U, config, ar)
    mu = torch.full_like(J, MU_INIT)
    status = torch.zeros(p.B, dtype=torch.int32, device=J.device)
    done = ~torch.isfinite(J)
    tol = solver["tol"]
    for _ in range(solver["max_iters"]):
        live = ~done
        if not bool(live.any()):
            break
        Z, U, J, mu, fail, decrement = iterate(p, Z, U, J, mu, live, config, ar)
        scale = tol * (1.0 + J.abs())
        conv = live & ~fail & (decrement < scale)
        blow = live & ~conv & (mu > MU_MAX)
        status = torch.where(conv, 1, torch.where(blow, 4, status))
        done = done | conv | blow
    return U, J, status
