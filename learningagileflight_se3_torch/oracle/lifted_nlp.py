"""Lifted multiple-shooting NLP oracle (test-only, CPU float64).

Port of `learningagileflight_se3_tpu/oracle/lifted_nlp.py`.  It mirrors
the reference's formulation (quad_OC.py:115-174): the decision vector
interleaves states and controls ``w = [X0, U0, X1, U1, ..., U_{H-1}, X_H]``
with the dynamics as H*13 equality constraints
``X_{k+1} - X_k - dt f(X_k, U_k) = 0``, the initial state pinned by bounds
(quad_OC.py:127-129), per-rotor thrust bounds on U and the omega box on X
(quad_policy.py:46-51).  It is solved from problem data only (never from
the solver under test) by the JAX oracle's cascade: a cold L-BFGS-B
shooting globalization, a primal-dual interior-point polish and an
active-set Newton crossover (`method="auto"`), with scipy trust-constr and
an augmented Lagrangian as the other methods.

Every derivative is exact and comes from torch.autograd, in torch.float64
on the CPU, never from `solver/analytic.py`'s closed forms (which the
solver's kernels mirror, so an oracle built on them would share the
formulas it is meant to check):
  * the objective's value and gradient by `torch.autograd.grad`;
  * the dynamics blocks [A_k, B_k, -I]: the Jacobian of the port's
    `euler_step` at every step;
  * the stage-cost Hessian over the triple (x_k, u_k, u_{k-1}) at every
    step, the step index a tensor, and the final-cost Hessian;
  * the constraint Hessian sum_k v_k . f(x_k, u_k), stage by stage.
The per-step blocks are batched over the horizon by `oracle/derivatives.py`
(the JAX oracle's ``vmap(jacfwd)`` and ``vmap(hessian)`` written out by
hand, 3.8 to 5.1 times faster than eager `torch.func.vmap` of them; trust-constr
asks for them thousands of times).
They are assembled into the NLP's block-sparse scipy structures (the role
MUMPS plays under IPOPT): the constraint Jacobian block-banded, the
Lagrangian Hessian block-diagonal over stage triples.  scipy asks for the
value, the Jacobian and the Hessians at the same point in turn, so each
point's derivative blocks are kept in a small cache.

The oracle computes on the host by design: it takes and returns numpy
arrays, has no `device` argument and never calls the solver under test.
It is a yardstick, not an entry point and not a fallback.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import scipy.sparse as sp
import torch
from scipy.optimize import NonlinearConstraint, minimize

from learningagileflight_se3_torch.config import CostWeights, QuadParams, SolverConfig
from learningagileflight_se3_torch.core.rotations import rodrigues_to_quat
from learningagileflight_se3_torch.costs.gate_costs import final_cost, stage_cost
from learningagileflight_se3_torch.dynamics.quadrotor import euler_step, rollout
from learningagileflight_se3_torch.oracle.derivatives import batched_hessian, batched_jacobian
from learningagileflight_se3_torch.oracle.shooting import one_blas_thread, solve_shooting_oracle

NX = 13
NU = 4
F64 = torch.float64


class LiftedSolution(NamedTuple):
    state_traj: np.ndarray    # (H+1, 13)
    control_traj: np.ndarray  # (H, 4)
    cost: float
    constr_violation: float   # max |dynamics defect| at the solution
    kkt_residual: float       # max |projected Lagrangian gradient|
    result: object            # scipy OptimizeResult


def _split(w, H):
    """w (n,) -> X (H+1, NX), U (H, NU) for the interleaved layout."""
    blocks = w[: H * (NX + NU)].reshape(H, NX + NU)
    X = torch.cat([blocks[:, :NX], w[None, H * (NX + NU):]], dim=0)
    U = blocks[:, NX:]
    return X, U


def _f64(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=F64)


class _Cache:
    """The last few points' values, keyed on the point's bytes."""

    def __init__(self, size=4):
        self.size, self.items = size, {}

    def get(self, key, make):
        if key not in self.items:
            if len(self.items) >= self.size:
                self.items.pop(next(iter(self.items)))
            self.items[key] = make()
        return self.items[key]


def _ipm_polish(w, lb, ub, fun, con, con_jac, obj_hess, con_hess,
                n, m, iters=60, tol=1e-9, verbose=False):
    """Primal-dual interior-point refinement of a near-optimal iterate of
        min f(w)  s.t.  c(w) = 0,  lb <= w <= ub.

    Reduced-system Newton (the standard IPOPT scheme, Waechter & Biegler):
    bound multipliers z_l, z_u are eliminated through the complementarity
    rows, giving a bordered sparse system over (dw_free, dv); steps are cut
    by the fraction-to-boundary rule and a backtracking search on the
    primal-dual residual norm; mu decreases once the residual at the current
    barrier is met.  Returns (w, kkt_residual) with the residual measured at
    mu = 0 (true KKT).  Pinned coordinates (lb == ub, the x0 block) are
    eliminated from the variable set entirely."""
    eq_pin = (ub - lb) <= 0.0
    F = np.flatnonzero(~eq_pin)
    has_lb = np.isfinite(lb) & ~eq_pin
    has_ub = np.isfinite(ub) & ~eq_pin
    tau = 0.995

    # strictly interior start on finite sides. IPOPT-style push: WELL
    # interior (1e-2 of the span), not epsilon-close — a bound-active seed
    # coordinate left at distance 1e-8 gets z = mu/sl huge and the
    # fraction-to-boundary rule then strangles every Newton step; pushing
    # it in and letting the mu ladder walk it back converges fast instead.
    span = np.where(np.isfinite(ub - lb), ub - lb, 1.0)
    delta = np.minimum(1e-2 * np.maximum(1.0, span), 0.25 * span)
    w = w.copy()
    w[has_lb] = np.maximum(w[has_lb], (lb + delta)[has_lb])
    w[has_ub] = np.minimum(w[has_ub], (ub - delta)[has_ub])

    def slacks(w_):
        sl = np.where(has_lb, w_ - lb, 1.0)
        su = np.where(has_ub, ub - w_, 1.0)
        return np.maximum(sl, 1e-300), np.maximum(su, 1e-300)

    mu = 1.0
    mu_min = 1e-11
    sl, su = slacks(w)
    z_l = np.where(has_lb, mu / sl, 0.0)
    z_u = np.where(has_ub, mu / su, 0.0)
    J = con_jac(w)
    _, g = fun(w)
    v, *_ = sp.linalg.lsqr(J[:, F].T, -(g - z_l + z_u)[F],
                           atol=1e-14, btol=1e-14, iter_lim=10 * (m + n))

    def residuals(w_, v_, zl_, zu_, mu_, g_, J_, c_):
        sl_, su_ = slacks(w_)
        r_d = (g_ + np.asarray(J_.T @ v_) - zl_ + zu_)[F]
        r_l = np.where(has_lb, sl_ * zl_ - mu_, 0.0)
        r_u = np.where(has_ub, su_ * zu_ - mu_, 0.0)
        return r_d, c_, r_l, r_u

    def res_norm(parts):
        return max(np.abs(p).max(initial=0.0) for p in parts)

    kkt_res = np.inf
    best = [np.inf, w.copy()]  # (true-KKT residual, iterate) across phases
    _dbg = [""]
    phi_hist = []
    for it in range(iters):
        fval, g = fun(w)
        J = con_jac(w)
        c = con(w)
        sl, su = slacks(w)
        parts = residuals(w, v, z_l, z_u, mu, g, J, c)
        phi = res_norm(parts)
        # true (mu=0) KKT residual for reporting / termination
        kkt_res = res_norm(residuals(w, v, z_l, z_u, 0.0, g, J, c))
        if kkt_res < best[0]:
            best[0], best[1] = kkt_res, w.copy()
        if verbose:
            doms = ["r_d", "c", "r_l", "r_u"]
            dom = doms[int(np.argmax([np.abs(p).max(initial=0.0)
                                      for p in parts]))]
            print(f"[ipm] it {it} mu {mu:.1e} phi {phi:.3e} ({dom}) "
                  f"kkt {kkt_res:.3e} cost {fval:.6f} "
                  f"|c| {np.abs(c).max(initial=0):.2e}{_dbg[0]}")
        _dbg[0] = ""
        if kkt_res < tol:
            break
        # creep detection: when fraction-to-boundary jamming at a (near-)
        # degenerate bound stalls the barrier iteration, hand over to the
        # active-set crossover below instead of burning the budget
        phi_hist.append(phi)
        if len(phi_hist) > 6 and phi > 0.95 * phi_hist[-6]:
            break
        if phi < 10.0 * mu:
            if mu <= mu_min:
                break
            mu = max(0.1 * mu, mu_min)
            continue

        r_d, _, r_l, r_u = parts
        D = np.where(has_lb, z_l / sl, 0.0) + np.where(has_ub, z_u / su, 0.0)
        rhs_d = -(r_d + (r_l / sl)[F] - (r_u / su)[F])
        Hl = (obj_hess(w) + con_hess(w, v)).tocsr()
        HFF = Hl[F][:, F] + sp.diags(D[F])
        hscale = max(1.0, float(np.abs(HFF.diagonal()).max()))
        JF = J[:, F]
        nf = F.size
        accepted = False
        for lam in (0.0, 1e-8, 1e-6, 1e-4, 1e-2):
            K = sp.bmat(
                [[HFF + lam * hscale * sp.eye(nf), JF.T],
                 [JF, -1e-13 * sp.eye(m)]], format="csc",
            )
            try:
                sol = sp.linalg.spsolve(K, np.concatenate([rhs_d, -c]))
            except Exception:
                continue
            if not np.all(np.isfinite(sol)):
                continue
            dw = np.zeros(n)
            dw[F] = sol[:nf]
            dv = sol[nf:]  # rhs_d carries J'v inside r_d, so this is the STEP
            dz_l = np.where(has_lb, -(r_l + z_l * dw) / sl, 0.0)
            dz_u = np.where(has_ub, -(r_u - z_u * dw) / su, 0.0)

            # fraction-to-boundary step caps
            def max_step(x, dx, active):
                neg = active & (dx < 0)
                return min(1.0, (tau * x[neg] / -dx[neg]).min(initial=1.0))

            a_pri = min(max_step(sl, dw, has_lb), max_step(su, -dw, has_ub))
            a_dua = min(max_step(z_l, dz_l, has_lb),
                        max_step(z_u, dz_u, has_ub))
            alpha = a_pri
            for _ in range(12):
                w_t = w + alpha * dw
                zl_t = z_l + min(alpha, a_dua) * dz_l
                zu_t = z_u + min(alpha, a_dua) * dz_u
                v_t = v + alpha * dv
                _, g_t = fun(w_t)
                J_t = con_jac(w_t)
                c_t = con(w_t)
                if res_norm(residuals(w_t, v_t, zl_t, zu_t, mu,
                                      g_t, J_t, c_t)) < phi * (1 - 1e-4 * alpha):
                    w, v, z_l, z_u = w_t, v_t, zl_t, zu_t
                    accepted = True
                    _dbg[0] = (f"  lam {lam:.0e} alpha {alpha:.2e} "
                               f"a_pri {a_pri:.2e} a_dua {a_dua:.2e}")
                    break
                alpha *= 0.5
            if accepted:
                break
        if not accepted:
            if mu <= mu_min:
                break
            mu = max(0.1 * mu, mu_min)  # try an easier barrier level

    # ---- crossover: active-set Newton finish --------------------------
    # Near degenerate bounds (slack and multiplier both small) the barrier
    # iteration creeps (fraction-to-boundary caps alpha ~ 1e-4).  The IPM
    # endpoint, however, identifies the active set reliably through the
    # multipliers: active <=> z*sl balance tips to sl -> 0.  Pin those
    # coordinates AT their bounds and Newton-iterate the pure equality KKT
    # system on the rest — quadratic convergence to machine precision, the
    # same interior-point -> simplex "crossover" LP solvers use.
    sl, su = slacks(w)
    rootmu = np.sqrt(np.maximum(mu, 1e-16))
    # CONFIDENT actives only: slack far below the barrier gray zone, scaled
    # by the multiplier strength.  Ambiguous near-bound coordinates stay
    # free — they get clipped-and-pinned below if Newton pushes them out.
    act_l = has_lb & (sl < rootmu * np.minimum(1.0, z_l))
    act_u = has_ub & (su < rootmu * np.minimum(1.0, z_u))
    w = np.where(act_l, lb, np.where(act_u, ub, w))
    for it in range(30):
        w = np.clip(w, lb, ub)
        Fx = np.flatnonzero(~(eq_pin | act_l | act_u))
        fval, g = fun(w)
        J = con_jac(w)
        c = con(w)
        JF = J[:, Fx]
        r_all = g + np.asarray(J.T @ v)
        rd = r_all[Fx]
        phi = max(np.abs(rd).max(initial=0.0), np.abs(c).max(initial=0.0))
        kkt_full = max(
            phi,
            (-r_all[act_l]).max(initial=0.0),
            (r_all[act_u]).max(initial=0.0),
        )
        if kkt_full < best[0]:
            best[0], best[1] = kkt_full, w.copy()
        if verbose:
            print(f"[xover] it {it} phi {phi:.3e} cost {fval:.6f} "
                  f"|c| {np.abs(c).max(initial=0):.2e} nF {Fx.size}")
        if phi < tol:
            kkt_res = phi
            break
        # release pinned coords whose bound multiplier has the wrong sign —
        # only near feasibility, so release/pin cannot cycle while the
        # defect is still being restored
        if np.abs(c).max(initial=0.0) < 1e-7:
            r_full = g + np.asarray(J.T @ v)
            rel_l = act_l & (r_full < -1e-8)
            rel_u = act_u & (r_full > 1e-8)
            if rel_l.any() or rel_u.any():
                act_l, act_u = act_l & ~rel_l, act_u & ~rel_u
                continue
        Hl = (obj_hess(w) + con_hess(w, v)).tocsr()
        HFF = Hl[Fx][:, Fx]
        nf = Fx.size
        hscale = max(1.0, float(np.abs(HFF.diagonal()).max()))
        accepted = False
        for lam in (0.0, 1e-8, 1e-5, 1e-2):
            K = sp.bmat([[HFF + lam * hscale * sp.eye(nf), JF.T],
                         [JF, -1e-13 * sp.eye(m)]], format="csc")
            try:
                sol = sp.linalg.spsolve(K, np.concatenate([-rd, -c]))
            except Exception:
                continue
            if not np.all(np.isfinite(sol)):
                continue
            dw = np.zeros(n)
            dw[Fx] = sol[:nf]
            dv = sol[nf:]
            alpha = 1.0
            for _ in range(25):
                w_t = np.clip(w + alpha * dw, lb, ub)
                v_t = v + alpha * dv
                _, g_t = fun(w_t)
                J_t = con_jac(w_t)
                c_t = con(w_t)
                phi_t = max(
                    np.abs((g_t + np.asarray(J_t.T @ v_t))[Fx]).max(initial=0.0),
                    np.abs(c_t).max(initial=0.0),
                )
                if phi_t < phi * (1 - 1e-4 * alpha):
                    w, v, accepted = w_t, v_t, True
                    kkt_res = phi_t
                    break
                alpha *= 0.5
            if accepted:
                break
        if not accepted:
            break
        # pin any free coordinate the clipped step left ON its bound
        tol_b = 1e-12
        act_l = act_l | (has_lb & (w - lb <= tol_b))
        act_u = act_u | (has_ub & (ub - w <= tol_b))
    # report the final TRUE KKT residual (including any bound-sign error:
    # a pinned coordinate whose multiplier wants to pull inward, or a free
    # coordinate pushed outside its box, shows up here rather than hiding)
    fval, g = fun(w)
    J = con_jac(w)
    c = con(w)
    r_full = g + np.asarray(J.T @ v)
    viol_box = np.maximum(lb - w, 0.0) + np.maximum(w - ub, 0.0)
    kkt_res = max(
        np.abs(r_full[Fx]).max(initial=0.0),
        np.abs(c).max(initial=0.0),
        viol_box.max(initial=0.0),
        (-r_full[act_l]).max(initial=0.0),  # lower-bound mult must be >= 0
        (r_full[act_u]).max(initial=0.0),
    )
    # on degenerate bound geometry the crossover can wander; never return
    # anything worse than the best iterate seen across both phases
    if kkt_res <= best[0]:
        return w, float(kkt_res)
    return best[1], float(best[0])


def solve_lifted_oracle(
    params: QuadParams,
    weights: CostWeights,
    cfg: SolverConfig,
    x0,
    u_last,
    goal_pos,
    tra_pos,
    tra_ang,
    t,
    maxiter: int = 2000,
    state_bound: float = np.inf,
    init: str = "shooting",
    method: str = "auto",
    polish: bool = True,
    polish_iters: int = 150,
    polish_tol: float = 1e-9,
    verbose: bool = False,
) -> LiftedSolution:
    """Cold-start lifted-NLP solve in float64 on the CPU (numpy in, numpy out).

    init='zeros' replicates the reference's w0 exactly (states at the ±1e20
    bound midpoint = 0, quad_OC.py:158); init='rollout' seeds the states
    with the feasible rollout of the midpoint controls; init='shooting'
    (default) runs the cold L-BFGS-B shooting globalization first.  Every
    init is derived from problem data only, never from the solver under
    test, so the comparison stays cold and independent in every mode.

    method='auto' (default): shooting-seeded Newton polish, falling back to
    rollout-seeded trust-constr + polish when the first pass does not reach
    kkt < 1e-6, keeping the better of the two by the JAX oracle's rule."""
    if method == "auto":
        kw = dict(maxiter=maxiter, state_bound=state_bound, polish=polish,
                  polish_iters=polish_iters, polish_tol=polish_tol,
                  verbose=verbose)
        sol1 = solve_lifted_oracle(
            params, weights, cfg, x0, u_last, goal_pos, tra_pos, tra_ang, t,
            init="shooting", method="newton", **kw,
        )
        if sol1.kkt_residual < 1e-6:
            return sol1
        sol2 = solve_lifted_oracle(
            params, weights, cfg, x0, u_last, goal_pos, tra_pos, tra_ang, t,
            init="rollout", method="trust-constr", **kw,
        )
        ok1, ok2 = sol1.kkt_residual < 1e-6, sol2.kkt_residual < 1e-6
        if ok1 and ok2:
            return sol1 if sol1.cost <= sol2.cost else sol2
        if ok1 or ok2:
            return sol1 if ok1 else sol2
        return sol1 if sol1.kkt_residual <= sol2.kkt_residual else sol2

    H, dt = cfg.horizon, cfg.dt
    if cfg.quantize_t:
        t = round(float(t) * 10.0) / 10.0
    t_k = torch.tensor(float(t), dtype=F64)
    tra_quat = rodrigues_to_quat(_f64(tra_ang))
    x0 = np.asarray(x0, np.float64)
    u_last = _f64(u_last)
    goal_pos = _f64(goal_pos)
    tra_pos = _f64(tra_pos)
    n = (H + 1) * NX + H * NU
    m = H * NX
    S = NX + NU  # interleaved block stride

    ks = torch.arange(H, dtype=F64)

    def objective(w):
        X, U = _split(w, H)
        Uprev = torch.cat([u_last[None], U[:-1]], dim=0)
        stages = stage_cost(X[:-1], U, Uprev, ks, dt, t_k, goal_pos, tra_pos, tra_quat, weights)
        return torch.sum(stages) + final_cost(X[H], goal_pos, weights)

    def defects(w):
        X, U = _split(w, H)
        return (euler_step(X[:-1], U, dt, params) - X[1:]).reshape(-1)  # (m,)

    def value_and_grad(f, *args):
        w = _f64(args[0]).requires_grad_()
        val = f(w, *args[1:])
        (g,) = torch.autograd.grad(val, w)
        return float(val.detach()), g.numpy()

    cache = _Cache()

    def at(w, what, make):
        return cache.get((what, np.asarray(w, np.float64).tobytes()), make)

    def fun(w):
        return at(w, "fun", lambda: value_and_grad(objective, w))

    def con(w):
        def make():
            with torch.no_grad():
                return defects(_f64(w)).numpy()
        return at(w, "con", make)

    # ---- sparse constraint Jacobian: rows k -> [A_k | B_k | -I] blocks ----
    def step(xu):
        return euler_step(xu[..., :NX], xu[..., NX:], dt, params)

    # static index pattern (row, col) for [A_k B_k] blocks and the -I blocks
    rows_ab = np.repeat(np.arange(m).reshape(H, NX), S, axis=1).ravel()
    cols_ab = (
        np.arange(H)[:, None, None] * S + np.arange(S)[None, None, :]
    ).repeat(NX, axis=1).ravel()
    rows_eye = np.arange(m)
    cols_eye = (np.arange(H)[:, None] * S + S + np.arange(NX)[None, :]).ravel()
    jac_rows = np.concatenate([rows_ab, rows_eye])
    jac_cols = np.concatenate([cols_ab, cols_eye])

    def con_jac(w):
        def make():
            X, U = _split(_f64(w), H)
            AB = batched_jacobian(step, torch.cat([X[:-1], U], dim=1), NX).numpy()  # (H, NX, S)
            data = np.concatenate([AB.ravel(), -np.ones(m)])
            return sp.csr_matrix((data, (jac_rows, jac_cols)), shape=(m, n))
        return at(w, "con_jac", make)

    # ---- sparse Hessians ----
    # stage-cost Hessian over the triple (x_k, u_k, u_{k-1}): 21x21 blocks,
    # the step index k a tensor broadcast over the triples
    def stage_cost_triple(xuup):
        return stage_cost(
            xuup[..., :NX], xuup[..., NX:NX + NU], xuup[..., NX + NU:], ks, dt, t_k,
            goal_pos, tra_pos, tra_quat, weights,
        )

    # index map: triple slot -> global w index; u_{-1} = u_last is constant,
    # so stage 0's u_prev rows/cols are DROPPED from the assembly.
    def triple_indices(k):
        xk = np.arange(k * S, k * S + NX)
        uk = np.arange(k * S + NX, k * S + S)
        if k == 0:
            up = np.full(NU, -1)  # constant u_last: not a decision variable
        else:
            up = np.arange((k - 1) * S + NX, (k - 1) * S + S)
        return np.concatenate([xk, uk, up])

    tri_idx = np.stack([triple_indices(k) for k in range(H)])  # (H, 21)
    xH_idx = np.arange(H * S, H * S + NX)
    # the assembly's static pattern: every valid (row, col) pair of every
    # triple block, then the final block
    T = NX + 2 * NU
    keep = ((tri_idx >= 0)[:, :, None] & (tri_idx >= 0)[:, None, :]).ravel()
    hess_rows = np.concatenate([np.repeat(tri_idx, T, axis=1).ravel()[keep],
                                np.repeat(xH_idx, NX)])
    hess_cols = np.concatenate([np.tile(tri_idx, (1, T)).ravel()[keep], np.tile(xH_idx, NX)])

    def assemble_block_hess(blocks, final_block=None):
        """blocks (H, 21, 21) on triple indices (+ optional final 13x13)."""
        final = np.zeros(NX * NX) if final_block is None else final_block.ravel()
        data = np.concatenate([blocks.ravel()[keep], final])
        return sp.csr_matrix((data, (hess_rows, hess_cols)), shape=(n, n))

    def obj_hess(w):
        def make():
            X, U = _split(_f64(w), H)
            Uprev = torch.cat([u_last[None], U[:-1]], dim=0)
            XUUP = torch.cat([X[:-1], U, Uprev], dim=1)  # (H, 21)
            blocks = batched_hessian(stage_cost_triple, XUUP).numpy()  # (H, 21, 21)
            final = batched_hessian(lambda xH: final_cost(xH, goal_pos, weights), X[H])
            return assemble_block_hess(blocks, final.numpy())
        return at(w, "obj_hess", make)

    # constraint-Lagrangian Hessian: sum_k hess_{(x_k,u_k)} v_k . f(x_k,u_k)
    def con_hess(w, v):
        X, U = _split(_f64(w), H)
        XU = torch.cat([X[:-1], U], dim=1)
        V = _f64(v).reshape(H, NX)
        blocks = batched_hessian(lambda xu: torch.sum(V * step(xu), dim=-1), XU).numpy()  # (H, S, S)
        big = np.zeros((H, S + NU, S + NU))  # embed (x,u) block in triple
        big[:, :S, :S] = blocks
        return assemble_block_hess(big)

    # bounds: X0 pinned; omega box; thrust box (quad_policy.py:46-51)
    x_lb = np.full(NX, -state_bound)
    x_ub = np.full(NX, state_bound)
    x_lb[10:13] = -cfg.w_bound
    x_ub[10:13] = cfg.w_bound
    u_lb = np.full(NU, cfg.u_lb)
    u_ub = np.full(NU, cfg.u_ub)
    lb = np.concatenate([x0] + [np.concatenate([u_lb, x_lb])] * H)
    ub = np.concatenate([x0] + [np.concatenate([u_ub, x_ub])] * H)

    # the reference's cold w0: X0 = ini_state, controls/states at bound
    # midpoints (quad_OC.py:128,142,158) — the reference's ±1e20 state bounds
    # midpoint to 0; they go to trust-constr as ±inf (so it drops the barrier
    # terms the reference's IPOPT handles natively) and the 0 init stays
    finite = np.isfinite(x_lb) & np.isfinite(x_ub)
    x_mid = np.zeros(NX)
    x_mid[finite] = 0.5 * (x_lb[finite] + x_ub[finite])
    u_mid = 0.5 * (u_lb + u_ub)
    if init == "zeros":
        w0 = np.concatenate([x0] + [np.concatenate([u_mid, x_mid])] * H)
    elif init in ("rollout", "shooting"):
        if init == "shooting":
            # globalization stage: cold L-BFGS-B on the SHOOTING objective
            # from problem-data starts (oracle/shooting.py), whose endpoint
            # seeds the lifted Newton-KKT polish.  The objective is stiff
            # enough that no first-order method finishes (L-BFGS-B stalls
            # about 0.3% above the optimum); the cascade keeps the cold basin
            # choice independent while the exact-Hessian polish supplies the
            # quadratic tail the reference gets from IPOPT's Newton steps.
            # The hard omega box enters by quadratic-penalty CONTINUATION
            # (rho 10 -> 1e6, warm-started), so the polish starts
            # near-feasible.
            rho_ladder = [0.0]
            if np.isfinite(cfg.w_bound):
                rho_ladder = [10.0, 1e2, 1e3, 1e4, 1e5, 1e6]

            # two problem-data-only starts: the reference's bound midpoint
            # (quad_OC.py:142) and hover thrust (m*g/4 per rotor); from
            # some initial attitudes the midpoint-thrust cold rollout
            # diverges (no-renorm Euler) and L-BFGS-B exits after one
            # line-search failure
            u_hover = np.full(
                NU, float(params.mass) * float(params.g) / NU
            ).clip(u_lb, u_ub)
            # attitude-weight homotopy (PYBULLET variant): the UNSQUARED
            # traversal attitude term has a plateau first-order
            # globalization cannot cross, so globalize on the SQUARED
            # objective and continue to the real weights from its solution
            hom_ladder = ([weights] if weights.squared_attitude else
                          [dataclasses.replace(weights, squared_attitude=True),
                           weights])

            # fall back to the reference's midpoint seed if every ladder
            # attempt diverges (non-finite cost)
            best_cost, U_s = np.inf, np.tile(u_mid, (H, 1))
            for u_start in (u_mid, u_hover):
                U_c = np.tile(u_start, (H, 1))
                cost_c = np.inf
                for w_h in hom_ladder:
                    for rho in rho_ladder:
                        _, U_c, cost_c, _ = solve_shooting_oracle(
                            params, w_h,
                            dataclasses.replace(cfg, w_bound_weight=rho),
                            x0, u_last.numpy(), goal_pos.numpy(), tra_pos.numpy(),
                            np.asarray(tra_ang), float(t),
                            U_init=U_c, maxiter=maxiter,
                        )
                if np.isfinite(cost_c) and cost_c < best_cost:
                    best_cost, U_s = cost_c, U_c
            U_seed = np.clip(U_s, u_lb, u_ub)
        else:
            U_seed = np.tile(u_mid, (H, 1))
        with torch.no_grad():
            Xr = rollout(_f64(x0), _f64(U_seed), dt, params).numpy().copy()
        Xr[:, 10:13] = np.clip(Xr[:, 10:13], x_lb[10:13], x_ub[10:13])
        w0 = np.concatenate(
            [x0] + [np.concatenate([U_seed[k], Xr[k + 1]]) for k in range(H)]
        )
    else:
        raise ValueError(init)

    if method == "trust-constr":
        nlc = NonlinearConstraint(con, 0.0, 0.0, jac=con_jac, hess=con_hess)
        with one_blas_thread():
            res = minimize(
                fun,
                w0,
                jac=True,
                hess=obj_hess,
                method="trust-constr",
                bounds=list(zip(lb, ub)),
                constraints=[nlc],
                options={"maxiter": maxiter, "gtol": 1e-10, "xtol": 1e-14},
            )
        w_est = np.asarray(res.x, np.float64)
    elif method == "al":
        # Augmented-Lagrangian outer loop (LANCELOT-style) with L-BFGS-B
        # inner solves: the inner problems carry only the BOX constraints,
        # equality multipliers update by v <- v + mu*c, and mu escalates
        # when the defect norm stalls
        def aug_lag(w, v, mu):
            c = defects(w)
            return objective(w) + torch.dot(v, c) + 0.5 * mu * torch.dot(c, c)

        v_al = np.zeros(m)
        mu = 1e2
        w_est = w0.copy()
        c_norm_prev = np.inf
        nit_total = 0
        bnds = list(zip(lb, ub))
        for _ in range(maxiter // 100 if maxiter >= 100 else 1):
            def al_fun(w, v_=v_al, mu_=mu):
                return value_and_grad(aug_lag, w, _f64(v_), mu_)

            with one_blas_thread():
                inner = minimize(
                    al_fun, w_est, jac=True, method="L-BFGS-B", bounds=bnds,
                    options={"maxiter": 400, "maxcor": 30,
                             "ftol": 1e-16, "gtol": 1e-12},
                )
            w_est = np.asarray(inner.x, np.float64)
            nit_total += inner.nit
            c = con(w_est)
            c_norm = np.abs(c).max(initial=0.0)
            v_al = v_al + mu * c
            if c_norm < 1e-10:
                break
            if c_norm > 0.25 * c_norm_prev:
                mu = min(mu * 10.0, 1e9)
            c_norm_prev = c_norm

        res = SimpleNamespace(x=w_est, niter=nit_total, method="al",
                              mu=mu, status=0)
    elif method == "newton":
        # straight from w0 to the Newton-KKT polish (the cascade mode:
        # pair with init="shooting")
        w_est = w0.copy()
        res = SimpleNamespace(x=w_est, niter=0, method="newton", status=0)
    else:
        raise ValueError(method)

    # ---- primal-dual interior-point polish ----------------------------
    # The globalization stages find the basin but stall short of the
    # optimum; finish with damped Newton on the primal-dual barrier KKT
    # system (the algorithm the reference's IPOPT applies to this NLP,
    # quad_OC.py:174) and the active-set crossover.
    w = np.clip(w_est, lb, ub)
    kkt_res = np.inf
    if polish:
        with one_blas_thread():
            w, kkt_res = _ipm_polish(
                w, lb, ub, fun=fun, con=con, con_jac=con_jac, obj_hess=obj_hess,
                con_hess=con_hess, n=n, m=m, iters=polish_iters, tol=polish_tol,
                verbose=verbose,
            )

    Xs, Us = _split(_f64(w), H)
    return LiftedSolution(
        state_traj=Xs.numpy(),
        control_traj=Us.numpy(),
        cost=float(fun(w)[0]),
        constr_violation=float(np.max(np.abs(con(w)))),
        kkt_residual=float(kkt_res),
        result=res,
    )
