"""Parallel-in-time Riccati backward pass, batched over the solver's lanes.

Port of `learningagileflight_se3_tpu/solver/parallel_riccati.py`
(`make_parallel_backward`).  The sequential sweep (K2) walks the H steps
one after another; here the LQR value recursion is written as an
associative composition of value-function maps, and all H suffix
compositions come out of a scan of O(log H) depth (Särkkä and
García-Fernández, "Temporal Parallelization of Dynamic Programming and
Linear Quadratic Control").

Each step's element e_k = (A, b, C, eta, J) maps the value function

    V_{k+1}(y) = 1/2 y'S y - v'y   ->   V_k(x) = 1/2 x'S'x - v''x
    S' = J + A' (I + S C)^{-1} S A
    v' = eta + A' (I + S C)^{-1} (v - S b)

built from the step's LQR data (dynamics x' = F x + L u, stage cost
1/2 x'X x + r'x + 1/2 u'R u + s'u + u'M x):

    A = F - L R^{-1} M        b = -L R^{-1} s       C = L R^{-1} L'
    J = X - M' R^{-1} M       eta = -(r - M' R^{-1} s)

Two maps compose (e_earlier o e_later) in closed form (`_combine`).  The
scan is Hillis-Steele over the H+1 elements [e_0, ..., e_{H-1},
e_terminal]: in round d (d = 1, 2, 4, ...) element k becomes
e_k o e_{k+d} for every k < H+1-d at once, so after ceil(log2(H+1)) rounds
(6 at H = 50; the element count need not be a power of two) element k holds
the suffix e_k o ... o e_terminal, the value function at step k.  The gains
and the thrust-box projection (boxQP) then run for all steps together.

Two passes, as in the JAX module: the unclamped values give a provisional
active set; the values are propagated again with pass 1's clamped controls
held at their bound deviations, and the gains are recomputed against them.
`fail` ORs the four 4x4 pivot checks with a finiteness check.  Gauss-Newton
(iLQR) mode only: the second-order dynamics term of `use_ddp` depends on
the running value gradient, which breaks associativity, so the solver
refuses `cfg.backward="parallel"` with `use_ddp=True`.

No kernel: the JAX package computes this outside any Pallas kernel, and
here it is plain PyTorch over the lanes (batched `torch.linalg.solve_ex`
and `matmul`), on the tensors' device.  Layout: the derivatives come in
K3's time-major, batch-last layout (`ops/riccati_unfused.py`) and are
moved batch-first once per sweep; the outputs are K2's (kk (H,4,B), KK
(H,4,17,B), dV1, dV2, fail, pg (B,)).
"""

from __future__ import annotations

import functools

import torch

from learningagileflight_se3_torch.config import CostWeights, QuadParams, SolverConfig
from learningagileflight_se3_torch.ops.riccati_unfused import derivatives_plain, projected_gradient
from learningagileflight_se3_torch.solver.boxqp import boxqp, masked_matrix
from learningagileflight_se3_torch.solver.chol4 import chol4_factor, chol4_solve_factored

NX = 13
NU = 4
NZ = NX + NU


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _tr(M):
    return M.transpose(-1, -2)


def _sym(M):
    return 0.5 * (M + _tr(M))


def _lanes(X):
    """(B,H,r,...) -> (r,...,B,H): the lane layout of chol4 and boxqp."""
    return X.movedim((0, 1), (-2, -1))


def _unlanes(X):
    return X.movedim((-2, -1), (0, 1))


def _combine(ei, ej):
    """Compose value maps, ei covering the EARLIER interval and ej the later,
    batched over leading axes:

        D1 = (I + C_i J_j)^{-1}           D2 = (I + J_j C_i)^{-1}
        A = A_j D1 A_i                    b = A_j D1 (b_i + C_i eta_j) + b_j
        C = A_j D1 C_i A_j' + C_j
        eta = A_i' D2 (eta_j - J_j b_i) + eta_i
        J = A_i' D2 J_j A_i + J_i

    then C and J re-symmetrised.  One LU solve per inverse, its right-hand
    sides side by side, without the error check that would wait for the
    device (a singular system gives non-finite values, which the sweep's
    finiteness check turns into `fail`, as in the JAX module)."""
    Ai, bi, Ci, etai, Ji = ei
    Aj, bj, Cj, etaj, Jj = ej
    eye = torch.eye(NZ, dtype=Ai.dtype, device=Ai.device)
    D1, _ = torch.linalg.solve_ex(eye + Ci @ Jj, torch.cat([Ai, Ci, (bi + _mv(Ci, etaj))[..., None]], dim=-1))
    D2, _ = torch.linalg.solve_ex(eye + Jj @ Ci, torch.cat([Jj, (etaj - _mv(Jj, bi))[..., None]], dim=-1))
    D1Ai, D1Ci, D1b = D1[..., :NZ], D1[..., NZ:2 * NZ], D1[..., 2 * NZ]
    D2Jj, D2eta = D2[..., :NZ], D2[..., NZ]
    Ac = Aj @ D1Ai
    bc = _mv(Aj, D1b) + bj
    Cc = Aj @ D1Ci @ _tr(Aj) + Cj
    etac = _mv(_tr(Ai), D2eta) + etai
    Jc = _tr(Ai) @ D2Jj @ Ai + Ji
    return Ac, bc, _sym(Cc), etac, _sym(Jc)


def suffix_scan(elems):
    """Hillis-Steele suffix scan of `_combine` along axis 1 of (B, N, ...)
    elements: out[:, k] = e_k o e_{k+1} o ... o e_{N-1}, in ceil(log2 N)
    rounds of one batched `_combine` each."""
    out = list(elems)
    N = out[0].shape[1]
    d = 1
    while d < N:
        comb = _combine([x[:, :N - d] for x in out], [x[:, d:] for x in out])
        out = [torch.cat([c, x[:, N - d:]], dim=1) for c, x in zip(comb, out)]
        d *= 2
    return out


def derivatives(ZU, t_w, goal, tra_pos, Hatt, att0, phi_z, phi_zz,
                params: QuadParams, weights: CostWeights, cfg: SolverConfig):
    """K2's inputs (ops/riccati_fused.py layout, without reg) -> the tuple the
    parallel sweep consumes, (A, B, lz, lu, lzz, luz, luu, phi_z, phi_zz, ZU,
    pg_true), in K3's layout: the closed-form Jacobians and cost quadratics
    of `derivatives_plain` and the true projected gradient from the adjoint
    (solver/ilqr.py `derivatives`)."""
    A, Bm, lz, lu, lzz, luz, luu, U, ZU, phi_z, phi_zz, _ = derivatives_plain(
        ZU, t_w, goal, tra_pos, Hatt, att0, phi_z, phi_zz, None, params, weights, cfg)
    pg = projected_gradient(A, Bm, lz, lu, U, phi_z, cfg.u_lb, cfg.u_ub)
    return A, Bm, lz, lu, lzz, luz, luu, phi_z, phi_zz, ZU, pg


def _elements(A, Bd, lz, lu, lzz, luz, luu, free, u_fix):
    """Per-step elements, (B,H,...), with the control dims in `free` (B,H,4)
    as decisions and the clamped ones held at the deviation u_fix: the
    dynamics pick up the affine term B (u_fix * (1-free)), the cost folds the
    fixed controls into its linear parts, and the masked 4x4 R is factored
    as the sequential sweep's masked Cholesky is.  free = 1, u_fix = 0 is
    the plain unclamped element.  Returns (elements, ok (B,H))."""
    u_c = u_fix * (1.0 - free)
    c_dyn = _mv(Bd, u_c)
    Bm = Bd * free[..., None, :]
    Rm = luu * (free[..., :, None] * free[..., None, :]) + torch.diag_embed(1.0 - free)
    s_eff = (lu + _mv(luu, u_c)) * free
    M_eff = luz * free[..., :, None]
    r_eff = lz + _mv(_tr(luz), u_c)

    L, ok = chol4_factor(_lanes(Rm))
    solve = lambda X: _unlanes(chol4_solve_factored(L, _lanes(X)))
    RiM, Ris, RiBt = solve(M_eff), solve(s_eff), solve(_tr(Bm))
    Ae = A - Bm @ RiM
    be = c_dyn - _mv(Bm, Ris)
    Ce = _sym(Bm @ RiBt)
    Je = _sym(lzz - _tr(M_eff) @ RiM)
    etae = -(r_eff - _mv(_tr(M_eff), Ris))
    return (Ae, be, Ce, etae, Je), ok


def _values(elems, phi_z, phi_zz):
    """(S_{k+1}, Vz_{k+1}) for k = 0..H-1 from the suffix compositions of the
    stage elements and the terminal (0, 0, 0, -phi_z, phi_zz)."""
    Bt = phi_z.shape[0]
    zM = phi_zz.new_zeros((Bt, 1, NZ, NZ))
    zv = phi_z.new_zeros((Bt, 1, NZ))
    terminal = (zM, zv, zM, -phi_z[:, None], phi_zz[:, None])
    out = suffix_scan([torch.cat([e, t], dim=1) for e, t in zip(elems, terminal)])
    return out[4][:, 1:], -out[3][:, 1:]


def _gains(A, Bd, lu, luz, luu, U, S1, Vz1, reg, lb, ub, boxqp_iters):
    """The sequential sweep's per-step gain formulas at every step at once
    (boxQP included) -> kk (B,H,4), KK (B,H,4,17), dV1, dV2 (B,), free
    (B,H,4), ok (B,H)."""
    Bt = _tr(Bd)
    Qu = lu + _mv(Bt, Vz1)
    BtS = Bt @ S1
    Quz = luz + BtS @ A
    Quu = luu + BtS @ Bd
    r = reg[:, None, None, None]
    Quu_r = _sym(Quu + r * (Bt @ Bd))
    Quz_r = Quz + r * (Bt @ A)
    Quu_l = _lanes(Quu_r)
    kf, free = boxqp(Quu_l, _lanes(Qu), _lanes(lb - U), _lanes(ub - U), iters=boxqp_iters)
    Lk, ok = chol4_factor(masked_matrix(Quu_l, free))
    K = -chol4_solve_factored(Lk, _lanes(Quz_r) * free[:, None]) * free[:, None]
    kf, K, free = _unlanes(kf), _unlanes(K), _unlanes(free)
    dV1 = torch.sum(kf * Qu, dim=(1, 2))
    dV2 = 0.5 * torch.sum(kf * _mv(Quu, kf), dim=(1, 2))
    return kf, K, dV1, dV2, free, ok


def parallel_backward(derivs, U, reg, cfg: SolverConfig, lb: float, ub: float):
    """The parallel-in-time sweep: derivs (the tuple of `derivatives`), U
    (H,4,B), reg (B,) -> (kk, KK, dV1, dV2, fail, pg), the outputs of the
    sequential sweep (K2) in its layout.  cfg.use_ddp's second-order
    dynamics terms are not included (Gauss-Newton / iLQR mode)."""
    first = lambda x: x.movedim(-1, 0)  # (H,...,B) -> (B,H,...)
    A, Bd, lz, lu, lzz, luz, luu, phi_z, phi_zz, _, pg_true = derivs
    A, Bd, lz, lu, lzz, luz, luu, Ub = (first(x) for x in (A, Bd, lz, lu, lzz, luz, luu, U))
    phi_z, phi_zz = first(phi_z), first(phi_zz)
    reg = torch.as_tensor(reg, dtype=A.dtype, device=A.device).reshape(-1).expand(A.shape[0])

    # pass 1: unclamped value propagation -> provisional active set
    elems0, ok0 = _elements(A, Bd, lz, lu, lzz, luz, luu, torch.ones_like(Ub), torch.zeros_like(Ub))
    S1, Vz1 = _values(elems0, phi_z, phi_zz)
    kk, _, _, _, free1, ok1 = _gains(A, Bd, lu, luz, luu, Ub, S1, Vz1, reg, lb, ub, cfg.boxqp_iters)

    # pass 2 (active-set refinement): the values again with pass 1's clamped
    # dims held at their bound deviations, then the gains against them
    elems1, ok2 = _elements(A, Bd, lz, lu, lzz, luz, luu, free1, kk)
    S1r, Vz1r = _values(elems1, phi_z, phi_zz)
    kk, KK, dV1, dV2, _, ok3 = _gains(A, Bd, lu, luz, luu, Ub, S1r, Vz1r, reg, lb, ub, cfg.boxqp_iters)

    every = lambda x: x.reshape(x.shape[0], -1).all(dim=1)
    finite = every(torch.isfinite(kk)) & every(torch.isfinite(KK)) & every(torch.isfinite(S1r))
    fail = ~(every(ok0) & every(ok1) & every(ok2) & every(ok3) & finite)
    last = lambda x: x.movedim(0, -1).contiguous()  # (B,H,...) -> (H,...,B)
    return last(kk), last(KK), dV1, dV2, fail, pg_true


def make_parallel_backward(cfg: SolverConfig, lb: float, ub: float):
    """parallel_backward(derivs, U, reg) with cfg and the thrust box bound:
    the JAX module's factory."""
    return functools.partial(parallel_backward, cfg=cfg, lb=lb, ub=ub)
