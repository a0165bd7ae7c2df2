"""K6: the per-lane glue of a DDP iteration, around K2, K1 and K5.

A DDP iteration of the batched solver (`solver/ilqr_batched.py`
`BatchedSolver.iteration`) is K2, the line search (K1 over the trial grid,
then K5) and, around them, per-lane tests and selects.  They run in three
steps:

  * `prepare`, before K2: the sweep's input ZU = [Z[:-1]; U] and the
    terminal quadratics phi_z, phi_zz of Z[H];
  * `decide`, after K2: which lanes are active and which deep, the step
    length each trip gives each lane (`ops/line_search.py alpha_grid`), and
    `go`, whether any lane is active;
  * `commit`, after K5: the new state, every field gated by `go`.

CUDA kernel: `csrc/ddp_glue.cu`, one launch a step, every value rounded as
PyTorch rounds it.  The plain versions (`prepare_plain`, `decide_plain`,
`commit_plain`) are the solver's PyTorch statement of the same steps; each
wrapper takes its plain version for CPU tensors and the kernel for CUDA
tensors.

Layout: Z (H+1,17,B), U (H,4,B), KK (H,4,17,B), goal (3,B), the per-lane
fields (B,), alpha (n_trials,B); ZU (H,21,B), phi_z (17,B), phi_zz
(17,17,B).  A state is the solver's `SolveState`, or any NamedTuple with its
fields.
"""

from __future__ import annotations

import ctypes

import torch

from learningagileflight_se3_torch.config import CostWeights, SolverConfig
from learningagileflight_se3_torch.ops import build
from learningagileflight_se3_torch.ops import line_search as ls_grid
from learningagileflight_se3_torch.solver.analytic import make_final_quadratics

NZ, NU = 17, 4

launches = 0     # kernel launches (CUDA tensors)
plain_calls = 0  # calls of the plain versions


def glue_consts(cfg: SolverConfig, weights: CostWeights, ladder: ls_grid.Ladder, n_trials: int) -> build.GlueConsts:
    """The constants as the plain versions' Python forms them (2.0 * wrf,
    reg_max * 2.0), rounded to the tensors' dtype in the kernel."""
    return build.GlueConsts(
        cfg.tol, cfg.gtol, cfg.stall_gtol, cfg.reg_shrink, cfg.reg_min, cfg.reg_grow, cfg.reg_max * 2.0,
        cfg.reg_max, 2.0 * weights.wrf, 2.0 * weights.wvf, 2.0 * weights.wwf, weights.wqf,
        *ladder, n_trials, int(cfg.ls_max_trips < cfg.line_search_steps), cfg.no_progress_iters,
        int(cfg.ls_adaptive), int(weights.wqf != 0.0),
    )


def _launch(step: str, dtype, device, *args) -> None:
    global launches
    fn = getattr(build.library().lib, f"laf_glue_{step}_{'f64' if dtype == torch.float64 else 'f32'}")
    ptrs = [a.data_ptr() if torch.is_tensor(a) else a for a in args]
    with torch.cuda.device(device):
        rc = fn(*ptrs, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ddp_glue.{step}: CUDA launch failed with cudaError {rc}")
    launches += 1


def _check(op: str, floats: dict, shapes: dict, others: dict = None):
    device, dtype = build.check_tensors(op, shapes, floats)
    for name, (t, want, shape) in (others or {}).items():
        if t.dtype != want or tuple(t.shape) != shape or t.device != device or not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be a contiguous {want} {shape} tensor on {device}")
    return device, dtype


# ------------------------------------------------------------------ prepare
def prepare_plain(Z, U, goal, weights: CostWeights):
    """Plain PyTorch version: (ZU, phi_z, phi_zz)."""
    global plain_calls
    plain_calls += 1
    ZU = torch.cat([Z[:-1], U], dim=1)
    phi_z, phi_zz = make_final_quadratics(weights)(Z[-1].T, goal.T)
    phi_z, phi_zz = phi_z.T.contiguous(), phi_zz.permute(1, 2, 0).contiguous()
    return ZU, phi_z, phi_zz


def prepare(Z, U, goal, weights: CostWeights, consts: build.GlueConsts):
    """K6's prepare on the tensors' device (the plain version for CPU
    tensors): (ZU (H,21,B), phi_z (17,B), phi_zz (17,17,B))."""
    H, B = U.shape[0], U.shape[-1]
    device, dtype = _check("prepare", dict(Z=Z, U=U, goal=goal), dict(Z=(H + 1, NZ, B), U=(H, NU, B), goal=(3, B)))
    if device.type == "cpu":
        return prepare_plain(Z, U, goal, weights)
    kw = dict(dtype=dtype, device=device)
    ZU = torch.empty((H, NZ + NU, B), **kw)
    phi_z, phi_zz = torch.empty((NZ, B), **kw), torch.empty((NZ, NZ, B), **kw)
    _launch("prepare", dtype, device, ctypes.byref(consts), H, B, Z, U, goal, ZU, phi_z, phi_zz)
    return ZU, phi_z, phi_zz


# ------------------------------------------------------------------- decide
def decide_plain(s, dV1, dV2, cfg: SolverConfig, ladder: ls_grid.Ladder, n_trials: int):
    """Plain PyTorch version: (deep, skip, alpha, go)."""
    global plain_calls
    plain_calls += 1
    decrement = -(dV1 + dV2)
    scale = s.J.abs() + 1.0
    active = ~s.done & (s.it < s.max_iters)
    # ladder escalation for live failure streaks; no-op under a full ladder
    if cfg.ls_max_trips < cfg.line_search_steps:
        deep = (s.n_np >= 2) & (decrement > cfg.tol * scale) & active
    else:
        deep = torch.zeros_like(active)
    alphas = 0.5 ** torch.arange(ladder.n_alpha, dtype=s.J.dtype, device=s.J.device)
    alpha = ls_grid.alpha_grid(alphas, s.ls0, deep, n_trials, ladder)
    return deep, ~active, alpha, active.any()


def decide(s, dV1, dV2, cfg: SolverConfig, ladder: ls_grid.Ladder, n_trials: int, consts: build.GlueConsts):
    """K6's decide on the tensors' device (the plain version for CPU
    tensors): (deep (B,), skip (B,) the lanes not active, alpha (n_trials,
    B) the step length trip j gives lane b, go () whether any lane is
    active)."""
    B = s.J.shape[0]
    i32 = lambda name, shape=(B,): (getattr(s, name), torch.int32, shape)  # noqa: E731
    others = dict(done=(s.done, torch.bool, (B,)), it=i32("it"), max_iters=i32("max_iters", ()),
                  n_np=i32("n_np"), ls0=i32("ls0"))
    device, dtype = _check("decide", dict(J=s.J, dV1=dV1, dV2=dV2), dict(J=(B,), dV1=(B,), dV2=(B,)), others)
    if device.type == "cpu":
        return decide_plain(s, dV1, dV2, cfg, ladder, n_trials)
    deep, skip = (torch.empty((B,), dtype=torch.bool, device=device) for _ in range(2))
    alpha = torch.empty((n_trials, B), dtype=dtype, device=device)
    go = torch.empty((), dtype=torch.bool, device=device)
    _launch("decide", dtype, device, ctypes.byref(consts), B, s.J, dV1, dV2, s.done, s.it, s.max_iters, s.n_np,
            s.ls0, deep, skip, alpha, go)
    return deep, skip, alpha, go


# ------------------------------------------------------------------- commit
def commit_plain(s, KK_new, dV1, dV2, fail, pg, accepted, Z_ls, U_ls, J_ls, acc_idx, ls_trips, go,
                 cfg: SolverConfig):
    """Plain PyTorch version: the new state."""
    global plain_calls
    plain_calls += 1
    decrement = -(dV1 + dV2)
    scale = s.J.abs() + 1.0
    # `sane` guards every |J|-relative tolerance: at an exploded
    # rollout cost the gates would be trivially satisfied
    sane = torch.isfinite(s.J) & (s.J.abs() < 1e12)
    grad_small = pg <= cfg.gtol * scale
    stationary = (
        (decrement <= cfg.tol * scale) & (dV1 <= 0) & grad_small & ~fail & sane
    )
    active = ~s.done & (s.it < s.max_iters)
    improved = accepted & ~fail & ~stationary & active

    Z_n = torch.where(improved, Z_ls, s.Z)
    U_n = torch.where(improved, U_ls, s.U)
    KK = torch.where(improved | (stationary & active), KK_new, s.KK)
    J_n = torch.where(improved, J_ls, s.J)

    reg = s.reg
    reg_n = torch.where(
        active,
        torch.where(
            improved,
            torch.clamp_min(reg * cfg.reg_shrink, cfg.reg_min),
            torch.clamp_max(reg * cfg.reg_grow, cfg.reg_max * 2.0),
        ),
        reg,
    )
    grad_smallish = pg <= cfg.stall_gtol * scale
    stalled = (
        ~improved & ~stationary & (decrement <= cfg.tol * scale)
        & (reg >= 64.0) & grad_smallish & sane
    )
    # progress window: terminate when a whole window of iterations
    # made less than tol cumulative progress
    np_n = torch.where(active, torch.where(improved, 0, s.n_np + 1), s.n_np)
    w_n = s.w_it + active.to(s.w_it.dtype)
    if cfg.no_progress_iters > 0:
        window_full = w_n >= cfg.no_progress_iters
    else:
        window_full = torch.zeros_like(active)
    window_progress = (s.J_chk - J_n) > cfg.tol * (J_n.abs() + 1.0)
    floor_exit = window_full & ~window_progress & sane
    J_chk = torch.where(window_full & active, J_n, s.J_chk)
    w_it = torch.where(window_full & active, 0, w_n)
    blowout = ~improved & ~stationary & (reg > cfg.reg_max)
    done = s.done | (active & (stationary | stalled | floor_exit | blowout))
    # exit taxonomy; each reason implies done, so writing under `active` is exact
    st = s.st
    st = torch.where(active & stationary, 1, st)
    st = torch.where(active & ~stationary & stalled, 2, st)
    st = torch.where(active & ~stationary & ~stalled & floor_exit, 3, st)
    st = torch.where(active & ~stationary & ~stalled & ~floor_exit & blowout, 4, st)
    it = s.it + active.to(s.it.dtype)
    ls0 = s.ls0
    if cfg.ls_adaptive:
        ls0 = torch.where(improved & active, torch.clamp_min(acc_idx - 1, 0), ls0)
    new = s._make((Z_n, U_n, J_n, KK, reg_n, done, it, pg, s.ls_n + ls_trips, ls0, np_n,
                   J_chk, w_it, st, s.max_iters))
    # past the loop's exit an iteration would still rewrite pg (every
    # lane's) and ls_evals: `go` makes it a no-op
    return s._make(torch.where(go, a, b) for a, b in zip(new, s))


def commit(s, KK_new, dV1, dV2, fail, pg, accepted, Z_ls, U_ls, J_ls, acc_idx, ls_trips, go, cfg: SolverConfig,
           consts: build.GlueConsts, count=None):
    """K6's commit on the tensors' device (the plain version for CPU
    tensors): the new state, each field gated by `go` (0-dim bool: with
    go False the state comes back unchanged).  count (int32 (2,) on the
    device, or None): the kernel adds [1, the active lanes] where go
    holds.  The kernel's state keeps `s.max_iters`, which no iteration
    changes."""
    H, B = s.U.shape[0], s.J.shape[0]
    floats = dict(Z=s.Z, U=s.U, J=s.J, KK=s.KK, reg=s.reg, pg_old=s.pg, J_chk=s.J_chk, KK_new=KK_new,
                  dV1=dV1, dV2=dV2, pg=pg, Z_ls=Z_ls, U_ls=U_ls, J_ls=J_ls)
    lanes = ("J", "reg", "pg_old", "J_chk", "dV1", "dV2", "pg", "J_ls")
    shapes = dict(Z=(H + 1, NZ, B), U=(H, NU, B), KK=(H, NU, NZ, B), KK_new=(H, NU, NZ, B),
                  Z_ls=(H + 1, NZ, B), U_ls=(H, NU, B), **{n: (B,) for n in lanes})
    ints = dict(it=s.it, ls_n=s.ls_n, ls0=s.ls0, n_np=s.n_np, w_it=s.w_it, st=s.st, max_iters=s.max_iters,
                acc_idx=acc_idx, ls_trips=ls_trips)
    others = {n: (t, torch.int32, () if n in ("ls_n", "max_iters", "ls_trips") else (B,)) for n, t in ints.items()}
    others.update(done=(s.done, torch.bool, (B,)), fail=(fail, torch.bool, (B,)),
                  accepted=(accepted, torch.bool, (B,)), go=(go, torch.bool, ()))
    device, dtype = _check("commit", floats, shapes, others)
    if device.type == "cpu":
        return commit_plain(s, KK_new, dV1, dV2, fail, pg, accepted, Z_ls, U_ls, J_ls, acc_idx, ls_trips, go, cfg)
    if count is not None and (count.dtype != torch.int32 or count.shape != (2,) or count.device != device):
        raise ValueError(f"commit: count must be an int32 (2,) tensor on {device}")
    new = [torch.empty_like(t) for t in (s.Z, s.U, s.J, s.KK, s.reg, s.done, s.it, s.pg, s.ls_n, s.ls0,
                                         s.n_np, s.J_chk, s.w_it, s.st)]
    _launch("commit", dtype, device, ctypes.byref(consts), H, B, go, *s[:-1], s.max_iters, KK_new, dV1, dV2,
            fail, pg, accepted, Z_ls, U_ls, J_ls, acc_idx, ls_trips, *new, count)
    return s._make((*new, s.max_iters))
