"""Small box-constrained QP (projected Newton, fixed iteration count),
batched over TRAILING dims.

Port of `learningagileflight_se3_tpu/solver/boxqp.py` in the lane layout of
`ops/riccati_pallas.py` `_boxqp_lanes`:

    min_d  0.5 d^T H d + g^T d   s.t.  lo <= d <= hi

with H (4,4,...), g / lo / hi (4,...).  The plain version of the `boxqp`
device function in `csrc/lane_algebra.cuh`.
"""

from __future__ import annotations

import torch

from learningagileflight_se3_torch.solver.chol4 import chol4_factor, chol4_solve_factored


def mat_vec(H, x):
    """H (n,m,...) @ x (m,...) -> (n,...), accumulated in column order."""
    acc = H[:, 0] * x[0]
    for r in range(1, x.shape[0]):
        acc = acc + H[:, r] * x[r]
    return acc


def clip(x, lo, hi):
    """jnp.clip semantics: NaN in x, lo or hi propagates."""
    return torch.minimum(torch.maximum(x, lo), hi)


def masked_matrix(H, free):
    """F H F + (I - F) with free (4,...): exact on the free block, identity
    on the clamped coordinates."""
    M = H * (free[:, None] * free[None, :])
    eye = torch.eye(4, dtype=H.dtype, device=H.device).reshape((4, 4) + (1,) * (H.dim() - 2))
    return M + eye * (1.0 - free)[None, :]


def _free_mask(d, grad, lo, hi):
    at_lo = (d <= lo + 1e-12) & (grad > 0)
    at_hi = (d >= hi - 1e-12) & (grad < 0)
    return 1.0 - (at_lo | at_hi).to(d.dtype)


def boxqp(H, g, lo, hi, iters: int = 6):
    """Returns (d, free): free marks coordinates not clamped at a bound with
    an inward gradient; callers zero those feedback rows."""
    d = clip(torch.zeros_like(g), lo, hi)
    # the current iterate and its three step lengths are evaluated together
    scales = torch.tensor([1.0, 0.5, 0.25], dtype=g.dtype, device=g.device)
    scales = scales.reshape((3, 1) + (1,) * (g.dim() - 1))
    Hc = H[:, :, None]

    for _ in range(iters):
        grad = g + mat_vec(H, d)
        free = _free_mask(d, grad, lo, hi)
        L, _ = chol4_factor(masked_matrix(H, free))
        step = chol4_solve_factored(L, -(grad * free)) * free

        steps = clip(d + scales * step, lo, hi).transpose(0, 1)
        cands = torch.cat([d[:, None], steps], dim=1)  # (4, 4 candidates, ...)
        vals = 0.5 * torch.sum(cands * mat_vec(Hc, cands), dim=0) + torch.sum(g[:, None] * cands, dim=0)
        # NaN-robust sequential selection: an overflowed candidate loses
        best, best_val = d, vals[0]
        for s in range(1, 4):
            take = vals[s] < best_val
            best = torch.where(take[None], cands[:, s], best)
            best_val = torch.where(take, vals[s], best_val)
        d = best

    grad = g + mat_vec(H, d)
    return d, _free_mask(d, grad, lo, hi)
