"""Closed-form 4x4 Cholesky factor / solve, batched over TRAILING dims.

Port of `learningagileflight_se3_tpu/solver/chol4.py` in the lane layout of
the kernels (`ops/riccati_pallas.py` `_chol4`, `_chol4_solve`): a matrix is
(4, 4, ...), a right-hand side (4, ...) or (4, n, ...).  This is the plain
version of the `chol4` / `chol4_solve` device functions in
`csrc/lane_algebra.cuh`.
"""

from __future__ import annotations

import torch

EPS = 1e-30


def chol4_factor(M):
    """M (4,4,...) SPD -> (L, ok): L is the tuple of the 10 lower entries
    (l00, l10, l20, l30, l11, l21, l31, l22, l32, l33), each (...);
    ok (...) is True where every pivot clears tol * max(|diag|, 1)."""
    d0 = M[0, 0]
    l00 = torch.sqrt(torch.clamp_min(d0, EPS))
    l10 = M[1, 0] / l00
    l20 = M[2, 0] / l00
    l30 = M[3, 0] / l00
    d1 = M[1, 1] - l10 * l10
    l11 = torch.sqrt(torch.clamp_min(d1, EPS))
    l21 = (M[2, 1] - l20 * l10) / l11
    l31 = (M[3, 1] - l30 * l10) / l11
    d2 = M[2, 2] - l20 * l20 - l21 * l21
    l22 = torch.sqrt(torch.clamp_min(d2, EPS))
    l32 = (M[3, 2] - l30 * l20 - l31 * l21) / l22
    d3 = M[3, 3] - l30 * l30 - l31 * l31 - l32 * l32
    l33 = torch.sqrt(torch.clamp_min(d3, EPS))
    tol = 1e-12 if M.dtype == torch.float64 else 1e-7
    scale = torch.clamp_min(
        torch.maximum(
            torch.maximum(M[0, 0].abs(), M[1, 1].abs()),
            torch.maximum(M[2, 2].abs(), M[3, 3].abs()),
        ),
        1.0,
    )
    ts = tol * scale
    ok = (d0 > ts) & (d1 > ts) & (d2 > ts) & (d3 > ts)
    return (l00, l10, l20, l30, l11, l21, l31, l22, l32, l33), ok


def chol4_solve_factored(L, B):
    """Solve (L L^T) X = B for B (4, ...) by forward / back substitution.
    L (from chol4_factor) broadcasts against B[i]."""
    l00, l10, l20, l30, l11, l21, l31, l22, l32, l33 = L
    y0 = B[0] / l00
    y1 = (B[1] - l10 * y0) / l11
    y2 = (B[2] - l20 * y0 - l21 * y1) / l22
    y3 = (B[3] - l30 * y0 - l31 * y1 - l32 * y2) / l33
    x3 = y3 / l33
    x2 = (y2 - l32 * x3) / l22
    x1 = (y1 - l21 * x2 - l31 * x3) / l11
    x0 = (y0 - l10 * x1 - l20 * x2 - l30 * x3) / l00
    return torch.stack([x0, x1, x2, x3])


def chol4_solve(M, B):
    """One-shot solve; returns (X, ok)."""
    L, ok = chol4_factor(M)
    return chol4_solve_factored(L, B), ok
