"""Jacobians and Hessians of per-step functions, batched over the horizon,
by torch.autograd.

The oracles need the derivative blocks of every step of a trajectory at
every point their solvers visit: thousands of times per solve.  These
helpers compute the exact blocks with plain autograd on the step inputs
repeated once per output row (the vmap of a reverse-mode Jacobian written
out by hand): one backward pass for a Jacobian, a double backward for a
Hessian.  At H=50 that is 3.8 to 5.1 times faster than eager
`torch.func.vmap(jacfwd(...))` / `vmap(hessian(...))` of the same
functions, and agrees with them to rounding (`scripts/compare_oracles.py`).
The functions must be batched over leading dims, as the port's
`euler_step` and `stage_cost` are.
"""

from __future__ import annotations

import torch


def _basis(n: int, batch, like: torch.Tensor) -> torch.Tensor:
    """(n, *batch, n): row i is e_i at every batch index."""
    eye = torch.eye(n, dtype=like.dtype, device=like.device)
    return eye.reshape((n,) + (1,) * len(batch) + (n,)).expand((n, *batch, n))


def batched_jacobian(f, xs: torch.Tensor, n_out: int) -> torch.Tensor:
    """d f(x) / dx at each row of xs (..., n_in) -> (..., n_out, n_in),
    f mapping (..., n_in) -> (..., n_out) row by row."""
    rep = xs.detach().expand((n_out, *xs.shape)).clone().requires_grad_()
    (jac,) = torch.autograd.grad(f(rep), rep, grad_outputs=_basis(n_out, xs.shape[:-1], xs))
    return jac.movedim(0, -2)


def batched_hessian(f, xs: torch.Tensor) -> torch.Tensor:
    """The Hessian of the scalar f(x) at each row of xs (..., n) ->
    (..., n, n), f mapping (..., n) -> (...) row by row."""
    n = xs.shape[-1]
    rep = xs.detach().expand((n, *xs.shape)).clone().requires_grad_()
    (grad,) = torch.autograd.grad(f(rep).sum(), rep, create_graph=True)
    (hess,) = torch.autograd.grad(grad, rep, grad_outputs=_basis(n, xs.shape[:-1], xs))
    return hess.movedim(0, -2)
