"""Traversal-time fixed point over DNN2.

Port of `learningagileflight_se3_tpu/sim/tsolver.py`.  t2 = DNN2(window
inputs at the gate pose predicted t1 seconds ahead)[6]; iterate until
|t2 - t1| <= tol.  Every argument may carry leading batch dimensions (one
fixed point per lane; the tick passes none).

Each `while_loop` of the JAX version is a pure iteration on a carry,
(t1, t2, live, it) for "reference" and (t0, g0, t1, g1, live, it) for
"secant", run on the CPU as an eager loop, a host read of the test before
each iteration: the loop runs while any lane is live and the batch's count
`it` is under `max_iters`, and every update is gated by that test and by
the lane's own `live`, so a lane that has converged keeps its t bit for
bit, as under `jax.vmap`, and a lane whose state is not finite drops out
of the test at once.  A batch's fixed point is held to its slowest lane: the flight's
(B=128, tol 1e-3) run 75 to 87 iterations a step, the replay contract's
ticks (B=1, tol 1e-2) 8 ("reference") or 2 ("secant").

On the card the whole fixed point (the guess, the seed evaluations, every
iteration and the test) is one launch of K4 (ops/tsolve.py,
csrc/tsolve.cu), one block a lane that loops while its lane is live and
under the cap: the same result lane by lane, and the batch's count the
largest lane count.  It is a plain launch on the current stream, so the
tick's and a flight step's captures hold it as one node.  CPU tensors, and
the card where a caller names the "eager" drive, take the eager loop.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from learningagileflight_se3_torch.geometry.gate import rotate_y, translate, window_inputs
from learningagileflight_se3_torch.ops import tsolve
from learningagileflight_se3_torch.utils import graphs


class _Reference(NamedTuple):
    t1: torch.Tensor
    t2: torch.Tensor
    live: torch.Tensor
    it: torch.Tensor  # () int32


class _Secant(NamedTuple):
    t0: torch.Tensor
    g0: torch.Tensor
    t1: torch.Tensor
    g1: torch.Tensor
    live: torch.Tensor
    it: torch.Tensor  # () int32


class TraversalTimeSolver:
    """solver(state (..., 13), final_point (..., 3), gate_pts (..., 4, 3),
    velo (..., 3), w: number or (...)) -> t (...); see the module's
    docstring.  `count`, where set to an int32 (2,) tensor on the solves'
    device (a utils/profiling.py counter), adds [0, iterations] of every
    solve; `fused`, likewise, adds [1, the lanes' iterations summed] of
    every solve by K4.
    Set both before a capture that holds a solve: a graph adds to the
    tensors it was captured with."""

    def __init__(self, model2, tol: float, max_iters: int, accel: str):
        if accel not in ("reference", "secant"):
            raise ValueError(f"unknown accel: {accel!r}")
        self.model2, self.tol, self.max_iters, self.accel = model2, tol, max_iters, accel
        self.count = None
        self.fused = None
        self._scratch = None  # K4's int32 (2,) scratch for `count`, on the solves' device

    def _predict(self, state, final_point, gate_pts, velo, w, t1):
        pts = rotate_y(translate(gate_pts, velo * t1[..., None]), w * t1)
        return self.model2(window_inputs(pts, state, final_point))[..., 6]

    def pred(self, c):
        """The loop test on the device: a lane is live and the cap is not reached."""
        return c.live.any() & (c.it < self.max_iters)

    def loop(self, state, final_point, gate_pts, velo, w):
        """(the carry after the guess and the seed evaluations, the gated
        iteration body(carry, go)); w as a tensor of t's shape."""
        args = (state, final_point, gate_pts, velo, w)
        predict = lambda t: self._predict(*args, t)  # noqa: E731
        tol = self.tol
        t0 = torch.linalg.vector_norm(gate_pts.mean(dim=-2) - state[..., 0:3], dim=-1) / 3.0
        it = torch.zeros((), dtype=torch.int32, device=t0.device)
        if self.accel == "reference":
            t2 = predict(t0)

            def body(c, go):
                on = c.live & go
                t1 = torch.where(on, c.t1 + (c.t2 - c.t1) / 2.0, c.t1)
                t2 = torch.where(on, predict(t1), c.t2)
                live = torch.where(go, c.live & (torch.abs(t2 - t1) > tol), c.live)
                return _Reference(t1, t2, live, c.it + go.to(c.it.dtype))

            carry = _Reference(t0, t2, torch.abs(t2 - t0) > tol, it)
        else:
            g = lambda t: predict(t) - t  # noqa: E731
            g0 = g(t0)
            t1 = t0 + g0 / 2.0  # one averaging step seeds the secant pair
            g1 = g(t1)

            def body(c, go):
                denom = c.g1 - c.g0
                sec = c.t1 - c.g1 * (c.t1 - c.t0) / denom
                ok = torch.isfinite(sec) & (torch.abs(denom) > 1e-8)
                fall = torch.clamp(c.t1 + c.g1 / 2.0, -20.0, 20.0)
                cand = torch.clamp(torch.where(ok, sec, fall), -20.0, 20.0)
                g_cand = g(cand)
                # guarded acceptance: keep the secant step only if it reduced
                # |g| (both candidates are evaluated, as in the JAX version)
                use = torch.abs(g_cand) < torch.abs(c.g1)
                tn = torch.where(use, cand, fall)
                gn = torch.where(use, g_cand, g(fall))
                on = c.live & go
                t0n, g0n, t1n, g1n = (torch.where(on, new, old) for new, old in
                                      ((c.t1, c.t0), (c.g1, c.g0), (tn, c.t1), (gn, c.g1)))
                live = torch.where(go, c.live & (torch.abs(g1n) > tol), c.live)
                return _Secant(t0n, g0n, t1n, g1n, live, c.it + go.to(c.it.dtype))

            carry = _Secant(t0, g0, t1, g1, torch.abs(g1) > tol, it)
        return carry, body

    @torch.no_grad()
    def run(self, state, final_point, gate_pts, velo, w):
        """The eager loop's final carry; w as a tensor of t's shape."""
        carry, body = self.loop(state, final_point, gate_pts, velo, w)
        while graphs.read(go := self.pred(carry)):
            carry = body(carry, go)
            if self.count is not None:
                self.count[1].add_(1)
        return carry

    def _args(self, state, final_point, gate_pts, velo, w):
        """The arguments with w as a tensor of t's shape (a number is filled
        on the device: no host copy, so a capture can hold it)."""
        shape, kw = state.shape[:-1], dict(dtype=state.dtype, device=state.device)
        w = w.to(**kw).expand(shape) if torch.is_tensor(w) else torch.full(shape, float(w), **kw)
        return state, final_point, gate_pts, velo, w

    def kernel_args(self, state, final_point, gate_pts, velo, w):
        """K4's tensors for a call's arguments: the lanes' state, goal,
        corners, velocity and pitch rate (a number filled in) as (B, ...),
        contiguous, in the dtype DNN2's layers compute in, then DNN2's
        parameters in it."""
        state, final_point, gate_pts, velo, w = self._args(state, final_point, gate_pts, velo, w)
        shape = state.shape[:-1]
        dtype = torch.promote_types(state.dtype, next(self.model2.parameters()).dtype)
        flat = lambda a, *tail: a.to(dtype).expand(shape + tail).reshape(-1, *tail).contiguous()  # noqa: E731
        return ([flat(state, 13), flat(final_point, 3), flat(gate_pts, 4, 3), flat(velo, 3), flat(w)]
                + tsolve.dnn2_params(self.model2, dtype))

    def _fused(self, state, final_point, gate_pts, velo, w):
        """t (...) from K4."""
        args = self.kernel_args(state, final_point, gate_pts, velo, w)
        if self.count is not None and self._scratch is None:
            self._scratch = torch.zeros(2, dtype=torch.int32, device=state.device)
        t = tsolve.traversal_time(*args[:5], args[5:], self.tol, self.max_iters, self.accel == "secant",
                                  self.count, self.fused, self._scratch)
        return t.reshape(state.shape[:-1])

    def __call__(self, state, final_point, gate_pts, velo, w, drive=None):
        """t (...); `drive` is the caller's (utils/graphs.py `drive`): on the
        card every drive but "eager" launches K4, and the CPU takes the
        eager loop whatever the drive."""
        if state.device.type == "cuda" and drive != "eager":
            return self._fused(state, final_point, gate_pts, velo, w)
        return self.run(*self._args(state, final_point, gate_pts, velo, w)).t1


def make_traversal_time_solver(model2, tol: float = 1e-3, max_iters: int = 100,
                               accel: str = "reference") -> TraversalTimeSolver:
    """The fixed point's solver (`TraversalTimeSolver`).  accel:

      * "reference": the averaging update t1 <- t1 + (t2 - t1)/2;
      * "secant": guarded secant iteration on g(t) = DNN2_t(t) - t with a
        fall-back to the averaging step and t clamped to [-20, 20] s."""
    return TraversalTimeSolver(model2, tol, max_iters, accel)
