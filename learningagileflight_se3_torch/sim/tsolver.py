"""Traversal-time fixed point over DNN2.

Port of `learningagileflight_se3_tpu/sim/tsolver.py`.  t2 = DNN2(window
inputs at the gate pose predicted t1 seconds ahead)[6]; iterate until
|t2 - t1| <= tol.  Every argument may carry leading batch dimensions (one
fixed point per lane; the tick passes none).

Each `while_loop` of the JAX version is a pure iteration on a carry,
(t1, t2, live, it) for "reference" and (t0, g0, t1, g1, live, it) for
"secant", driven by utils/graphs.py `while_blocks`: the loop runs while any
lane is live and the batch's count `it` is under `max_iters`, and every
update is gated by that test and by the lane's own `live`, so a lane that
has converged keeps its t bit for bit, as under `jax.vmap`, an iteration
past the exit changes nothing, and a lane whose state is not finite drops
out of the test at once.  A batch's fixed point is held to its slowest
lane: in chip_smoke.py's phase 19 on an H100 each of the first 50 steps of
seed 2024's flight (B=128, tol 1e-3) ran to the cap of 100 iterations,
while the replay contract's ticks (B=1, tol 1e-2) take 8 ("reference") or
2 ("secant").  On the card the whole fixed point (the guess, the seed evaluations
and ceil(max_iters / TSOLVE_BLOCK) conditional blocks) is one CUDA graph
per shape, replayed with no host read; inside a capture that is open (the
tick's, a flight step's) the blocks join it.  CPU tensors take the eager
loop, a host read per iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from learningagileflight_se3_torch.geometry.gate import rotate_y, translate, window_inputs
from learningagileflight_se3_torch.utils import graphs
from learningagileflight_se3_torch.utils.profiling import spans

# Iterations per conditional block.  A fixed point that ends inside a block
# runs the rest of that block as gated no-ops, and each block costs the
# card one test and one node even when it is skipped.  The flight's fixed
# points run to the cap, where the block size only sets the number of nodes
# (25); the tick's end within two blocks, at most 3 no-op iterations.
TSOLVE_BLOCK = 4


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
    device, adds [conditional blocks run, iterations] of every solve (set
    it before the first solve of a shape on the card: a graph adds to the
    tensor it was captured with)."""

    def __init__(self, model2, tol: float, max_iters: int, accel: str):
        if accel not in ("reference", "secant"):
            raise ValueError(f"unknown accel: {accel!r}")
        self.model2, self.tol, self.max_iters, self.accel = model2, tol, max_iters, accel
        self.n_blocks = -(-max_iters // TSOLVE_BLOCK)
        self.count = None
        self.captures = graphs.Captures()
        self._graphs = {}

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
    def run(self, state, final_point, gate_pts, velo, w, drive: str):
        """The fixed point under `drive` ("eager", "blocks" or "chain"); w
        as a tensor of t's shape."""
        carry, body = self.loop(state, final_point, gate_pts, velo, w)
        return graphs.while_blocks(carry, self.pred, body, TSOLVE_BLOCK, self.n_blocks, drive, self.count).t1

    def _args(self, state, final_point, gate_pts, velo, w):
        """The arguments with w as a tensor of t's shape (a number is filled
        on the device: no host copy, so a capture can hold it)."""
        shape, kw = state.shape[:-1], dict(dtype=state.dtype, device=state.device)
        w = w.to(**kw).expand(shape) if torch.is_tensor(w) else torch.full(shape, float(w), **kw)
        return state, final_point, gate_pts, velo, w

    def _key(self, args):
        """A captured fixed point's key: the arguments' shapes, dtype and
        device, where DNN2's parameters lie now (values written in place
        are seen; parameters that moved get a new graph) and the spans'
        state (utils/profiling.py: a graph captured with spans on is never
        replayed with them off, nor the other way)."""
        return (tuple(a.shape for a in args) + (args[0].dtype, args[0].device, spans.on)
                + tuple(p.data_ptr() for p in self.model2.parameters()))

    def _graph(self, args):
        """The captured fixed point for arguments of this `_key`."""
        key = self._key(args)
        if key not in self._graphs:
            static = [a.clone() for a in args]
            self._graphs[key] = static, self.captures.capture(
                lambda: self.run(*static, drive="chain"), warmup=lambda: self.run(*static, drive="blocks"))
        return self._graphs[key]

    def __call__(self, state, final_point, gate_pts, velo, w, drive=None):
        """t (...); `drive` as `run`'s, or None: "eager" on the CPU, "chain"
        inside an open capture, else the replay of this shape's graph (the
        arguments copied in, t cloned out), under solver/watch.py's watchers
        too: the fixed point launches none of the kernels they watch."""
        args = self._args(state, final_point, gate_pts, velo, w)
        drive = drive or graphs.drive(state.device, watched=False)  # it launches no K1 / K2
        if drive != "graph":
            return self.run(*args, drive=drive)
        static, g = self._graph(args)
        for dst, src in zip(static, args):
            dst.copy_(src)
        g.replay()
        return g.out.clone()

    def prepare(self, state, final_point, gate_pts, velo, w):
        """Capture the graph for arguments of these shapes, dtype and device
        now, so that the first solve does not pay for it (nothing to do for
        CPU tensors)."""
        if graphs.drive(state.device, watched=False) == "graph":
            self._graph(self._args(state, final_point, gate_pts, velo, w))


def make_traversal_time_solver(model2, tol: float = 1e-3, max_iters: int = 100,
                               accel: str = "reference") -> TraversalTimeSolver:
    """The fixed point's solver (`TraversalTimeSolver`).  accel:

      * "reference": the averaging update t1 <- t1 + (t2 - t1)/2;
      * "secant": guarded secant iteration on g(t) = DNN2_t(t) - t with a
        fall-back to the averaging step and t clamped to [-20, 20] s."""
    return TraversalTimeSolver(model2, tol, max_iters, accel)
