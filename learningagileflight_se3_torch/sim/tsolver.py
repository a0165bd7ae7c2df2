"""Traversal-time fixed point over DNN2.

Port of `learningagileflight_se3_tpu/sim/tsolver.py`.  t2 = DNN2(window
inputs at the gate pose predicted t1 seconds ahead)[6]; iterate until
|t2 - t1| <= tol.  Every argument may carry leading batch dimensions (one
fixed point per lane; the tick passes none).  Each `while_loop` of the JAX
version is a Python loop here that runs while any lane is over `tol` (its
test is one host sync per iteration) and updates only the lanes that are:
a lane that has converged keeps its t bit for bit, as under `jax.vmap`, and
a lane whose state is not finite drops out of the test at once.

One DNN2 evaluation at a predicted gate pose is about 170 small device
operations, and a batch's fixed point is held to its slowest lane (often
the cap of 100 evaluations), so on the card the host's launches set a
closed-loop step's time.  So for CUDA tensors the evaluation (gate pose,
window inputs, DNN2) is captured once per shape as a CUDA graph over static
buffers and replayed per iteration: the same operations on the same values,
one launch.  CPU tensors run it eagerly.
"""

from __future__ import annotations

import torch

from learningagileflight_se3_torch.geometry.gate import rotate_y, translate, window_inputs


class _GraphedPredict:
    """`predict_t` captured as a CUDA graph over static copies of its
    arguments: `bind` copies a call's arguments in, `__call__(t)` replays the
    graph and returns a fresh copy of its output.  Captured and replayed
    without gradients, whatever the caller's grad mode."""

    @torch.no_grad()
    def __init__(self, predict_t, args, t):
        self.args = [a.clone() for a in args]
        self.t = t.clone()
        side = torch.cuda.Stream(device=t.device)
        side.wait_stream(torch.cuda.current_stream(t.device))
        with torch.cuda.stream(side):  # warm up off the capturing stream
            for _ in range(3):
                predict_t(*self.args, self.t)
        torch.cuda.current_stream(t.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = predict_t(*self.args, self.t)

    def bind(self, args):
        for mine, a in zip(self.args, args):
            mine.copy_(a)
        return self

    @torch.no_grad()
    def __call__(self, t):
        self.t.copy_(t)
        self.graph.replay()
        return self.out.clone()


def make_traversal_time_solver(model2, tol: float = 1e-3, max_iters: int = 100,
                               accel: str = "reference"):
    """solver(state (..., 13), final_point (..., 3), gate_pts (..., 4, 3),
    velo (..., 3), w: number or (...)) -> t (...).

    accel:
      * "reference": the averaging update t1 <- t1 + (t2 - t1)/2;
      * "secant": guarded secant iteration on g(t) = DNN2_t(t) - t with a
        fall-back to the averaging step and t clamped to [-20, 20] s.

    On CUDA tensors each DNN2 evaluation replays a CUDA graph captured at
    the first call of each shape, or before it by `solver.prepare(...)` with
    arguments of that shape.  A graph reads `model2`'s parameters where they
    lay at its capture, so the graphs are keyed on those addresses too: values
    written in place are seen, parameters that moved get a new graph."""
    graphs = {}

    def predict_t(state, final_point, gate_pts, velo, w, t1):
        pts = rotate_y(translate(gate_pts, velo * t1[..., None]), w * t1)
        return model2(window_inputs(pts, state, final_point))[..., 6]

    def t_guess(state, gate_pts):
        return torch.linalg.vector_norm(gate_pts.mean(dim=-2) - state[..., 0:3], dim=-1) / 3.0

    def predictor(state, final_point, gate_pts, velo, w, t):
        """t1 -> DNN2's time at the gate pose predicted t1 ahead, for this
        call's arguments (`t` gives the shape of a t1)."""
        if not state.is_cuda:
            return lambda t1: predict_t(state, final_point, gate_pts, velo, w, t1)
        args = (state, final_point, gate_pts, velo,
                torch.as_tensor(w, dtype=state.dtype, device=state.device).expand(t.shape))
        key = ((state.device, state.dtype) + tuple(a.shape for a in args)
               + tuple(p.data_ptr() for p in model2.parameters()))
        if key not in graphs:
            graphs[key] = _GraphedPredict(predict_t, args, t)
        return graphs[key].bind(args)

    def solve_reference(state, final_point, gate_pts, velo, w):
        t1 = t_guess(state, gate_pts)
        predict = predictor(state, final_point, gate_pts, velo, w, t1)
        t2 = predict(t1)
        live = torch.abs(t2 - t1) > tol
        it = 0
        while it < max_iters and bool(live.any()):
            t1 = torch.where(live, t1 + (t2 - t1) / 2.0, t1)
            t2 = torch.where(live, predict(t1), t2)
            live = live & (torch.abs(t2 - t1) > tol)
            it += 1
        return t1

    def solve_secant(state, final_point, gate_pts, velo, w):
        t0 = t_guess(state, gate_pts)
        predict = predictor(state, final_point, gate_pts, velo, w, t0)

        def g(t):
            return predict(t) - t

        g0 = g(t0)
        t1 = t0 + g0 / 2.0  # one averaging step seeds the secant pair
        g1 = g(t1)
        live = torch.abs(g1) > tol
        it = 0
        while it < max_iters and bool(live.any()):
            denom = g1 - g0
            sec = t1 - g1 * (t1 - t0) / denom
            ok = torch.isfinite(sec) & (torch.abs(denom) > 1e-8)
            fall = torch.clamp(t1 + g1 / 2.0, -20.0, 20.0)
            cand = torch.clamp(torch.where(ok, sec, fall), -20.0, 20.0)
            g_cand = g(cand)
            # guarded acceptance: keep the secant step only if it reduced |g|
            # (both candidates are evaluated, as in the JAX version)
            use = torch.abs(g_cand) < torch.abs(g1)
            tn = torch.where(use, cand, fall)
            gn = torch.where(use, g_cand, g(fall))
            t0, g0, t1, g1 = (torch.where(live, new, old) for new, old in
                              ((t1, t0), (g1, g0), (tn, t1), (gn, g1)))
            live = live & (torch.abs(g1) > tol)
            it += 1
        return t1

    def prepare(state, final_point, gate_pts, velo, w):
        """Capture the CUDA graph for arguments of these shapes, dtype and
        device now, so that the first solve does not pay for it (nothing to
        do for CPU tensors)."""
        predictor(state, final_point, gate_pts, velo, w, t_guess(state, gate_pts))

    if accel not in ("reference", "secant"):
        raise ValueError(f"unknown accel: {accel!r}")
    solve = solve_secant if accel == "secant" else solve_reference
    solve.prepare = prepare
    return solve
