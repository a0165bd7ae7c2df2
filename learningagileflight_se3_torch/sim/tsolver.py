"""Traversal-time fixed point over DNN2.

Port of `learningagileflight_se3_tpu/sim/tsolver.py`.  t2 = DNN2(window
inputs at the gate pose predicted t1 seconds ahead)[6]; iterate until
|t2 - t1| <= tol.  Each `while_loop` of the JAX version is a Python loop
here, whose test is one host sync per iteration.
"""

from __future__ import annotations

import torch

from learningagileflight_se3_torch.geometry.gate import rotate_y, translate, window_inputs


def make_traversal_time_solver(model2, tol: float = 1e-3, max_iters: int = 100,
                               accel: str = "reference"):
    """solver(state, final_point, gate_pts, velo, w) -> t (0-d tensor).

    accel:
      * "reference": the averaging update t1 <- t1 + (t2 - t1)/2;
      * "secant": guarded secant iteration on g(t) = DNN2_t(t) - t with a
        fall-back to the averaging step and t clamped to [-20, 20] s."""

    def predict_t(state, final_point, gate_pts, velo, t1, w):
        pts = rotate_y(translate(gate_pts, velo * t1), w * t1)
        return model2(window_inputs(pts, state, final_point))[6]

    def t_guess(state, gate_pts):
        return torch.linalg.vector_norm(gate_pts.mean(dim=0) - state[0:3]) / 3.0

    def solve_reference(state, final_point, gate_pts, velo, w):
        t1 = t_guess(state, gate_pts)
        t2 = predict_t(state, final_point, gate_pts, velo, t1, w)
        it = 0
        while it < max_iters and bool(torch.abs(t2 - t1) > tol):
            t1 = t1 + (t2 - t1) / 2.0
            t2 = predict_t(state, final_point, gate_pts, velo, t1, w)
            it += 1
        return t1

    def solve_secant(state, final_point, gate_pts, velo, w):
        def g(t):
            return predict_t(state, final_point, gate_pts, velo, t, w) - t

        t0 = t_guess(state, gate_pts)
        g0 = g(t0)
        t1 = t0 + g0 / 2.0  # one averaging step seeds the secant pair
        g1 = g(t1)
        it = 0
        while it < max_iters and bool(torch.abs(g1) > tol):
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
            t0, g0, t1, g1 = t1, g1, tn, gn
            it += 1
        return t1

    if accel == "secant":
        return solve_secant
    if accel != "reference":
        raise ValueError(f"unknown accel: {accel!r}")
    return solve_reference
