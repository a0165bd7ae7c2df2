"""What decides `correct` for flights whose planner is fed the gate filter's
estimate of the gate's motion: flight_check.py's numbers, with the filter
judged and DNN2's inputs built from what the planner was fed.

  kalman_gap    the widest |fed - ref| / (1 + |ref|) over lanes, steps and
                components, fed the logged [v(3), pitch rate] the planner
                used and ref the plain filter's (kalman.py, float64) run on
                the reference's own observations: its own gate trajectory
                from the scenarios and the gate noise, plus the flight's
                corner noise, the filter started from the unnoised first
                pose;
  plant_gap, fail_share, control_excess
                as in flight_check.py (computed here: flight_check's
                numbers() would also run DNN2 on the true velocity,
                which this flight's planner never used);
  dnn2_gap, t_resid_p50
                as in flight_check.py, but the gate pose is predicted from
                the logged [v, pitch rate] (the planner's input, which
                kalman_gap holds to the reference).  Where the predicted
                gate stands edge-on, its pitch input atan((p0z - p1z) /
                (p0x - p1x)) jumps by pi, and float32 and float64 may fall on
                opposite sides: a row whose |p0x - p1x| over its rate in t,
                |pitch rate| |p0z - p1z|, is under EDGE_S is judged on both
                sides of the jump, and the nearer side counts.

With `control`, the filter judged is the plain filter in TF32 (plain.py's
`Arith("tf32")`) on the same observations, and the plant's and DNN2's
answers are flight_check.py's control's.
"""

from __future__ import annotations

import math

import torch

from flightbench.reference import flight_check, kalman, plain
from flightbench.yardstick import percentile

EDGE_S = 1e-5  # s: float32's rounding of the logged t and the inputs, and then some


def edge_on(pts, w):
    """Rows (...) whose gate corners (..., 4, 3), turning at w (...) rad/s,
    stand within EDGE_S of edge-on."""
    dx = pts[..., 0, 0] - pts[..., 1, 0]
    dz = pts[..., 0, 2] - pts[..., 1, 2]
    return dx.abs() < EDGE_S * (w * dz).abs()


class KalmanJudge(flight_check.FlightJudge):
    """flight_check's judge (its DNN2s and constants) with the filter of the
    configuration's `estimator`; its own `numbers`, which build DNN2's
    inputs from the logged estimate in place of the true velocity."""

    def __init__(self, config: dict, cell: dict, device, control: bool = False):
        super().__init__(config, cell, device, control)
        dt = cell["sim"]["plant_dt"]
        est = config["estimator"]
        self.filter = kalman.Filter(est, dt, self.f64, self.device)
        self.filter_tf32 = kalman.Filter(est, dt, self.tf32, self.device) if control else None

    def numbers(self, scen, noise, obs_noise, log: dict) -> dict:
        """The six numbers of one flight; `log` holds flight_check's fields
        and gate_vel_used (B, N, 4); obs_noise (B, N, 4, 3) is the corner
        noise the flight was given."""
        sim, motion, quad = self.cell["sim"], self.config["gate_motion"], self.config["quad"]
        dt, every = sim["plant_dt"], sim["control_every"]
        f64, dev = self.f64, self.device
        X = f64.t(log["states"]).to(dev)
        U = log["controls"].to(dev)
        hl = f64.t(log["hl"]).to(dev)
        t = f64.t(log["tra_times"]).to(dev)
        fed = f64.t(log["gate_vel_used"]).to(dev)
        moves_prog = f64.t(log["gate_moves"]).to(dev)
        scen, noise, obs_noise = (f64.t(a).to(dev) for a in (scen, noise, obs_noise))
        N = t.shape[1]
        final = scen[:, 3:6]
        out = {}

        with torch.no_grad():
            # the plant, as flight_check's: every step from the logged state under the logged control, and the start
            rows_ok = torch.isfinite(X[:, :-1]).all(dim=-1) & torch.isfinite(U[:, 1:]).all(dim=-1)
            x_next = plain.euler_renorm(X[:, :-1], f64.t(U[:, 1:]), dt, quad, f64)
            x_ans = X[:, 1:]
            if self.control:
                x_ans = plain.euler_renorm(self.tf32.t(X[:, :-1]), self.tf32.t(U[:, 1:]), dt, quad,
                                           self.tf32).double()
            yaw, z = scen[:, 6], torch.zeros_like(scen[:, :3])
            x0 = torch.cat([scen[:, 0:3], z, torch.cos(yaw / 2)[:, None], z[:, :2], torch.sin(yaw / 2)[:, None], z], 1)
            out["plant_gap"] = max(flight_check._widest(x_ans, x_next, rows_ok),
                                   flight_check._widest(X[:, 0], x0, torch.ones_like(yaw, dtype=torch.bool)))

            # the filter on the reference's own observations
            pts0 = plain.gate_from_width(scen[:, 7], scen[:, 8], self.config["sampler"]["gate_half_height"])
            moves, _ = plain.gate_moves(pts0, motion["velocity"], motion["omega_y"], noise, dt)
            y0, ys = kalman.observe(moves[:, 0]), kalman.observe(moves[:, :N] + obs_noise[:, :N])
            ref, _ = self.filter.track(y0, ys)
            ans = fed
            if self.control:
                ans = self.filter_tf32.track(self.tf32.t(y0), self.tf32.t(ys))[0].double()
            every_row = torch.ones(ref.shape[:2], dtype=torch.bool, device=dev)
            out["kalman_gap"] = flight_check._widest(ans, ref, every_row)

            # DNN2 at the gate pose predicted from what the planner was fed, both sides of an edge-on jump
            v, w = fed[..., 0:3], fed[..., 3]
            pts_f = plain.rotate_y(moves_prog[:, :N] + (t[..., None] * v)[..., None, :], t * w)
            inp = plain.window_inputs(pts_f, X[:, :N], final[:, None, :].expand(-1, N, 3), f64)
            other = inp.clone()
            other[..., 17] -= math.pi * torch.sign(inp[..., 17])
            edge = edge_on(pts_f, w)
            ok = torch.isfinite(inp).all(dim=-1) & torch.isfinite(t)
            pred, pred_other = self.dnn2(inp), self.dnn2(other)
            rep = torch.arange(0, N, every, device=dev)
            got = hl[:, rep + 1]
            if self.control:
                got = self.dnn2_tf32(inp[:, rep]).double()
            near = plain.rel_gap(got, pred_other[:, rep]).amax(-1) < plain.rel_gap(got, pred[:, rep]).amax(-1)
            ref_out = torch.where((edge[:, rep] & near)[..., None], pred_other[:, rep], pred[:, rep])
            out["dnn2_gap"] = flight_check._widest(got, ref_out, ok[:, rep])
            resid = (pred[..., 6] - t).abs()
            resid = torch.where(edge, torch.minimum(resid, (pred_other[..., 6] - t).abs()), resid)
            out["t_resid_p50"] = percentile(resid[ok].tolist(), 50)

            # the scorecard on the reference's own gate trajectory, and the controls' bounds, as flight_check's
            traversed, diverged = plain.scorecard(X, moves, final)
        out["fail_share"] = float((~traversed | diverged).double().mean())
        lb = torch.tensor(self.config["bounds"]["u_lb"], dtype=U.dtype, device=dev)
        ub = torch.tensor(self.config["bounds"]["u_ub"], dtype=U.dtype, device=dev)
        excess = torch.maximum(U[:, 1:] - ub, lb - U[:, 1:]).clamp_min(0.0)
        out["control_excess"] = float(excess.nan_to_num(0.0).max())
        return out


def numbers(config: dict, cell: dict, flights: list, device, control: bool = False) -> dict:
    """The worst of each number over the judged flights [(scen, noise,
    obs_noise, log)] (with `control`, the TF32 reference's readings at the
    same rows)."""
    judge = KalmanJudge(config, cell, device, control)
    out = {}
    for scen, noise, obs_noise, log in flights:
        for k, v in judge.numbers(scen, noise, obs_noise, log).items():
            out[k] = max(out.get(k, 0.0), v)
    return out
