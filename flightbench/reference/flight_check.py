"""What decides `correct` for closed-loop flights: the flight log (states,
controls, DNN2's outputs, traversal times) held to what it says, by the
plain reference in float64, on the scenarios and gate noise the benchmark
made.

  plant_gap     the widest |x_{i+1} - plant(x_i, u_i)| / (1 + |x_{i+1}|) over
                lanes, steps and components: each logged state is the 100 Hz
                plant's step (Euler, quaternion renormalised) from the one
                before under the logged control, and the first is the
                scenario's start (the check follows the flight from its own
                logged states, so the start is checked by itself);
  dnn2_gap      the widest |out - DNN2(window inputs)| / (1 + |DNN2|) at the
                replans: the logged DNN2 output is the network's at the gate
                pose predicted the logged t ahead, from the logged state;
  t_resid_p50   the median over lanes and steps of |DNN2_t(t) - t|: the
                traversal time is the fixed point it says;
  fail_share    the share of lanes that did not traverse the gate or
                diverged, scored on the reference's own gate trajectory;
  control_excess  the largest step of a control past its bound, in the
                controls' own precision (an exact comparison).

Rows that are not finite on both sides are left out of the gaps; a finite
row whose next state or output is not finite counts as an infinite gap.
"""

from __future__ import annotations

import os

import torch

from flightbench.reference import plain
from flightbench.reference.plain import Arith
from flightbench.yardstick import percentile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _widest(answer, ref, rows_ok):
    """The widest relative gap of `answer` from `ref` over rows whose inputs
    were finite (rows_ok): inf where such a row's answer is not finite while
    the reference's is (and within float32's range)."""
    gap = plain.rel_gap(answer, ref).amax(dim=-1)
    both = torch.isfinite(answer).all(dim=-1) & torch.isfinite(ref).all(dim=-1)
    lost = ~torch.isfinite(answer).all(dim=-1) & torch.isfinite(ref).all(dim=-1) & (ref.abs().amax(dim=-1) < 1e30)
    gap = torch.where(rows_ok & both, gap, torch.zeros_like(gap))
    gap = torch.where(rows_ok & lost, torch.full_like(gap, float("inf")), gap)
    return float(gap.max()) if gap.numel() else 0.0


class FlightJudge:
    """The reference's pieces for one configuration and cell: DNN2 from the
    configuration's weights file and the flight's constants."""

    def __init__(self, config: dict, cell: dict, device, control: bool = False):
        self.config, self.cell, self.device = config, cell, torch.device(device)
        self.control = control
        path = os.path.join(ROOT, config["dnn2_weights"])
        self.f64, self.tf32 = Arith("f64"), Arith("tf32")
        self.dnn2 = plain.MLP(path, self.f64, self.device)
        self.dnn2_tf32 = plain.MLP(path, self.tf32, self.device) if control else None

    def numbers(self, scen, noise, log: dict) -> dict:
        """The five numbers of one flight; `log` holds the host tensors
        states (B, N+1, 13), controls (B, N+1, 4), hl (B, N+1, 7),
        tra_times (B, N), gate_moves (B, N+1, 4, 3).  With `control`, the
        plant's next states and DNN2's outputs judged are the TF32
        reference's at the same rows, not the log's."""
        sim, motion, quad = self.cell["sim"], self.config["gate_motion"], self.config["quad"]
        dt, every = sim["plant_dt"], sim["control_every"]
        f64, dev = self.f64, self.device
        X = f64.t(log["states"]).to(dev)
        U = log["controls"].to(dev)
        hl = f64.t(log["hl"]).to(dev)
        t = f64.t(log["tra_times"]).to(dev)
        moves_prog = f64.t(log["gate_moves"]).to(dev)
        scen = f64.t(scen).to(dev)
        noise = f64.t(noise).to(dev)
        N = t.shape[1]
        final, w = scen[:, 3:6], motion["omega_y"]

        with torch.no_grad():
            # the plant: every step from the logged state under the logged control
            rows_ok = torch.isfinite(X[:, :-1]).all(dim=-1) & torch.isfinite(U[:, 1:]).all(dim=-1)
            x_next = plain.euler_renorm(X[:, :-1], f64.t(U[:, 1:]), dt, quad, f64)
            x_ans = X[:, 1:]
            if self.control:
                x_ans = plain.euler_renorm(self.tf32.t(X[:, :-1]), self.tf32.t(U[:, 1:]), dt, quad,
                                           self.tf32).double()
            plant_gap = _widest(x_ans, x_next, rows_ok)
            # and the start: the scenario's position at rest, yawed about z
            yaw, z = scen[:, 6], torch.zeros_like(scen[:, :3])
            x0 = torch.cat([scen[:, 0:3], z, torch.cos(yaw / 2)[:, None], z[:, :2], torch.sin(yaw / 2)[:, None], z], 1)
            plant_gap = max(plant_gap, _widest(X[:, 0], x0, torch.ones_like(yaw, dtype=torch.bool)))

            # the reference's own gate trajectory from the scenario and the noise
            pts0 = plain.gate_from_width(scen[:, 7], scen[:, 8], self.config["sampler"]["gate_half_height"])
            moves, V = plain.gate_moves(pts0, motion["velocity"], w, noise, dt)

            # DNN2 at the replans, and the fixed point's residual at every step
            inp = plain.predicted_inputs(moves_prog[:, :N], V[:, :N], torch.full_like(t, w), t, X[:, :N],
                                         final[:, None, :].expand(-1, N, 3), f64)
            ok = torch.isfinite(inp).all(dim=-1) & torch.isfinite(t)
            out = self.dnn2(inp)
            rep = torch.arange(0, N, every, device=dev)
            ans = hl[:, rep + 1]
            if self.control:
                ans = self.dnn2_tf32(inp[:, rep]).double()
            dnn2_gap = _widest(ans, out[:, rep], ok[:, rep])
            t_resid_p50 = percentile((out[..., 6] - t).abs()[ok].tolist(), 50)

            traversed, diverged = plain.scorecard(X, moves, final)
        fail_share = float((~traversed | diverged).double().mean())
        lb = torch.tensor(self.config["bounds"]["u_lb"], dtype=U.dtype, device=dev)
        ub = torch.tensor(self.config["bounds"]["u_ub"], dtype=U.dtype, device=dev)
        excess = torch.maximum(U[:, 1:] - ub, lb - U[:, 1:]).clamp_min(0.0)
        return {"plant_gap": plant_gap, "dnn2_gap": dnn2_gap, "t_resid_p50": t_resid_p50,
                "fail_share": fail_share, "control_excess": float(excess.nan_to_num(0.0).max())}


def numbers(config: dict, cell: dict, flights: list, device, control: bool = False) -> dict:
    """The worst of each number over the judged flights [(scen, noise, log)]
    (with `control`, the TF32 reference's readings at the same rows)."""
    judge = FlightJudge(config, cell, device, control)
    out = {}
    for scen, noise, log in flights:
        for k, v in judge.numbers(scen, noise, log).items():
            out[k] = max(out.get(k, 0.0), v)
    return out
