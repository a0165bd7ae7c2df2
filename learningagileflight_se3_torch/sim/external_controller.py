"""The 10 Hz deployment tick for an external simulator.

Port of `learningagileflight_se3_tpu/sim/external_controller.py`: the
control stack a PyBullet-style host calls once per 10 Hz tick with
(pos, quat_xyzw, vel, euler_rates, rpy):

  1. state reassembly (origin shift, xyzw -> wxyz, Euler rates -> body rates);
  2. the traversal-time fixed point over DNN2 (sim/tsolver.py);
  3. the gate pose predicted t ahead, the 18-dim window input and DNN2;
  4. the window-frame MPC solve, warm-started from the previous tick;
  5. mixing to [thrust, tau_x, tau_y, tau_z].

Steps 2-5 run on `device`.  The warm-start trajectory and the previous
control stay there between ticks, in buffers the tick writes in place, the
mixing happens there, and the tick uploads one 28-value observation and
fetches one 9-value packet.  The query is solved as a batch of one (the JAX
tile of 128 or 8 rows is a TPU layout fix the kernels do not need).

On the card steps 2-5 are one CUDA graph, captured at construction: the
fixed point is one kernel (K4, sim/tsolver.py) and the solve's loop a
chain of conditional blocks (utils/graphs.py), so a tick is one copy of
the observation from pinned memory, one replay and the packet's fetch,
its only host read.  On the CPU, and on the card under solver/watch.py's
watchers, the same step runs eagerly, the solve's loop tests host reads
(on the card the fixed point is K4 there too).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from learningagileflight_se3_torch.config import (
    CostWeights,
    QuadParams,
    SolverConfig,
    Variant,
    preset,
)
from learningagileflight_se3_torch.geometry.gate import rotate_y, translate, window_inputs
from learningagileflight_se3_torch.sim.tsolver import make_traversal_time_solver
from learningagileflight_se3_torch.solver.ilqr import make_batched_mpc_solver
from learningagileflight_se3_torch.utils import graphs
from learningagileflight_se3_torch.utils.device import resolve_device
from learningagileflight_se3_torch.utils.profiling import spans

# sign matrix A: maps rotor thrusts to the [T, tau] convention together
# with diag([1, -l/2, l/2, -c])
_A = np.array(
    [
        [1.0, 1.0, 1.0, 1.0],
        [0.0, 1.0, 0.0, -1.0],
        [-1.0, 0.0, 1.0, 0.0],
        [-1.0, 1.0, -1.0, 1.0],
    ]
)


def euler_rates_to_body(d_rpy, rpy):
    """Euler-angle rates -> body angular velocity (host numpy)."""
    roll, pitch = rpy[0], rpy[1]
    Q_inv = np.array(
        [
            [1.0, 0.0, -np.sin(pitch)],
            [0.0, np.cos(roll), np.sin(roll) * np.cos(pitch)],
            [0.0, -np.sin(roll), np.cos(roll) * np.cos(pitch)],
        ]
    )
    return Q_inv @ np.asarray(d_rpy)


def quat_xyzw_to_wxyz(q):
    q = np.asarray(q)
    return q[[3, 0, 1, 2]]


class ExternalSimController:
    """Receding-horizon gate-traversal controller for an external simulator.

    Args:
      model2: the DNN2 window-frame policy (an `nn.Module` with its weights);
        it is moved to `device` and `dtype`.
      final_point: goal position in world frame.
      gate_motion: callable step -> (gate_pts (4,3), velocity (3,)).
      w_rot: gate pitch rate (rad/s).
      origin: scenario origin subtracted from raw positions.
      device, dtype: where and in what precision steps 2-5 run; the card by
        default (raises where there is none), `device="cpu"` for the CPU.

    `solution` is the last tick's MPCSolution, on the device; on the card
    its tensors are the tick graph's buffers, valid until the next tick.
    """

    def __init__(
        self,
        model2,
        final_point,
        gate_motion,
        w_rot: float,
        origin=(0.0, 0.0, 0.0),
        variant: Variant = Variant.PYBULLET,
        solver_cfg: Optional[SolverConfig] = None,
        params: Optional[QuadParams] = None,
        weights: Optional[CostWeights] = None,
        fixed_point_tol: float = 1e-2,
        fixed_point_accel: str = "reference",
        warm_start: bool = True,
        device="cuda",
        dtype=torch.float64,
    ):
        p, w, s, *_ = preset(variant)
        self.params = params or p
        self.weights = weights or w
        self.solver_cfg = solver_cfg or s
        self.device = resolve_device(device)
        self.dtype = dtype
        self.model2 = model2.to(device=self.device, dtype=dtype)
        self.gate_motion = gate_motion
        self.w_rot = float(w_rot)
        self.origin = np.asarray(origin, dtype=np.float64)
        self.warm_start = warm_start

        kw = dict(dtype=dtype, device=self.device)
        mix = np.diag([1.0, -self.params.l / 2, self.params.l / 2, -self.params.c]) @ _A
        self._mix = torch.as_tensor(mix, **kw)
        self._final = torch.as_tensor(np.asarray(final_point, dtype=np.float64), **kw)
        self._tsolve = make_traversal_time_solver(self.model2, tol=fixed_point_tol,
                                                  accel=fixed_point_accel)
        self._solve = make_batched_mpc_solver(self.params, self.weights, self.solver_cfg)
        H = self.solver_cfg.horizon
        # device-resident tick carry, written in place by each tick: the
        # previous control and the warm-start U (the hover guess until a
        # warm-started tick has run)
        self.u = np.zeros(4)
        self._u_dev = torch.zeros(4, **kw)
        self._U_dev = torch.full((H, 4), 0.5 * (self.solver_cfg.u_lb + self.solver_cfg.u_ub), **kw)
        self._obs = torch.zeros(28, **kw)
        self.solution = None  # the last tick's MPC solution, on the device
        self.captures = graphs.Captures()
        self._graphs = {}  # the spans' state (utils/profiling.py) -> the tick's graph
        if self._graphed():
            self._capture()

    def _graphed(self) -> bool:
        return graphs.drive(self.device) == "graph" and self._solve.graphed(self.device)

    def _capture(self):
        """The tick's steps 2-5 as one CUDA graph over the carry and
        observation buffers (the warm-up runs every block on copies), kept
        for the spans' state it was captured in.  It is replayed once here,
        the carry kept: a graph's first launch uploads it to the card, which
        is no tick's to pay.  Returns the graph."""
        self._obs_host = torch.zeros(28, dtype=self.dtype, pin_memory=True)
        carry = (self._u_dev, self._U_dev)
        g = self._graphs[spans.on] = self.captures.capture(
            lambda: self._write(*self._device_step(self._obs, *carry, drive="chain")),
            warmup=lambda: self._device_step(self._obs, *(c.clone() for c in carry), drive="blocks"))
        kept = [c.clone() for c in carry]
        g.replay()
        for c, k in zip(carry, kept):
            c.copy_(k)
        return g

    def _write(self, packed, u, U, sol):
        """Write a step's control and plan into the carry; (packed, sol)."""
        self._u_dev.copy_(u)
        if self.warm_start:
            self._U_dev.copy_(U)
        return packed, sol

    @torch.no_grad()
    def _device_step(self, obs, u_prev, U_warm, drive=None):
        state = obs[0:13]
        gate_pts = obs[13:25].reshape(4, 3)
        velo = obs[25:28]
        t = self._tsolve(state, self._final, gate_pts, velo, self.w_rot, drive=drive)
        pts_f = rotate_y(translate(gate_pts, t * velo), t * self.w_rot)
        inp = window_inputs(pts_f, state, self._final)
        out = self.model2(inp)
        sol = self._solve(
            inp[None, 0:13], u_prev[None], inp[None, 13:16],
            out[None, 0:3], out[None, 3:6], out[None, 6], U_init=U_warm[None], drive=drive,
        )
        u = sol.control_traj[0, 0]
        packed = torch.cat([self._mix @ u, u, t.reshape(1).to(u.dtype)])
        return packed, u, sol.control_traj[0], sol

    def compute_control(self, step, cur_pos, cur_quat_xyzw, cur_vel, cur_euler_rates, cur_rpy):
        """One 10 Hz control query. Returns ([T, tau_x, tau_y, tau_z], t)."""
        gate_pts, velo = self.gate_motion(step)
        state = np.hstack(
            [
                np.asarray(cur_pos) - self.origin,
                np.asarray(cur_vel),
                quat_xyzw_to_wxyz(cur_quat_xyzw),
                euler_rates_to_body(cur_euler_rates, cur_rpy),
            ]
        )
        obs = np.concatenate(
            [state, np.asarray(gate_pts, dtype=np.float64).ravel(),
             np.asarray(velo, dtype=np.float64)]
        )
        if self._graphed():
            # none yet: made under the watchers, or in the other spans' state
            g = self._graphs.get(spans.on) or self._capture()
            self._obs_host.copy_(torch.from_numpy(obs))
            self._obs.copy_(self._obs_host, non_blocking=True)
            g.replay()
            packed, self.solution = g.out
        else:
            self._obs.copy_(torch.as_tensor(obs, dtype=self.dtype))
            packed, self.solution = self._write(*self._device_step(self._obs, self._u_dev, self._U_dev))
        res = graphs.fetch(packed).numpy()  # the tick's single result fetch
        self.u = res[4:8]
        return res[0:4], float(res[8])
