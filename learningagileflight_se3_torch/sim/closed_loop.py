"""Closed-loop flight through a moving gate, all scenarios at once.

Port of `learningagileflight_se3_tpu/sim/closed_loop.py`.  The JAX version
is one `lax.scan` per scenario under `vmap`, its replan a `lax.cond`; here
every scenario is a lane of one batch, and one step function serves every
drive:

  100 Hz plant (Euler dt=0.01, renormalised quaternion by default)
  100 Hz traversal-time fixed point (sim/tsolver.py, batched)
   10 Hz replanning: the gate pose predicted t ahead, the 18-dim window
        input, DNN2, and one batched window-frame MPC solve (the kernels on
        the card), warm-started from the time-shifted previous plan

On the card the step is two CUDA graphs per batch size and observation
noise, captured at the first flight: the hold step and the replan step
(the `lax.cond`), each with its fixed point as one node (K4,
sim/tsolver.py) and, in the replan step, its solve as a chain of
conditional blocks (utils/graphs.py), over one set of static buffers: the
carry (state, control, warm start, DNN2's output, the Kalman state), the
step's inputs and its outputs.  The host loop copies a step's gate row,
velocity and observation noise into the inputs, replays the graph the step
names and copies the outputs into the preallocated logs, all queued on the
card: nothing inside a flight waits for it, and the caller's read of the log
is the one sync.  On the CPU, and on the card under solver/watch.py's
watchers, the same step runs in a host loop over the steps, the loop tests
of its fixed points and solves host reads.  A lane
whose state stops being finite stays a lane: its rows go NaN, the solver
retires it by its regularisation blow-out, and no other lane reads it.

With utils/profiling.py's spans on, a flight records the device spans
"flight.step" (a step's work, first node to last), "flight.tsolve" (the
fixed point: on the card K4's launch), "flight.replan" (the window
inputs, DNN2, the solve and the warm-start shift) and, with
`estimate_gate_motion`, "flight.estimate" (the gate's observation and the
Kalman filter's predict and update), and the host spans
"flight.prepare" (the flight's inputs, gate motion and buffers),
"flight.inputs" (a step's copies in), "flight.launch" (a step's replay, or
its queuing in the host step loop), "flight.log" (a step's copies out) and
"flight.finish"; the t-solver adds [0, iterations] to the counter
"flight.tsolve" (on the card the batch's iterations are the largest lane
count) and, on the card, [fixed points run, lane-iterations run] to the
counter "tsolve.fused"; the replans' line searches on the grid add
[searches, trips] to the counter "ls.grid" (solver/ilqr_batched.py); with
`estimate_gate_motion` the filter adds [updates, lanes whose pitch
innovation was wrapped] to the counter "estimate.wraps".  The step graphs
of the two states are kept apart.
"""

from __future__ import annotations

import copy
from typing import NamedTuple, Optional

import torch

from learningagileflight_se3_torch.config import (
    CostWeights,
    GateMotionConfig,
    QuadParams,
    SolverConfig,
)
from learningagileflight_se3_torch.dynamics.quadrotor import (
    euler_step,
    euler_step_renorm,
    thrust_torque,
)
from learningagileflight_se3_torch.geometry.gate import (
    gate_centroid,
    gate_frame,
    gate_move,
    rotate_y,
    translate,
    window_inputs,
)
from learningagileflight_se3_torch.models.sampler import scenario_to_problem
from learningagileflight_se3_torch.sim.estimator import (
    KalmanState,
    estimated_velocity,
    gate_observation,
    kalman_init,
    make_kalman_step,
)
from learningagileflight_se3_torch.sim.tsolver import make_traversal_time_solver
from learningagileflight_se3_torch.solver.ilqr import make_batched_mpc_solver
from learningagileflight_se3_torch.utils import graphs
from learningagileflight_se3_torch.utils.device import resolve_device
from learningagileflight_se3_torch.utils.profiling import spans


class _Carry(NamedTuple):
    """What one plant step hands the next, per lane."""

    state: torch.Tensor  # (B, 13)
    u: torch.Tensor      # (B, 4) the control held until the next replan
    U_warm: torch.Tensor  # (B, H, 4) the next replan's warm start
    out: torch.Tensor    # (B, 7) DNN2's output at the last replan
    kx: torch.Tensor     # (B, 8) the Kalman filter's mean
    kP: torch.Tensor     # (B, 8, 8) and covariance


class _Inputs(NamedTuple):
    """A step's inputs: the gate corners, the true gate velocity and the
    observation noise (zeros without one) of the step, and the flight's
    goal and true pitch rate."""

    pts: torch.Tensor    # (B, 4, 3)
    vel: torch.Tensor    # (B, 3)
    noise: torch.Tensor  # (B, 4, 3)
    final: torch.Tensor  # (B, 3)
    w: torch.Tensor      # (B,)


class _Outputs(NamedTuple):
    """A step's log rows besides the carry's."""

    t: torch.Tensor         # (B,)
    vel_used: torch.Tensor  # (B, 4)
    torques: torch.Tensor   # (B, 4)
    iters: torch.Tensor     # (B,) int32, the replan's iterations (0 on a hold step)


class ClosedLoopLog(NamedTuple):
    """The reference's 8 logs and the solver's, with a leading scenario axis."""

    states: torch.Tensor         # (B, N+1, 13)
    controls: torch.Tensor       # (B, N+1, 4)  row 0 = zeros
    torques: torch.Tensor        # (B, N+1, 4)  [T, Mx, My, Mz] mixer outputs
    hl_variables: torch.Tensor   # (B, N+1, 7)  DNN2 outputs at each step
    tra_times: torch.Tensor      # (B, N) relative traversal time t
    abs_tra_times: torch.Tensor  # (B, N) t + i*dt
    times: torch.Tensor          # (B, N) sim time
    pitches: torch.Tensor        # (B, N) open-loop gate pitch estimate
    gate_moves: torch.Tensor     # (B, N+1, 4, 3) gate corner trajectory
    solver_iters: torch.Tensor   # (B, N) MPC iterations (0 on non-replan steps)
    gate_vel_used: torch.Tensor  # (B, N, 4) [v(3), pitch_rate] fed to the planner
                                 # (ground truth, or the filter's estimate)


def make_closed_loop_sim(
    model2,
    params_q: QuadParams = QuadParams(),
    weights: CostWeights = CostWeights(),
    solver_cfg: SolverConfig = SolverConfig(),
    motion_cfg: GateMotionConfig = GateMotionConfig(),
    steps: int = 500,
    control_every: int = 10,
    plant_dt: float = 0.01,
    fixed_point_tol: float = 1e-3,
    fixed_point_accel: str = "reference",
    warm_start: bool = True,
    estimate_gate_motion: bool = False,
    gate_obs_noise: float = 0.0,
    renorm_plant: bool = True,
    device="cuda",
    dtype=torch.float32,
):
    """sim(scenarios (B, 9), generator=None, gate_noise=None, obs_noise=None,
    drive=None) -> ClosedLoopLog, on `device` (the card by default, which
    raises where there is none; `device="cpu"` for the CPU) in `dtype`, with
    a copy of `model2` (DNN2) moved there.  `drive` None takes the step
    graphs on the card (the module's docstring) and the host step loop on
    the CPU and under the watchers; "eager" names the host step loop, each
    fixed point and solve on its own drive (their eager loops on the CPU,
    the solves' under the watchers too; their own graphs on the card), and
    "blocks" the step graphs' code run in place of their replays, every
    conditional block of the solve run (the CPU's check of what the graphs
    capture; the fixed point there is the t-solver's eager loop, as K4's
    plain version).
    `sim.captures` holds the step graphs' captures.

    A scenario is the 9-dim vector (start, goal, yaw, gate width, gate pitch).
    The gate's velocity noise is `gate_noise` (B, steps, 3), already clipped,
    or is drawn from `generator`; with `estimate_gate_motion` the planner is
    fed the Kalman filter's velocity and pitch rate (sim/estimator.py) over
    gate-pose observations whose corner noise is `obs_noise` (B, steps, 4, 3)
    or gate_obs_noise * N(0,1) from `generator`, in place of the ground
    truth."""
    device = resolve_device(device)
    model2 = copy.deepcopy(model2).to(device=device, dtype=dtype)
    tsolve = make_traversal_time_solver(model2, tol=fixed_point_tol, accel=fixed_point_accel)
    kstep = make_kalman_step(dt=plant_dt)
    solve = make_batched_mpc_solver(params_q, weights, solver_cfg)
    # receding-horizon warm start: the next replan is control_every*plant_dt
    # seconds later, `shift` solver steps into this plan; only an integer
    # ratio gives a time-consistent shifted guess
    shift_f = control_every * plant_dt / solver_cfg.dt
    warm_shift = int(round(shift_f))
    if warm_start and (warm_shift < 1 or abs(shift_f - warm_shift) > 1e-9
                       or warm_shift > solver_cfg.horizon):
        raise ValueError(
            f"warm_start needs control_every*plant_dt to be an integer "
            f"multiple of the solver dt no larger than the horizon: "
            f"{control_every}*{plant_dt} / {solver_cfg.dt} = {shift_f} "
            f"(horizon {solver_cfg.horizon})"
        )
    H = solver_cfg.horizon
    w_rot = motion_cfg.omega_y
    step_plant = euler_step_renorm if renorm_plant else euler_step
    u_mid = 0.5 * (solver_cfg.u_lb + solver_cfg.u_ub)
    captures = graphs.Captures()
    step_graphs = {}  # (B, with observation noise, spans on) -> (static carry, inputs, outputs, {replan: replay})

    def step(c: _Carry, x: _Inputs, replan: bool, noisy: bool, drive):
        """One plant step (with a replan or not): the next carry and the
        step's outputs."""
        kx, kP = c.kx, c.kP
        if estimate_gate_motion:
            with spans.device("flight.estimate", device):
                ks = kstep(KalmanState(kx, kP), gate_observation(x.pts, noise=x.noise if noisy else None))
            kx, kP = ks
            vel, w_use = estimated_velocity(ks)
        else:
            vel, w_use = x.vel, x.w
        with spans.device("flight.tsolve", device):
            t = tsolve(c.state, x.final, x.pts, vel, w_use, drive=drive)
        u, U_warm, out = c.u, c.U_warm, c.out
        iters = torch.zeros_like(c.state[:, 0], dtype=torch.int32)
        if replan:
            with spans.device("flight.replan", device):
                # the gate pose predicted t ahead, then the window-frame MPC
                pts_f = rotate_y(translate(x.pts, t[:, None] * vel), t * w_use)
                inp = window_inputs(pts_f, c.state, x.final)
                out = model2(inp)
                sol = solve(inp[:, 0:13], u, inp[:, 13:16], out[:, 0:3], out[:, 3:6], out[:, 6],
                            U_init=U_warm if warm_start else None, drive=drive)
                U = sol.control_traj.to(dtype)
                u = U[:, 0]
                # the time-shifted remainder of this plan, its last control held
                U_warm = torch.cat([U[:, warm_shift:], U[:, -1:].expand(-1, warm_shift, 4)], dim=1)
                iters = sol.iterations
        state = step_plant(c.state, u, plant_dt, params_q)
        vel_used = torch.cat([vel, w_use[:, None]], dim=-1)
        return (_Carry(state, u, U_warm, out, kx, kP),
                _Outputs(t, vel_used, thrust_torque(u, params_q), iters))

    def buffers(c0: _Carry, x0: _Inputs, noisy: bool):
        """Static buffers for the carry, the inputs and the outputs (copies
        of c0 and x0), and run(replan, drive): one step from them into them,
        what a step graph captures."""
        c = _Carry(*(a.clone() for a in c0))
        x = _Inputs(*(a.clone() for a in x0))
        o = _Outputs(torch.zeros_like(x.w), torch.zeros_like(c.u), torch.zeros_like(c.u),
                     torch.zeros_like(x.w, dtype=torch.int32))

        def run(replan, drive):
            with spans.device("flight.step", device):
                nc, no = step(c, x, replan, noisy, drive)
                for dst, src in zip((*c, *o), (*nc, *no)):
                    dst.copy_(src)

        return c, x, o, run

    def step_graphs_for(c0: _Carry, x0: _Inputs, noisy: bool):
        """The static buffers and {replan: replay} of the hold and replan
        graphs for this batch size, noise and spans' state, captured at the
        first flight (each warm-up runs every block on a copy of the carry)."""
        key = (c0.state.shape[0], noisy, spans.on)
        if key not in step_graphs:
            c, x, o, run = buffers(c0, x0, noisy)
            warm = lambda r: lambda: step(_Carry(*(a.clone() for a in c)), x, r, noisy, "blocks")  # noqa: E731
            step_graphs[key] = c, x, o, {r: captures.capture(lambda r=r: run(r, "chain"), warmup=warm(r)).replay
                                         for r in (False, True)}
        return step_graphs[key]

    @torch.no_grad()
    def sim(scenarios, generator: Optional[torch.Generator] = None, gate_noise=None,
            obs_noise=None, drive=None):
        # the counters are made before any capture that adds to them
        tsolve.count = spans.counter("flight.tsolve", device) if spans.on else None
        tsolve.fused = spans.counter("tsolve.fused", device) if spans.on else None
        kstep.count = spans.counter("estimate.wraps", device) if spans.on and estimate_gate_motion else None
        with spans.host("flight.prepare"):
            kw = dict(dtype=dtype, device=device)
            on_device = lambda a: None if a is None else torch.as_tensor(a).to(**kw)
            scen = on_device(scenarios)
            B = scen.shape[0]
            prob = scenario_to_problem(scen)  # gate corners pitched by scenario[8]
            final, pitch0 = prob["goal_pos"], scen[:, 8]
            moves, V = gate_move(prob["gate_pts"], generator, motion_cfg.velocity, w_rot,
                                 T=steps * plant_dt, dt=plant_dt, noise_std=motion_cfg.noise_std,
                                 noise_clip=motion_cfg.noise_clip, noise=on_device(gate_noise))
            obs_noise = on_device(obs_noise)
            if estimate_gate_motion and obs_noise is None and generator is not None and gate_obs_noise > 0.0:
                obs_noise = gate_obs_noise * torch.randn(
                    (B, steps, 4, 3), generator=generator, dtype=dtype, device=generator.device).to(device)
            noisy = estimate_gate_motion and obs_noise is not None

            ks = kalman_init(gate_observation(moves[:, 0]), dtype=dtype)
            c = _Carry(prob["x0"], torch.zeros((B, 4), **kw), torch.full((B, H, 4), u_mid, **kw),
                       torch.zeros((B, 7), **kw), ks.x, ks.P)
            zeros3 = torch.zeros((B, 4, 3), **kw)
            x = _Inputs(moves[:, 0], V[:, 0], obs_noise[:, 0] if noisy else zeros3, final,
                        torch.full((B,), w_rot, **kw))

            # time-major logs, written in place; row 0 of the first four is the start
            states = torch.zeros((steps + 1, B, 13), **kw)
            controls = torch.zeros((steps + 1, B, 4), **kw)
            torques = torch.zeros((steps + 1, B, 4), **kw)
            hl = torch.zeros((steps + 1, B, 7), **kw)
            tra_times = torch.zeros((steps, B), **kw)
            iters = torch.zeros((steps, B), dtype=torch.int32, device=device)
            vel_used = torch.zeros((steps, B, 4), **kw)
            states[0] = c.state

            drive = drive or graphs.drive(device)
            if drive == "graph" and not solve.graphed(device):
                drive = "eager"

        static = drive in ("graph", "blocks")
        if drive == "graph":
            c_s, x_s, o, go = step_graphs_for(c, x, noisy)
        elif drive == "blocks":  # the graphs' code, run in place of the replays
            c_s, x_s, o, run = buffers(c, x, noisy)
            go = {r: (lambda r=r: run(r, "blocks")) for r in (False, True)}
        if static:
            for dst, src in zip((*c_s, x_s.final, x_s.w), (*c, x.final, x.w)):
                dst.copy_(src)
        for i in range(steps):
            replan = i % control_every == 0
            if static:
                with spans.host("flight.inputs"):
                    x_s.pts.copy_(moves[:, i])
                    x_s.vel.copy_(V[:, i])
                    if noisy:
                        x_s.noise.copy_(obs_noise[:, i])
                with spans.host("flight.launch"):
                    go[replan]()
                c = c_s
            else:
                x = x._replace(pts=moves[:, i], vel=V[:, i], noise=obs_noise[:, i] if noisy else zeros3)
                with spans.host("flight.launch"), spans.device("flight.step", device):
                    c, o = step(c, x, replan, noisy, None)
            with spans.host("flight.log"):
                states[i + 1], controls[i + 1], hl[i + 1], torques[i + 1] = c.state, c.u, c.out, o.torques
                tra_times[i], vel_used[i] = o.t, o.vel_used
                if replan:
                    iters[i] = o.iters

        with spans.host("flight.finish"):
            times = torch.arange(steps, **kw) * plant_dt
            lanes_first = lambda a: a.transpose(0, 1).contiguous()
            tra_times = lanes_first(tra_times)
            return ClosedLoopLog(
                states=lanes_first(states),
                controls=lanes_first(controls),
                torques=lanes_first(torques),
                hl_variables=lanes_first(hl),
                tra_times=tra_times,
                abs_tra_times=tra_times + times,
                times=times.expand(B, steps).contiguous(),
                pitches=pitch0[:, None] + w_rot * times,
                gate_moves=moves,
                solver_iters=lanes_first(iters),
                gate_vel_used=lanes_first(vel_used),
            )

    sim.captures = captures
    return sim


class ClosedLoopMetrics(NamedTuple):
    """Closed-loop scorecard, one entry per scenario."""

    traversed: torch.Tensor       # crossed the gate plane inside the rectangle
    margin: torch.Tensor          # window-frame clearance at the crossing
    final_dist: torch.Tensor      # |r_N - goal|
    reached_1m: torch.Tensor      # final_dist < 1 m
    reached_2m: torch.Tensor      # final_dist < 2 m
    diverged: torch.Tensor        # non-finite state or runaway |r| > 50 m
    goal_speed_end: torch.Tensor  # closing speed toward the goal at the end (m/s;
                                  # > 0 still converging, < 0 drifting away)


def evaluate_closed_loop_full(log: ClosedLoopLog, final_point) -> ClosedLoopMetrics:
    """Scorecard of a batch of flights; `final_point` (B, 3).

    traversed: the quad's centre crossed the moving gate's plane, in either
    direction, within the corner rectangle; margin: the smaller window-frame
    clearance in x and z at the first crossing step.  Non-finite states
    count as never crossing.  The strict deliverable is traversed and
    reached and not diverged."""
    states = log.states[:, 1:]
    N = states.shape[1]
    moves = log.gate_moves[:, :N]
    goal = torch.as_tensor(final_point, dtype=states.dtype, device=states.device)

    # window-frame position: the first three window inputs
    rel = (gate_frame(moves) @ (states[..., 0:3] - gate_centroid(moves))[..., None])[..., 0]
    widths = torch.linalg.vector_norm(moves[..., 0, :] - moves[..., 1, :], dim=-1)
    # half height from the corner geometry (corner 0 top-left, 3 bottom-left)
    half_heights = 0.5 * torch.linalg.vector_norm(moves[..., 0, :] - moves[..., 3, :], dim=-1)
    rel_y = torch.where(torch.isfinite(rel[..., 1]), rel[..., 1], torch.inf)
    behind = rel_y < 0  # a sample exactly on the plane counts as in front
    crossed = behind[:, :-1] != behind[:, 1:]
    any_cross = crossed.any(dim=1)
    ci = (torch.argmax(crossed.to(torch.int8), dim=1) + 1)[:, None]  # first crossing
    at = lambda a: torch.gather(a, 1, ci)[:, 0]
    x_m = at(widths) / 2.0 - at(rel[..., 0]).abs()
    z_m = at(half_heights) - at(rel[..., 2]).abs()
    margin = torch.minimum(x_m, z_m)
    pos = states[..., 0:3]
    final_distance = torch.linalg.vector_norm(pos[:, -1] - goal, dim=-1)
    diverged = (~torch.isfinite(states).all(dim=(1, 2))) | (
        torch.where(torch.isfinite(pos), pos, 1e9).abs().amax(dim=(1, 2)) > 50.0)
    # closing speed toward the goal at the end: v . (goal - r)/|goal - r|
    to_goal = goal - pos[:, -1]
    to_goal = to_goal / torch.clamp_min(torch.linalg.vector_norm(to_goal, dim=-1, keepdim=True), 1e-6)
    return ClosedLoopMetrics(
        traversed=any_cross & (margin > 0),
        margin=margin,
        final_dist=final_distance,
        reached_1m=final_distance < 1.0,
        reached_2m=final_distance < 2.0,
        diverged=diverged,
        goal_speed_end=torch.sum(states[:, -1, 3:6] * to_goal, dim=-1),
    )


def evaluate_closed_loop(log: ClosedLoopLog, final_point):
    """(traversed, crossing margin, final distance) of evaluate_closed_loop_full."""
    m = evaluate_closed_loop_full(log, final_point)
    return m.traversed, m.margin, m.final_dist
