"""End-to-end validation flight: the deployed 10 Hz tick in the independent
100 Hz plant (the role of the reference's PyBullet simulation).

Port of `learningagileflight_se3_tpu/sim/validation_sim.py`.  Wires
together:

  scenario sample / replay
  -> precomputed moving-gate trajectory     (geometry/gate.py gate_move)
  -> ValidationEnv at 100 Hz                (sim/validation_env.py, float64 RK4)
  -> ExternalSimController at 10 Hz         (sim/external_controller.py)
  -> SimLogger (npy + CSV + plots)
  -> gate-traversal detection + metrics

Defaults: 100 Hz plant / 10 Hz control / 5 s, gate origin (0, 0, 3), start
[3, -3, -0.2] +- 2, goal [0, 4, 0] +- 1, gate width clip(N(0.35, 0.1),
[0.3, 0.4]), half height 0.5, gate velocity (1, 0.3, 0.4), pitch rate pi/2.

The plant and the metrics are numpy on the host; the tick runs on `device`
(the card by default).  The "use last settings" replay backup is an .npz of
the full scenario.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from learningagileflight_se3_torch.config import GateMotionConfig, QuadParams, Variant
from learningagileflight_se3_torch.geometry.gate import gate_from_width, gate_move
from learningagileflight_se3_torch.sim.external_controller import ExternalSimController
from learningagileflight_se3_torch.sim.validation_env import ValidationEnv, ValidationEnvConfig
from learningagileflight_se3_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ValidationSimConfig:
    """The flight's settings (the reference's PyBullet DEFAULT_* block)."""

    sim_freq_hz: int = 100
    ctrl_freq_hz: int = 10
    duration_sec: float = 5.0
    gate_origin: Tuple[float, float, float] = (0.0, 0.0, 3.0)
    start_p: float = -3.0
    st_p_range: float = 2.0
    end_p: float = 4.0
    end_p_range: float = 1.0
    gate_wid_mean: float = 0.35
    gate_wid_std: float = 0.1
    gate_wid_lim: Tuple[float, float] = (0.3, 0.4)
    half_gate_height: float = 0.5
    gate_v: Tuple[float, float, float] = (1.0, 0.3, 0.4)
    gate_w: float = np.pi / 2
    fixed_point_tol: float = 1e-2      # the PyBullet fork's t-solver tolerance


def sample_validation_scenario(rng: np.random.Generator, cfg: ValidationSimConfig) -> dict:
    """Start around [3, start_p, -0.2], goal around [0, end_p, 0], yaw ~
    U(+-pi/6), width ~ clip-normal, pitch bimodal and coupled to the width."""
    start = np.array([3.0, cfg.start_p, -0.2]) + rng.uniform(
        -cfg.st_p_range, cfg.st_p_range, size=3
    )
    final = np.array([0.0, cfg.end_p, 0.0]) + rng.uniform(
        -cfg.end_p_range, cfg.end_p_range, size=3
    )
    yaw = rng.uniform(-np.pi / 6, np.pi / 6)
    width = float(
        np.clip(rng.normal(cfg.gate_wid_mean, cfg.gate_wid_std), *cfg.gate_wid_lim)
    )
    angle = np.clip(1.3 * (1.2 - width), 0.0, np.pi / 3)
    angle1 = (np.pi / 2 - angle) / 3
    if rng.normal() > 0:
        pitch = float(np.clip(rng.normal(angle + angle1, 2 * angle1 / 3), angle, np.pi / 2))
    else:
        pitch = float(
            np.clip(rng.normal(-angle - angle1, 2 * angle1 / 3), -np.pi / 2, -angle)
        )
    return {
        "start_point": start,
        "final_point": final,
        "yaw": float(yaw),
        "gate_width": width,
        "gate_pitch": pitch,
    }


class SimLogger:
    """Timestamped state / control recorder: in-memory arrays, .npy dump,
    one CSV, optional matplotlib plots."""

    FIELDS = ("x", "y", "z", "qx", "qy", "qz", "qw", "r", "p", "yaw",
              "vx", "vy", "vz", "dr", "dp", "dyaw", "T", "taux", "tauy", "tauz")

    def __init__(self):
        self.timestamps = []
        self.states = []
        self.actions = []
        self.extras = []

    def log(self, timestamp: float, state20, action, extra: float = 0.0):
        self.timestamps.append(float(timestamp))
        self.states.append(np.asarray(state20)[:16])
        self.actions.append(np.asarray(action))
        self.extras.append(float(extra))

    def arrays(self):
        return (
            np.asarray(self.timestamps),
            np.asarray(self.states),
            np.asarray(self.actions),
            np.asarray(self.extras),
        )

    def save(self, folder: str, tag: str = "validation"):
        os.makedirs(folder, exist_ok=True)
        ts, st, ac, ex = self.arrays()
        np.save(os.path.join(folder, f"{tag}_timestamps.npy"), ts)
        np.save(os.path.join(folder, f"{tag}_states.npy"), st)
        np.save(os.path.join(folder, f"{tag}_actions.npy"), ac)
        np.save(os.path.join(folder, f"{tag}_tra_time.npy"), ex)

    def save_as_csv(self, folder: str, tag: str = "validation"):
        os.makedirs(folder, exist_ok=True)
        ts, st, ac, _ = self.arrays()
        data = np.hstack([st, ac])
        header = "t," + ",".join(self.FIELDS)
        np.savetxt(
            os.path.join(folder, f"{tag}.csv"),
            np.hstack([ts[:, None], data]),
            delimiter=",",
            header=header,
            comments="",
        )

    def plot(self, folder: str, tag: str = "validation"):
        from learningagileflight_se3_torch.sim.plotting import _plt

        plt = _plt()
        ts, st, ac, _ = self.arrays()
        fig, axes = plt.subplots(2, 2, figsize=(10, 7))
        axes[0, 0].plot(ts, st[:, 0:3]); axes[0, 0].set_title("position")
        axes[0, 1].plot(ts, st[:, 10:13]); axes[0, 1].set_title("velocity")
        axes[1, 0].plot(ts, st[:, 7:10]); axes[1, 0].set_title("rpy")
        axes[1, 1].plot(ts, ac); axes[1, 1].set_title("thrust/torques")
        fig.tight_layout()
        os.makedirs(folder, exist_ok=True)
        fig.savefig(os.path.join(folder, f"{tag}.png"), dpi=110)
        plt.close(fig)


def _traversal_metrics(states, gate_pts_per_step, width, half_height):
    """Did the vehicle cross the gate plane inside the opening, and with what
    edge clearance?  Analysed in the gate's window frame at the first step
    whose segment crosses the plane."""
    crossed = False
    margin = -np.inf
    for i in range(1, len(states)):
        pts = gate_pts_per_step[i]
        centroid = pts.mean(axis=0)
        # window frame axes: x along corner1->corner2 (top edge), plane
        # normal from the corner cross product
        ex = pts[1] - pts[0]
        ex = ex / np.linalg.norm(ex)
        ez = pts[0] - pts[3]
        ez = ez / np.linalg.norm(ez)
        ey = np.cross(ez, ex)
        prev = states[i - 1][0:3] - centroid
        cur = states[i][0:3] - centroid
        if (prev @ ey) < 0.0 <= (cur @ ey):
            s = (0.0 - prev @ ey) / max(cur @ ey - prev @ ey, 1e-12)
            hit = prev + s * (cur - prev)
            dx, dz = abs(hit @ ex), abs(hit @ ez)
            inside = dx < width / 2 and dz < half_height
            margin = float(min(width / 2 - dx, half_height - dz))
            crossed = bool(inside)
            break
    return crossed, margin


def gate_trajectory(scen: dict, cfg: ValidationSimConfig, seed: int = 0, gate_noise=None):
    """The gate's corners and velocity at every plant step in the relative
    frame, float64 numpy (n+1, 4, 3) and (n+1, 3), with the PyBullet fork's
    noise clip of 0.2.  The velocity noise is `gate_noise` (n, 3), already
    scaled and clipped, where the caller made it, else drawn from a CPU
    `torch.Generator` seeded with `seed`."""
    f64 = dict(dtype=torch.float64)
    pts0 = gate_from_width(torch.tensor(scen["gate_width"], **f64),
                           torch.tensor(scen["gate_pitch"], **f64), cfg.half_gate_height)
    motion_cfg = GateMotionConfig(
        velocity=tuple(cfg.gate_v), omega_y=float(cfg.gate_w), noise_clip=0.2
    )
    if gate_noise is not None:
        gate_noise = torch.tensor(np.asarray(gate_noise), **f64)
    moves, V = gate_move(
        pts0,
        torch.Generator().manual_seed(seed),
        torch.tensor(cfg.gate_v, **f64),
        motion_cfg.omega_y,
        T=cfg.duration_sec,
        dt=1.0 / cfg.sim_freq_hz,
        noise_std=motion_cfg.noise_std,
        noise_clip=motion_cfg.noise_clip,
        noise=gate_noise,
    )
    return moves.numpy(), V.numpy()


def run_validation_sim(
    model2,
    cfg: ValidationSimConfig = ValidationSimConfig(),
    env_cfg: Optional[ValidationEnvConfig] = None,
    params: QuadParams = QuadParams(),
    seed: int = 0,
    output_folder: Optional[str] = None,
    replay_file: Optional[str] = None,
    save_settings: bool = False,
    plot: bool = False,
    device="cuda",
    dtype=torch.float64,
    gate_noise=None,
) -> dict:
    """Fly DNN2 + MPC closed-loop in the independent validation plant.

    `model2` is the DNN2 `nn.Module` with its weights; the tick runs on
    `device` (the card by default; raises where there is none) in `dtype`.
    The gate moves as `gate_trajectory(scenario, cfg, seed, gate_noise)`
    says.  `replay_file` / `save_settings` are the last-settings replay
    backup.

    Returns the scenario, the logger, `through_gate`, `gate_margin`,
    `final_distance`, the plant's 13-states after every step (n_steps, 13)
    and `tick_s`, each tick's host time in seconds (its one fetch included).
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    if replay_file is not None:
        z = np.load(replay_file)
        scen = {k: z[k] for k in z.files}
        scen["yaw"] = float(scen["yaw"])
        scen["gate_width"] = float(scen["gate_width"])
        scen["gate_pitch"] = float(scen["gate_pitch"])
    else:
        scen = sample_validation_scenario(rng, cfg)
    if save_settings and output_folder:
        os.makedirs(output_folder, exist_ok=True)
        np.savez(os.path.join(output_folder, "last_inputs.npz"), **scen)

    origin = np.asarray(cfg.gate_origin, dtype=np.float64)
    n_steps = int(cfg.duration_sec * cfg.sim_freq_hz)
    ctrl_every = int(cfg.sim_freq_hz // cfg.ctrl_freq_hz)

    moves, V = gate_trajectory(scen, cfg, seed, gate_noise)

    def gate_motion_rel(step: int):
        i = min(step, len(moves) - 1)
        return moves[i], V[i]

    def gate_motion_world(step: int):
        pts, vel = gate_motion_rel(step)
        return pts + origin, vel

    # one controller a flight: the t-solver's CUDA graph is captured once
    ctrl = ExternalSimController(
        model2,
        final_point=scen["final_point"],
        gate_motion=gate_motion_rel,
        w_rot=float(cfg.gate_w),
        origin=origin,
        variant=Variant.PYBULLET,
        fixed_point_tol=cfg.fixed_point_tol,
        device=device,
        dtype=dtype,
    )

    env = ValidationEnv(
        params=params,
        cfg=env_cfg or ValidationEnvConfig(sim_freq_hz=cfg.sim_freq_hz),
        gate_motion=gate_motion_world,
    )
    obs = env.reset(scen["start_point"] + origin, (0.0, 0.0, scen["yaw"]))

    logger = SimLogger()
    action = np.zeros(4)
    t_pred = 0.0
    states13, tick_s = [], []
    for i in range(n_steps):
        if i % ctrl_every == 0:
            t0 = time.perf_counter()
            action, t_pred = ctrl.compute_control(
                step=i,
                cur_pos=obs[0:3],
                cur_quat_xyzw=obs[3:7],
                cur_vel=obs[10:13],
                cur_euler_rates=obs[13:16],
                cur_rpy=obs[7:10],
            )
            tick_s.append(time.perf_counter() - t0)
        obs = env.step(action)
        states13.append(env.x.copy())
        logger.log(i / cfg.sim_freq_hz, obs, action, extra=t_pred)

    gate_world = [moves[min(i, len(moves) - 1)] + origin for i in range(n_steps)]
    crossed, margin = _traversal_metrics(
        np.asarray(states13), gate_world, scen["gate_width"], cfg.half_gate_height
    )
    final_dist = float(
        np.linalg.norm(env.x[0:3] - (scen["final_point"] + origin))
    )

    if output_folder:
        logger.save(output_folder)
        logger.save_as_csv(output_folder)
        if plot:
            logger.plot(output_folder)

    return {
        "scenario": scen,
        "logger": logger,
        "through_gate": crossed,
        "gate_margin": margin,
        "final_distance": final_dist,
        "states": np.asarray(states13),
        "tick_s": tick_s,
    }
