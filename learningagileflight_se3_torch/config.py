"""Typed configuration, mirroring `learningagileflight_se3_tpu/config.py`.

The JAX package's `config.py` imports `jax.numpy`, so the port cannot import
it on a machine without JAX.  These are field-for-field copies of its frozen
dataclasses, with the same defaults (a CPU test holds
every default equal to the JAX package's).  See the JAX module for the
reference citations of each value.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple


class Variant(enum.Enum):
    """Fork deltas of the reference, exposed as config instead of file copies."""

    MAIN = "main"          # top-level files of the reference
    PYBULLET = "pybullet"  # gym_pybullet_drone/ fork


@dataclasses.dataclass(frozen=True)
class QuadParams:
    """Physical parameters of the quadrotor."""

    Jx: float = 0.0023
    Jy: float = 0.0023
    Jz: float = 0.004
    mass: float = 0.5
    l: float = 0.35       # arm length
    c: float = 0.0245     # torque coefficient
    g: float = 9.78       # gravity


@dataclasses.dataclass(frozen=True)
class CostWeights:
    """Weights of the gate-traversal optimal-control cost."""

    wrt: float = 5.0       # traversal position
    wqt: float = 80.0      # traversal attitude
    wthrust: float = 0.1   # thrust magnitude
    wrf: float = 5.0       # goal position (path + final)
    wvf: float = 5.0       # goal velocity
    wqf: float = 0.0       # goal attitude
    wwf: float = 3.0       # angular-rate
    w_du: float = 1.0      # control-rate smoothing |u_k - u_{k-1}|^2
    # Gaussian traversal-time window: amp * exp(-decay*(dt*k - t)^2)
    tra_amp: float = 60.0
    tra_decay: float = 10.0
    # traversal attitude term squared (MAIN) or linear (PYBULLET)
    squared_attitude: bool = True


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Batched DDP solver configuration (see the JAX module for each knob's
    measured rationale)."""

    horizon: int = 50
    dt: float = 0.1
    u_lb: float = 0.0
    u_ub: float = 2.44          # PYBULLET: 2.4
    w_bound: float = 1.5707963267948966   # omega in [-pi/2, pi/2]
    w_bound_weight: float = 0.0  # soft omega-bound penalty weight (0 = off)
    max_iters: int = 64
    tol: float = 1e-9           # relative cost-decrease tolerance
    gtol: float = 1e-7          # relative projected-gradient (KKT) tolerance
    stall_gtol: float = 1e-4    # loose KKT gate for the 'stalled' exit
    use_ddp: bool = True        # second-order dynamics terms (full DDP)
    reg_init: float = 1.0
    reg_min: float = 1e-8
    reg_max: float = 1e8
    reg_shrink: float = 0.5
    reg_grow: float = 8.0
    boxqp_iters: int = 6
    line_search_steps: int = 14
    ls_adaptive: bool = False   # warm-start backtracking at last index - 1
    ls_max_trips: int = 14      # alpha evaluations per iteration
    no_progress_iters: int = 0  # progress-window termination (0 = off)
    quantize_t: bool = True     # round traversal time to 0.1 s
    backward: str = "sequential"  # read only by the JAX single-problem solver


@dataclasses.dataclass(frozen=True)
class RewardConfig:
    """Trajectory reward."""

    collision_weight: float = 1000.0
    path_weight: float = 0.5
    reward_offset: float = 100.0
    d_min: float = 0.2         # safety margin inside the gate
    wing_len: float = 1.5      # rotor-tip span used for collision
    n_path_points: int = 4     # terminal points entering the path term


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Scenario sampler ranges."""

    init_pos_halfwidth: float = 5.0
    init_pos_offset: Tuple[float, float, float] = (0.0, -9.0, 0.0)
    final_pos_halfwidth: float = 2.0
    final_pos_offset: Tuple[float, float, float] = (0.0, 6.0, 0.0)
    yaw_halfwidth: float = 0.1            # PYBULLET: pi/6
    width_mean: float = 0.9
    width_std: float = 0.3                # PYBULLET: 0.2
    width_clip: Tuple[float, float] = (0.5, 1.25)   # PYBULLET: (0.8, 1.5)
    gate_half_height: float = 1.0


@dataclasses.dataclass(frozen=True)
class GateMotionConfig:
    """Moving-gate kinematics."""

    velocity: Tuple[float, float, float] = (1.0, 0.3, 0.4)
    omega_y: float = 1.5707963267948966   # pi/2 rad/s pitch rate
    noise_std: float = 0.1
    noise_clip: float = 0.1               # PYBULLET: 0.2
    sim_T: float = 5.0
    sim_dt: float = 0.01


@dataclasses.dataclass(frozen=True)
class LearnedGradConfig:
    """Finite-difference learning-signal semantics (probe step, clip and
    the per-coordinate scales; the analytic signal applies the same trust
    region)."""

    delta: float = 1e-3
    clip: float = 0.5
    pos_scale: float = 0.1
    # angle grads scaled by 1/(500*a_i^2 + 5)
    ang_scale_a: float = 500.0
    ang_scale_b: float = 5.0
    t_probe: float = 0.1
    t_step: float = 0.05
    t_threshold: float = 2.0


def preset(variant: Variant = Variant.MAIN):
    """Return (QuadParams, CostWeights, SolverConfig, RewardConfig,
    SamplerConfig, GateMotionConfig) for a reference variant."""
    if variant == Variant.MAIN:
        return (
            QuadParams(),
            CostWeights(),
            SolverConfig(),
            RewardConfig(),
            SamplerConfig(),
            GateMotionConfig(),
        )
    return (
        QuadParams(),
        CostWeights(squared_attitude=False),
        SolverConfig(u_ub=2.4),
        RewardConfig(),
        SamplerConfig(
            yaw_halfwidth=0.5235987755982988,  # pi/6
            width_std=0.2,
            width_clip=(0.8, 1.5),
        ),
        GateMotionConfig(noise_clip=0.2),
    )
