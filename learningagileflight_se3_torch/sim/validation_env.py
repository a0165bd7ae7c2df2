"""The independent float64 validation plant (the PyBullet-env role).

The port's own copy of `learningagileflight_se3_tpu/sim/validation_env.py`
(numpy only; importing the original loads JAX through its package), held
equal to it bit for bit by tests/test_torch_validation.py.  A host-side
float64 rigid-body plant:

  * driven by the DynAviary action convention ``[T, tau_x, tau_y, tau_z]``
    (total body-z thrust + body torques), what
    ``ExternalSimController.compute_control`` emits;
  * integrated with RK4 substeps and quaternion renormalisation, a
    deliberately different discretisation from the solver's model (forward
    Euler, no renorm), so closed-loop success here is evidence of
    robustness, not of plant/model identity;
  * gravity 9.8 (PyBullet's constant) against the model's 9.78;
  * with optional mass/inertia mismatch for robustness sweeps.

Observations follow the gym-pybullet-drones 20-dim state vector:
``[pos(3), quat xyzw(4), rpy(3), vel(3), d_rpy(3), last_action(4)]``, index
13:16 carrying Euler-angle RATES.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np

from learningagileflight_se3_torch.config import QuadParams


@dataclasses.dataclass(frozen=True)
class ValidationEnvConfig:
    """Physics settings for the validation plant.

    Defaults mirror the reference's PyBullet runs: 100 Hz env steps
    (DEFAULT_SIMULATION_FREQ_HZ, Pybullet_simulation.py:42) with fine
    internal substeps, PyBullet gravity, and the hb.urdf thrust-to-weight 2
    actuator ceiling (model/hb.urdf properties line)."""

    sim_freq_hz: int = 100
    substeps: int = 10            # RK4 substeps per env step (1 kHz internal)
    g: float = 9.8                # plant gravity; training model uses 9.78
    thrust2weight: float = 2.0    # max total thrust = t2w * m * g
    mass_error: float = 0.0       # plant mass = (1 + mass_error) * model mass
    inertia_error: float = 0.0    # plant J = (1 + inertia_error) * model J
    clip_actions: bool = True

    @property
    def dt(self) -> float:
        return 1.0 / self.sim_freq_hz


def quat_to_rpy(q_wxyz: np.ndarray) -> np.ndarray:
    """wxyz quaternion -> extrinsic XYZ roll/pitch/yaw (PyBullet's
    getEulerFromQuaternion convention, used for obs slot 7:10)."""
    w, x, y, z = q_wxyz
    roll = np.arctan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    s = np.clip(2.0 * (w * y - z * x), -1.0, 1.0)
    pitch = np.arcsin(s)
    yaw = np.arctan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return np.array([roll, pitch, yaw])


def rpy_to_quat(rpy) -> np.ndarray:
    """roll/pitch/yaw -> wxyz quaternion (inverse of quat_to_rpy)."""
    r, p, y = np.asarray(rpy) * 0.5
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    return np.array(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ]
    )


def body_rates_to_euler_rates(omega_b: np.ndarray, rpy: np.ndarray) -> np.ndarray:
    """Body angular velocity -> Euler-angle rates: the exact inverse of the
    controller-side ``euler_rates_to_body`` (Yixiao_ctrl_wrapper.py:176-184),
    so the conversion round-trips bit-for-bit through the control loop."""
    roll, pitch = rpy[0], rpy[1]
    cr, sr = np.cos(roll), np.sin(roll)
    cp, tp = np.cos(pitch), np.tan(pitch)
    Q = np.array(
        [
            [1.0, sr * tp, cr * tp],
            [0.0, cr, -sr],
            [0.0, sr / cp, cr / cp],
        ]
    )
    return Q @ omega_b


def _quat_dcm_b2w(q: np.ndarray) -> np.ndarray:
    """Body->world direction cosine matrix from a wxyz quaternion."""
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


class ValidationEnv:
    """DynAviary-role plant: step with ``[T, tau_x, tau_y, tau_z]``.

    Internal state is the 13-vector ``[r, v, q_wxyz, omega_B]`` in float64.
    ``gate_motion`` (optional) is ``step -> (gate_pts (4,3), velocity (3,))``
    in WORLD coordinates; the env tracks gate pose for traversal detection
    (the GATE_ID pose query of Pybullet_simulation.py:183-186).
    """

    def __init__(
        self,
        params: QuadParams = QuadParams(),
        cfg: ValidationEnvConfig = ValidationEnvConfig(),
        gate_motion: Optional[Callable[[int], Tuple[np.ndarray, np.ndarray]]] = None,
    ):
        self.cfg = cfg
        self.model_params = params
        self.mass = params.mass * (1.0 + cfg.mass_error)
        self.J = np.array([params.Jx, params.Jy, params.Jz]) * (1.0 + cfg.inertia_error)
        self.gate_motion = gate_motion
        self.max_thrust = cfg.thrust2weight * self.mass * cfg.g
        # torque ceilings from the per-rotor bound and the mixer geometry
        # (quad_model.py:89-91): |tau_xy| <= u_ub * l / 2, |tau_z| <= 2 c u_ub
        u_ub = 2.44
        self.max_xy_torque = u_ub * params.l / 2.0
        self.max_z_torque = 2.0 * params.c * u_ub
        self.step_count = 0
        self.last_action = np.zeros(4)
        self.x = np.zeros(13)
        self.x[6] = 1.0

    # -- physics -----------------------------------------------------------

    def _ode(self, x: np.ndarray, thrust: float, tau: np.ndarray) -> np.ndarray:
        r, v, q, om = x[0:3], x[3:6], x[6:10], x[10:13]
        R = _quat_dcm_b2w(q)
        acc = R @ np.array([0.0, 0.0, thrust]) / self.mass - np.array(
            [0.0, 0.0, self.cfg.g]
        )
        w, xq, yq, zq = 0.0, om[0], om[1], om[2]
        # qdot = 1/2 * Omega(omega) * q
        qdot = 0.5 * np.array(
            [
                -xq * q[1] - yq * q[2] - zq * q[3],
                xq * q[0] + zq * q[2] - yq * q[3],
                yq * q[0] - zq * q[1] + xq * q[3],
                zq * q[0] + yq * q[1] - xq * q[2],
            ]
        )
        omdot = (tau - np.cross(om, self.J * om)) / self.J
        return np.concatenate([v, acc, qdot, omdot])

    def _rk4(self, x: np.ndarray, thrust: float, tau: np.ndarray, h: float) -> np.ndarray:
        k1 = self._ode(x, thrust, tau)
        k2 = self._ode(x + 0.5 * h * k1, thrust, tau)
        k3 = self._ode(x + 0.5 * h * k2, thrust, tau)
        k4 = self._ode(x + h * k3, thrust, tau)
        x = x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        x[6:10] /= np.linalg.norm(x[6:10])
        return x

    # -- gym-style API -------------------------------------------------------

    def reset(self, init_xyz, init_rpy=(0.0, 0.0, 0.0)) -> np.ndarray:
        self.step_count = 0
        self.last_action = np.zeros(4)
        self.x = np.zeros(13)
        self.x[0:3] = np.asarray(init_xyz, dtype=np.float64)
        self.x[6:10] = rpy_to_quat(init_rpy)
        return self.state20()

    def step(self, action) -> np.ndarray:
        """Advance one env step (1/sim_freq seconds) under a held
        thrust/torque command. Returns the 20-dim observation."""
        a = np.asarray(action, dtype=np.float64)
        thrust, tau = a[0], a[1:4].copy()
        if self.cfg.clip_actions:
            thrust = float(np.clip(thrust, 0.0, self.max_thrust))
            tau[0] = np.clip(tau[0], -self.max_xy_torque, self.max_xy_torque)
            tau[1] = np.clip(tau[1], -self.max_xy_torque, self.max_xy_torque)
            tau[2] = np.clip(tau[2], -self.max_z_torque, self.max_z_torque)
        h = self.cfg.dt / self.cfg.substeps
        for _ in range(self.cfg.substeps):
            self.x = self._rk4(self.x, thrust, tau, h)
        self.step_count += 1
        self.last_action = a
        return self.state20()

    def state20(self) -> np.ndarray:
        """gym-pybullet-drones state vector:
        [pos(3), quat xyzw(4), rpy(3), vel(3), d_rpy(3), last_action(4)]."""
        q = self.x[6:10]
        rpy = quat_to_rpy(q)
        d_rpy = body_rates_to_euler_rates(self.x[10:13], rpy)
        return np.concatenate(
            [
                self.x[0:3],
                q[[1, 2, 3, 0]],  # wxyz -> xyzw (PyBullet order)
                rpy,
                self.x[3:6],
                d_rpy,
                self.last_action,
            ]
        )

    def gate_points(self, step: Optional[int] = None) -> Optional[np.ndarray]:
        if self.gate_motion is None:
            return None
        pts, _ = self.gate_motion(self.step_count if step is None else step)
        return np.asarray(pts)

    def gate_crossed(self) -> bool:
        """Traversal heuristic of the reference's simulation script: vehicle y beyond the
        gate's y minus 0.3 m (Pybullet_simulation.py:183-186)."""
        pts = self.gate_points()
        if pts is None:
            return False
        return bool(self.x[1] > float(np.mean(pts[:, 1])) - 0.3)
