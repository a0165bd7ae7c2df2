"""PyBullet validation harness: the same control stack flown in an
externally authored physics engine (reference
gym_pybullet_drone/Pybullet_simulation.py:60-218 + GateAviary.py:18-285).

Port of `learningagileflight_se3_tpu/sim/pybullet_harness.py`.
`sim/validation_env.py` is an independent plant, but a self-authored one:
a shared misconception in dynamics or conventions would pass it.  This
module flies the identical deployed stack (`sim/external_controller.py`
`ExternalSimController`, the Yixiao_ctrl_wrapper.computeControl role)
inside Bullet whenever `pybullet` is importable.  Importing this module
never imports pybullet; `run_pybullet_sim` raises an ImportError naming it
where it is absent.

Design notes, as in the JAX module:
  * the wrapper's wrench [T, tau_x, tau_y, tau_z] (Yixiao_ctrl_wrapper.py:136)
    is applied to the base link with applyExternalForce/Torque in the link
    frame, gym-pybullet-drones' DynAviary "dynamics" contract without its
    wrapper stack;
  * the vehicle is the generated `assets/hb.urdf`, whose mass, inertia and
    arm are held against `config.QuadParams` by the tests: Bullet
    integrates its own rigid-body dynamics from them;
  * the moving gate is a physical Bullet body (physical_gate=True): a
    per-scenario window URDF (`utils/urdf.window_urdf`, the opening sized to
    the sampled gate) loaded fixed-base and moved kinematically to the
    gate's corner trajectory every physics step (GateAviary.py:135-230), and
    the engine's contact events between quad and frame are returned beside
    the analytic window-frame margin.

The tick runs on `device` (the card by default, `device="cpu"` for the
CPU), the plant and the metrics on the host.  The gate moves as the
validation flight's does (`sim/validation_sim.py gate_trajectory`: the
port's `gate_move` with a seeded `torch.Generator` and the PyBullet fork's
noise clip of 0.2).
"""

from __future__ import annotations

import importlib
import os
import tempfile
from typing import Optional

import numpy as np

from learningagileflight_se3_torch.config import QuadParams, Variant
from learningagileflight_se3_torch.sim.external_controller import ExternalSimController
from learningagileflight_se3_torch.sim.validation_sim import (
    ValidationSimConfig,
    _traversal_metrics,
    gate_trajectory,
    sample_validation_scenario,
)
from learningagileflight_se3_torch.utils.device import resolve_device
from learningagileflight_se3_torch.utils.urdf import window_urdf

_ASSETS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "assets",
)


def _corners_to_pose(pts):
    """(4,3) corner array -> (centroid, R columns [x y z], quat xyzw) of the
    window body whose URDF opening lies in its local x-z plane (corner
    order [top-left, top-right, bottom-right, bottom-left],
    geometry/gate.gate_from_width)."""
    pts = np.asarray(pts, dtype=np.float64)
    c = pts.mean(axis=0)
    x_ax = pts[1] - pts[0]
    x_ax = x_ax / np.linalg.norm(x_ax)
    z_ax = pts[0] - pts[3]
    z_ax = z_ax / np.linalg.norm(z_ax)
    y_ax = np.cross(z_ax, x_ax)
    R = np.stack([x_ax, y_ax, z_ax], axis=1)  # columns = body axes in world
    # rotation matrix -> quaternion (w,x,y,z), Shepperd's method
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                      (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k]) * 2
        q = np.zeros(4)
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
    return c, q[[1, 2, 3, 0]]  # xyzw for Bullet


def _require_pybullet():
    try:
        return importlib.import_module("pybullet")
    except ImportError as e:  # pragma: no cover - environment-dependent
        raise ImportError(
            "pybullet is not installed; the PyBullet validation harness "
            "needs it (pip install pybullet). The recorded-replay contract "
            "test covers the same control stack without it."
        ) from e


def run_pybullet_sim(
    model2,
    cfg: ValidationSimConfig = ValidationSimConfig(),
    params: QuadParams = QuadParams(),
    seed: int = 0,
    gui: bool = False,
    urdf: Optional[str] = None,
    replay_file: Optional[str] = None,
    physical_gate: bool = True,
    device="cuda",
) -> dict:
    """Fly DNN2 + MPC closed-loop in Bullet.  Mirrors run_validation_sim's
    loop (100 Hz physics / 10 Hz control) and return dict, so the two
    harnesses are drop-in comparable.

    `model2` is the DNN2 `nn.Module` with its weights (the JAX function's
    `model2, nn2_params` pair, as in the port's `run_validation_sim`); the
    tick runs on `device`.  The gate moves as
    `gate_trajectory(scenario, cfg, seed)` says.

    physical_gate=True loads the window frame as a Bullet body and records
    engine contact events in the returned dict ("contacts": list of
    (step, world position, normal force), "n_contact_steps")."""
    p = _require_pybullet()
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

    origin = np.asarray(cfg.gate_origin, dtype=np.float64)
    n_steps = int(cfg.duration_sec * cfg.sim_freq_hz)
    ctrl_every = int(cfg.sim_freq_hz // cfg.ctrl_freq_hz)
    dt = 1.0 / cfg.sim_freq_hz

    # gate trajectory in the relative frame (PyBullet fork noise clip 0.2)
    moves, V = gate_trajectory(scen, cfg, seed)

    def gate_motion_rel(step: int):
        i = min(step, len(moves) - 1)
        return moves[i], V[i]

    ctrl = ExternalSimController(
        model2,
        final_point=scen["final_point"],
        gate_motion=gate_motion_rel,
        w_rot=float(cfg.gate_w),
        origin=origin,
        variant=Variant.PYBULLET,
        fixed_point_tol=cfg.fixed_point_tol,
        device=device,
    )

    # ---- Bullet world ----
    client = p.connect(p.GUI if gui else p.DIRECT)
    try:
        p.setGravity(0.0, 0.0, -params.g, physicsClientId=client)
        p.setTimeStep(dt, physicsClientId=client)
        start_world = np.asarray(scen["start_point"]) + origin
        q0_xyzw = p.getQuaternionFromEuler([0.0, 0.0, scen["yaw"]])
        body = p.loadURDF(
            urdf or os.path.join(_ASSETS, "hb.urdf"),
            basePosition=start_world.tolist(),
            baseOrientation=q0_xyzw,
            physicsClientId=client,
        )
        # Bullet damps rigid bodies by default; the reference model has none
        p.changeDynamics(body, -1, linearDamping=0.0, angularDamping=0.0,
                         physicsClientId=client)

        gate_body = None
        if physical_gate:
            # per-scenario window URDF (opening sized to the sampled gate),
            # loaded fixed-base and repositioned kinematically every step —
            # the GateAviary.py:60-104 gate-as-obstacle mechanism
            with tempfile.NamedTemporaryFile(
                "w", suffix="_window.urdf", delete=False
            ) as f:
                f.write(window_urdf(float(scen["gate_width"]),
                                    float(cfg.half_gate_height)))
                gate_urdf_path = f.name
            c0, q0g = _corners_to_pose(moves[0] + origin)
            gate_body = p.loadURDF(
                gate_urdf_path, basePosition=c0.tolist(),
                baseOrientation=q0g.tolist(), useFixedBase=True,
                physicsClientId=client,
            )
            os.unlink(gate_urdf_path)

        action = np.zeros(4)
        t_pred = 0.0
        states13 = []
        contacts = []
        for i in range(n_steps):
            pos, quat_xyzw = p.getBasePositionAndOrientation(
                body, physicsClientId=client)
            vel_w, omega_w = p.getBaseVelocity(body, physicsClientId=client)
            rpy = np.asarray(p.getEulerFromQuaternion(quat_xyzw))
            R = np.asarray(
                p.getMatrixFromQuaternion(quat_xyzw)).reshape(3, 3)
            omega_b = R.T @ np.asarray(omega_w)
            # euler rates from body rates: d_rpy = Q(rpy) @ omega_b — the
            # adapter inverts this transform (angu_vel_tran_w2b)
            roll, pitch = rpy[0], rpy[1]
            Q_inv = np.array(
                [[1.0, 0.0, -np.sin(pitch)],
                 [0.0, np.cos(roll), np.sin(roll) * np.cos(pitch)],
                 [0.0, -np.sin(roll), np.cos(roll) * np.cos(pitch)]]
            )
            d_rpy = np.linalg.solve(Q_inv, omega_b)

            if i % ctrl_every == 0:
                action, t_pred = ctrl.compute_control(
                    step=i,
                    cur_pos=np.asarray(pos),
                    cur_quat_xyzw=np.asarray(quat_xyzw),
                    cur_vel=np.asarray(vel_w),
                    cur_euler_rates=d_rpy,
                    cur_rpy=rpy,
                )

            # DynAviary dynamics-mode actuation: thrust along body +z,
            # torques in the body frame (GateAviary/DynAviary contract)
            p.applyExternalForce(
                body, -1, forceObj=[0.0, 0.0, float(action[0])],
                posObj=[0.0, 0.0, 0.0], flags=p.LINK_FRAME,
                physicsClientId=client)
            p.applyExternalTorque(
                body, -1, torqueObj=[float(action[1]), float(action[2]),
                                     float(action[3])],
                flags=p.LINK_FRAME, physicsClientId=client)
            if gate_body is not None:
                ci, qi = _corners_to_pose(
                    moves[min(i, len(moves) - 1)] + origin)
                p.resetBasePositionAndOrientation(
                    gate_body, ci.tolist(), qi.tolist(),
                    physicsClientId=client)
            p.stepSimulation(physicsClientId=client)
            if gate_body is not None:
                for cp in p.getContactPoints(
                        bodyA=body, bodyB=gate_body, physicsClientId=client):
                    # cp[5] = position on A (world), cp[9] = normal force
                    contacts.append((i, tuple(cp[5]), float(cp[9])))

            pos, quat_xyzw = p.getBasePositionAndOrientation(
                body, physicsClientId=client)
            vel_w, omega_w = p.getBaseVelocity(body, physicsClientId=client)
            R = np.asarray(p.getMatrixFromQuaternion(quat_xyzw)).reshape(3, 3)
            q = np.asarray(quat_xyzw)[[3, 0, 1, 2]]
            states13.append(np.concatenate(
                [np.asarray(pos), np.asarray(vel_w), q,
                 R.T @ np.asarray(omega_w)]))
    finally:
        p.disconnect(physicsClientId=client)

    states13 = np.asarray(states13)
    gate_world = [moves[min(i, len(moves) - 1)] + origin
                  for i in range(n_steps)]
    crossed, margin = _traversal_metrics(
        states13, gate_world, scen["gate_width"], cfg.half_gate_height)
    final_dist = float(np.linalg.norm(
        states13[-1, 0:3] - (np.asarray(scen["final_point"]) + origin)))
    return {
        "scenario": scen,
        "through_gate": crossed,
        "gate_margin": margin,
        "final_distance": final_dist,
        "states": states13,
        "engine": "pybullet",
        "physical_gate": bool(physical_gate),
        "contacts": contacts,
        "n_contact_steps": len({c[0] for c in contacts}),
    }
