"""Plots and the flight animation (host-side matplotlib over numpy arrays).

The port's own copy of `learningagileflight_se3_tpu/sim/plotting.py`
(importing the original loads JAX through its package): position,
velocity, quaternion, angular-rate, input and thrust/torque plots of a
trajectory, and a 3D animation of a flight.  Every function takes numpy
arrays (a log fetched off the device).  matplotlib is imported lazily, in
`_plt`, so that nothing that does not plot needs it.
"""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def quadrotor_positions(state_traj, wing_len: float):
    """(T, 15): center + 4 rotor tips per step (get_quadrotor_position,
    quad_model.py:239-276; X-configuration tips)."""
    a = wing_len * 0.5 / np.sqrt(2.0)
    tips_B = np.array([[a, a, 0], [-a, a, 0], [-a, -a, 0], [a, -a, 0]])
    T = state_traj.shape[0]
    out = np.zeros((T, 15))
    for t in range(T):
        r = state_traj[t, 0:3]
        w, x, y, z = state_traj[t, 6:10]
        C_B_I = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y + w * z), 2 * (x * z - w * y)],
                [2 * (x * y - w * z), 1 - 2 * (x * x + z * z), 2 * (y * z + w * x)],
                [2 * (x * z + w * y), 2 * (y * z - w * x), 1 - 2 * (x * x + y * y)],
            ]
        )
        out[t, 0:3] = r
        for i in range(4):
            out[t, 3 + 3 * i : 6 + 3 * i] = r + C_B_I.T @ tips_B[i]
    return out


def plot_position(state_traj, dt=0.1, path=None):
    plt = _plt()
    fig, axs = plt.subplots(3, sharex=True)
    fig.suptitle("position vs t")
    ts = np.arange(state_traj.shape[0]) * dt
    for i, lab in enumerate("xyz"):
        axs[i].plot(ts, state_traj[:, i])
        axs[i].set_ylabel(lab)
    axs[2].set_xlabel("t [s]")
    if path:
        fig.savefig(path, dpi=150)
    plt.close(fig)
    return path


def plot_velocity(state_traj, dt=0.1, path=None):
    plt = _plt()
    fig, axs = plt.subplots(3, sharex=True)
    fig.suptitle("velocity vs t")
    ts = np.arange(state_traj.shape[0]) * dt
    for i in range(3):
        axs[i].plot(ts, state_traj[:, 3 + i])
    if path:
        fig.savefig(path, dpi=150)
    plt.close(fig)
    return path


def plot_quaternions(state_traj, dt=0.1, path=None):
    plt = _plt()
    fig, axs = plt.subplots(4, sharex=True)
    fig.suptitle("quaternions vs t")
    ts = np.arange(state_traj.shape[0]) * dt
    for i in range(4):
        axs[i].plot(ts, state_traj[:, 6 + i])
    if path:
        fig.savefig(path, dpi=150)
    plt.close(fig)
    return path


def plot_angular_rate(state_traj, dt=0.01, path=None):
    plt = _plt()
    fig = plt.figure()
    ts = np.arange(state_traj.shape[0]) * dt
    for i, (c, lab) in enumerate(zip("bry", ("w1", "w2", "w3"))):
        plt.plot(ts, state_traj[:, 10 + i], color=c, label=lab)
    plt.title("angular rate vs time")
    plt.xlabel("t")
    plt.ylabel("w")
    plt.grid(True, color="0.6", dashes=(2, 2, 1, 1))
    plt.legend()
    if path:
        fig.savefig(path, dpi=150)
    plt.close(fig)
    return path


def plot_input(control_traj, dt=0.1, path=None):
    plt = _plt()
    fig = plt.figure()
    ts = np.arange(control_traj.shape[0]) * dt
    for i, c in enumerate("bryg"):
        plt.plot(ts, control_traj[:, i], color=c, label=f"u{i+1}")
    plt.title("input vs time")
    plt.xlabel("t")
    plt.ylabel("u")
    plt.grid(True, color="0.6", dashes=(2, 2, 1, 1))
    plt.legend()
    if path:
        fig.savefig(path, dpi=150)
    plt.close(fig)
    return path


def plot_thrust_torque(torque_traj, dt=0.01, path=None):
    """[T, Mx, My, Mz] logs (plot_T / plot_M, quad_model.py:605-632)."""
    plt = _plt()
    fig, axs = plt.subplots(2, sharex=True)
    ts = np.arange(torque_traj.shape[0]) * dt
    axs[0].plot(ts, torque_traj[:, 0], label="T")
    axs[0].legend()
    for i, lab in enumerate(("Mx", "My", "Mz")):
        axs[1].plot(ts, torque_traj[:, 1 + i], label=lab)
    axs[1].legend()
    if path:
        fig.savefig(path, dpi=150)
    plt.close(fig)
    return path


def animate_flight(
    state_traj,
    gate_traj=None,
    goal=None,
    wing_len: float = 1.5,
    dt: float = 0.01,
    path: str = "flight.mp4",
    fps: int = 25,
    stride: int = 4,
):
    """3D flight animation (play_animation, quad_model.py:309-540): quadrotor
    arms + trajectory + (optionally) the moving gate. Saves MP4 if ffmpeg is
    available, else falls back to a GIF via pillow."""
    plt = _plt()
    from matplotlib import animation

    pos = quadrotor_positions(state_traj, wing_len)
    frames = range(0, pos.shape[0], stride)

    fig = plt.figure(figsize=(6, 5))
    ax = fig.add_subplot(111, projection="3d")
    ax.set_xlim(-6, 6)
    ax.set_ylim(-9, 9)
    ax.set_zlim(-5, 5)
    ax.set_xlabel("X (m)")
    ax.set_ylabel("Y (m)")
    ax.set_zlabel("Z (m)")
    if goal is not None:
        ax.plot([goal[0]], [goal[1]], [goal[2]], c="r", marker="o", markersize=3)
    ax.view_init(25, -150)

    (line_traj,) = ax.plot([], [], [], linewidth=0.7)
    arms = [ax.plot([], [], [], linewidth=1, color=c, marker="o", markersize=1)[0]
            for c in ("red", "blue", "orange", "green")]
    gate_lines = [ax.plot([], [], [], linewidth=1, color="red")[0] for _ in range(4)]
    time_text = ax.text2D(0.15, 0.85, "", transform=ax.transAxes)

    def update(num):
        line_traj.set_data(pos[:num, 0], pos[:num, 1])
        line_traj.set_3d_properties(pos[:num, 2])
        cx, cy, cz = pos[num, 0:3]
        for i, arm in enumerate(arms):
            rx, ry, rz = pos[num, 3 + 3 * i : 6 + 3 * i]
            arm.set_data_3d([cx, rx], [cy, ry], [cz, rz])
        if gate_traj is not None:
            g = gate_traj[min(num, gate_traj.shape[0] - 1)]
            for i, gl in enumerate(gate_lines):
                j = (i + 1) % 4
                gl.set_data_3d([g[i, 0], g[j, 0]], [g[i, 1], g[j, 1]], [g[i, 2], g[j, 2]])
        time_text.set_text(f"time = {num * dt:.2f}s")
        return [line_traj, *arms, *gate_lines, time_text]

    ani = animation.FuncAnimation(fig, update, frames=frames, blit=True)
    try:
        ani.save(path, writer=animation.FFMpegWriter(fps=fps))
    except Exception:
        path = path.rsplit(".", 1)[0] + ".gif"
        ani.save(path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return path
