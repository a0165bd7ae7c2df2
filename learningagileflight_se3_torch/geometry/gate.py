"""Gate (narrow window) kinematics on tensors.

Port of `learningagileflight_se3_tpu/geometry/gate.py`.  Corners are
(..., 4, 3), ordered [top-left, top-right, bottom-right, bottom-left];
states are (..., 13).  The gate
frame R_wg (world -> window) has rows [ax, ay, az] with az = [0,0,1],
ay = normalize(cross(p1-p0, p2-p1)) and ax = cross(ay, az), deliberately
not normalized, as in the reference.
"""

from __future__ import annotations

import torch

from learningagileflight_se3_torch.core.rotations import dcm_to_quat, quat_to_dcm_w2b


def gate_from_width(width, pitch=None, half_height: float = 1.0):
    """Corners of a gate of `width` (...) at the origin, optionally pitched
    by `pitch` (...) radians about its y axis."""
    w2 = width / 2.0
    z = torch.zeros_like(w2)
    h = torch.full_like(w2, half_height)
    pts = torch.stack(
        [
            torch.stack([-w2, z, h], dim=-1),
            torch.stack([w2, z, h], dim=-1),
            torch.stack([w2, z, -h], dim=-1),
            torch.stack([-w2, z, -h], dim=-1),
        ],
        dim=-2,
    )
    if pitch is not None:
        pts = rotate_y(pts, pitch)
    return pts


def gate_centroid(pts):
    return pts.mean(dim=-2)


def gate_frame(pts):
    """R_wg: world -> window rotation, rows [ax, ay, az] (ax unnormalized)."""
    zero = torch.zeros_like(pts[..., 0, 0])
    az = torch.stack([zero, zero, zero + 1.0], dim=-1)  # no host scalar: capturable in a CUDA graph
    n = torch.linalg.cross(pts[..., 1, :] - pts[..., 0, :], pts[..., 2, :] - pts[..., 1, :], dim=-1)
    ay = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    ax = torch.linalg.cross(ay, az, dim=-1)
    return torch.stack([ax, ay, az], dim=-2)


def gate_width(pts):
    """|p0 - p1|."""
    return torch.linalg.vector_norm(pts[..., 0, :] - pts[..., 1, :], dim=-1)


def gate_pitch(pts):
    """atan((p0z - p1z)/(p0x - p1x)), the real-time pitch estimate."""
    return torch.atan((pts[..., 0, 2] - pts[..., 1, 2]) / (pts[..., 0, 0] - pts[..., 1, 0]))


def rotate_y(pts, angle):
    """Rotate corners about the centroid in the x-z plane."""
    c = gate_centroid(pts)
    rel = pts - c[..., None, :]
    ca, sa = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    x = ca * rel[..., 0] - sa * rel[..., 2]
    z = sa * rel[..., 0] + ca * rel[..., 2]
    return torch.stack([x, rel[..., 1], z], dim=-1) + c[..., None, :]


def rotate_z(pts, angle):
    """Rotate corners about the centroid in the x-y plane."""
    c = gate_centroid(pts)
    rel = pts - c[..., None, :]
    ca, sa = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    x = ca * rel[..., 0] - sa * rel[..., 1]
    y = sa * rel[..., 0] + ca * rel[..., 1]
    return torch.stack([x, y, rel[..., 2]], dim=-1) + c[..., None, :]


def translate(pts, displacement):
    return pts + displacement[..., None, :]


def transform_state_to_window(pts, state):
    """13-state world -> window frame."""
    R_wg = gate_frame(pts)
    c = gate_centroid(pts)
    r = (R_wg @ (state[..., 0:3] - c)[..., None])[..., 0]
    v = (R_wg @ state[..., 3:6, None])[..., 0]
    R_b2w = quat_to_dcm_w2b(state[..., 6:10]).transpose(-1, -2)
    q = dcm_to_quat(R_wg @ R_b2w)
    return torch.cat([r, v, q, state[..., 10:13]], dim=-1)


def final_to_window(pts, final_point):
    """Goal point world -> window frame."""
    return (gate_frame(pts) @ (final_point - gate_centroid(pts))[..., None])[..., 0]


def window_inputs(pts, state, final_point):
    """The 18-dim DNN2 input: [state(13) in window frame, final(3) in window
    frame, width, pitch]."""
    return torch.cat(
        [
            transform_state_to_window(pts, state),
            final_to_window(pts, final_point),
            gate_width(pts)[..., None],
            gate_pitch(pts)[..., None],
        ],
        dim=-1,
    )


def gate_move(pts, generator, v, w, T: float = 5.0, dt: float = 0.01,
              noise_std: float = 0.1, noise_clip: float = 0.1, noise=None):
    """Moving-gate trajectory: per step, rotate about y by dt*w around the
    current centroid, then translate by dt*(v + eps), eps the clipped Gaussian
    clip(noise_std * N(0,1), +-noise_clip) of shape (..., n, 3), n = int(T/dt).

    `pts` (..., 4, 3), `v` (3,) or (..., 3), `w` a number.  eps is drawn from
    `generator` (on its device), or is `noise` where the caller made it.
    Returns (moves (..., n+1, 4, 3), V (..., n+1, 3))."""
    n = int(T / dt)
    v = torch.as_tensor(v, dtype=pts.dtype, device=pts.device).expand(pts.shape[:-2] + (3,))
    if noise is None:
        raw = torch.randn(pts.shape[:-2] + (n, 3), generator=generator, dtype=pts.dtype,
                          device=generator.device).to(pts.device)
        noise = torch.clamp(noise_std * raw, -noise_clip, noise_clip)
    angle = torch.as_tensor(w * dt, dtype=pts.dtype, device=pts.device)
    moves, V = [pts], [v]
    for k in range(n):
        vel = v + noise[..., k, :]
        moves.append(translate(rotate_y(moves[-1], angle), dt * vel))
        V.append(vel)
    return torch.stack(moves, dim=-3), torch.stack(V, dim=-2)
