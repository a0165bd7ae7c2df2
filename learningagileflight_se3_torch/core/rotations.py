"""Quaternion / rotation math on tensors (wxyz convention).

Port of `learningagileflight_se3_tpu/core/rotations.py`.  Every function is
batched over leading dimensions: a quaternion is (..., 4), a 3-vector
(..., 3), a matrix (..., 3, 3).
"""

from __future__ import annotations

import torch


def normalize(v, eps: float = 0.0):
    """Unit vector v/|v| over the last axis.  No epsilon by default, as in the
    reference; pass eps for a safe derivative at 0."""
    return v / torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True) + eps)


def skew(v):
    """Cross-product matrix of v (..., 3), (..., 3, 3)."""
    a, b, c = v.unbind(-1)
    z = torch.zeros_like(a)
    rows = [[z, -c, b], [c, z, -a], [-b, a, z]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def quat_to_dcm_w2b(q):
    """C_B_I: world -> body direction cosine matrix, (..., 3, 3).
    Not normalized internally, as in the reference."""
    w, x, y, z = q.unbind(-1)
    entries = [
        1 - 2 * (y * y + z * z), 2 * (x * y + w * z), 2 * (x * z - w * y),
        2 * (x * y - w * z), 1 - 2 * (x * x + z * z), 2 * (y * z + w * x),
        2 * (x * z + w * y), 2 * (y * z - w * x), 1 - 2 * (x * x + y * y),
    ]
    return torch.stack(entries, dim=-1).unflatten(-1, (3, 3))


def quat_to_dcm_b2w(q):
    """C_I_B: body -> world rotation matrix (transpose of C_B_I)."""
    return quat_to_dcm_w2b(q).transpose(-1, -2)


def omega_matrix(w):
    """4x4 Omega(w) with q_dot = 0.5 * Omega(w) q, (..., 4, 4)."""
    a, b, c = w.unbind(-1)
    z = torch.zeros_like(a)
    rows = [
        [z, -a, -b, -c],
        [a, z, c, -b],
        [b, -c, z, a],
        [c, b, -a, z],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def quat_mul(p, q):
    """Hamilton product, wxyz."""
    p0, p1, p2, p3 = p.unbind(-1)
    q0, q1, q2, q3 = q.unbind(-1)
    return torch.stack(
        [
            p0 * q0 - p1 * q1 - p2 * q2 - p3 * q3,
            p0 * q1 + p1 * q0 + p2 * q3 - p3 * q2,
            p0 * q2 - p1 * q3 + p2 * q0 + p3 * q1,
            p0 * q3 + p1 * q2 - p2 * q1 + p3 * q0,
        ],
        dim=-1,
    )


def quat_conj(q):
    """Quaternion conjugate [w, -x, -y, -z]."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def axis_angle_to_quat(angle, axis):
    """Unit quaternion from (angle (...), axis (..., 3)); axis normalized."""
    axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    half = angle / 2.0
    return torch.cat([torch.cos(half)[..., None], torch.sin(half)[..., None] * axis], dim=-1)


def rodrigues_to_axis_angle(w):
    """The reference's Rd2Rp: theta = 2*atan(|w|), axis = (w + [1e-8,0,0]) / |...|;
    the tiny x offset regularises the direction at zero rotation.
    Returns (theta (...), axis (..., 3))."""
    theta = 2.0 * torch.atan(torch.linalg.vector_norm(w, dim=-1))
    reg = w + torch.tensor([1e-8, 0.0, 0.0], dtype=w.dtype, device=w.device)
    return theta, reg / torch.linalg.vector_norm(reg, dim=-1, keepdim=True)


def rodrigues_to_quat(w):
    """The reference's Rd2Rp -> toQuaternion composition in closed form:
    theta/2 = atan(|w|) gives cos = 1/sqrt(1+|w|^2), sin*axis = w/sqrt(1+|w|^2).

    The smooth form without the reference's 1e-8 axis regulariser, as the
    JAX package uses it (values agree with the composition within 1.5e-8)."""
    s = 1.0 / torch.sqrt(1.0 + torch.sum(w * w, dim=-1, keepdim=True))
    return torch.cat([s, s * w], dim=-1)


def dcm_to_quat(R):
    """Rotation matrix (body -> world, (..., 3, 3)) -> unit quaternion wxyz.

    Branch-free Shepperd form: all four candidates are built and the
    best-conditioned one is selected (first maximum, as jnp.argmax)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    qw2 = torch.clamp_min(1.0 + tr, 0.0)
    qx2 = torch.clamp_min(1.0 + m00 - m11 - m22, 0.0)
    qy2 = torch.clamp_min(1.0 - m00 + m11 - m22, 0.0)
    qz2 = torch.clamp_min(1.0 - m00 - m11 + m22, 0.0)

    cands = torch.stack(
        [
            torch.stack([qw2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
            torch.stack([m21 - m12, qx2, m01 + m10, m02 + m20], dim=-1),
            torch.stack([m02 - m20, m01 + m10, qy2, m12 + m21], dim=-1),
            torch.stack([m10 - m01, m02 + m20, m12 + m21, qz2], dim=-1),
        ],
        dim=-2,
    )  # (..., 4 candidates, 4)
    mags = torch.stack([qw2, qx2, qy2, qz2], dim=-1)
    idx = torch.argmax(mags, dim=-1, keepdim=True)
    q = torch.gather(cands, -2, idx[..., None].expand(*idx.shape[:-1], 1, 4))[..., 0, :]
    mag = torch.gather(mags, -1, idx)
    q = q / (2.0 * torch.sqrt(torch.clamp_min(mag, 1e-12)))
    # canonical sign: w >= 0
    return torch.where(q[..., :1] < 0, -q, q)
