"""Quaternion / rotation math on tensors (wxyz convention).

Port of `learningagileflight_se3_tpu/core/rotations.py`.  Every function is
batched over leading dimensions: a quaternion is (..., 4), a 3-vector
(..., 3), a matrix (..., 3, 3).
"""

from __future__ import annotations

import torch


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


def axis_angle_to_quat(angle, axis):
    """Unit quaternion from (angle (...), axis (..., 3)); axis normalized."""
    axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    half = angle / 2.0
    return torch.cat([torch.cos(half)[..., None], torch.sin(half)[..., None] * axis], dim=-1)


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
