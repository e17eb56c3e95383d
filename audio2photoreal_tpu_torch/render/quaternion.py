"""Batched quaternion algebra, (x, y, z, w) convention.

Counterpart of ``audio2photoreal_tpu/render/quaternion.py`` (reference:
visualize/ca_body/utils/quaternion.py): mul, rotate, invert,
from-Euler-XYZ, to-matrix, normalize.  All functions broadcast over leading
batch dims; quaternions live in the trailing dim of size 4.
"""

from __future__ import annotations

import torch


def mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 ⊗ q2 (reference batchMul)."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def invert(q: torch.Tensor) -> torch.Tensor:
    """Unit-quaternion inverse = conjugate (reference batchInvert)."""
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v by quaternions q (reference batchRot):
    v' = v + w·t + qv × t with t = 2·qv × v."""
    qv, v = torch.broadcast_tensors(q[..., :3], v)
    w = q[..., 3:4]
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + w * t + torch.linalg.cross(qv, t, dim=-1)


def from_xyz(euler: torch.Tensor) -> torch.Tensor:
    """Euler XYZ (radians) → quaternion q = qz ⊗ qy ⊗ qx (reference
    batchFromXYZ), each axis from its half angle."""
    half = euler * 0.5
    c, s = torch.cos(half), torch.sin(half)
    zeros = torch.zeros_like(c[..., 0])
    qx = torch.stack([s[..., 0], zeros, zeros, c[..., 0]], dim=-1)
    qy = torch.stack([zeros, s[..., 1], zeros, c[..., 1]], dim=-1)
    qz = torch.stack([zeros, zeros, s[..., 2], c[..., 2]], dim=-1)
    return mul(qz, mul(qy, qx))


def to_matrix(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] → [..., 3, 3] rotation matrix (column-vector convention)."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(eps)
