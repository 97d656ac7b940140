"""Quaternion math on trailing-axis ``[..., 4]`` tensors, layout ``(x, y, z, w)``
(port of ``avian_tpu/math/quat.py``). Identity is ``(0, 0, 0, 1)``."""

import torch

from avian_tpu_torch.math import vec


def identity(shape=(), device=None):
    q = torch.zeros(tuple(shape) + (4,), dtype=torch.float32, device=device)
    q[..., 3] = 1.0
    return q


def mul(q1, q2):
    """Hamilton product ``q1 * q2`` (apply q2 first, then q1)."""
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def conj(q):
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def rotate(q, v):
    """Rotate ``v`` by ``q``: ``v + w*t + cross(u, t)`` with
    ``t = 2 * cross(u, v)``."""
    u = q[..., :3]
    w = q[..., 3:4]
    t = vec.cross(u, v) * 2.0
    return v + w * t + vec.cross(u, t)


def rotate_inv(q, v):
    """Rotate ``v`` by the inverse of unit quaternion ``q``."""
    return rotate(conj(q), v)


def from_scaled_axis(v):
    """Quaternion from a rotation vector (axis * angle), with the first-order
    Taylor form for tiny angles."""
    angle_sq = vec.length_sq(v)
    angle = torch.sqrt(torch.clamp(angle_sq, min=1e-30))
    small = angle_sq < 1e-12
    half = 0.5 * angle
    s = torch.where(small, 0.5 - angle_sq / 48.0, torch.sin(half) / angle)
    w = torch.where(small, 1.0 - angle_sq / 8.0, torch.cos(half))
    return torch.cat([v * s[..., None], w[..., None]], dim=-1)


def to_mat3(q):
    """Rotation matrix ``[..., 3, 3]`` from quaternion."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    x2, y2, z2 = x + x, y + y, z + z
    xx, yy, zz = x * x2, y * y2, z * z2
    xy, xz, yz = x * y2, x * z2, y * z2
    wx, wy, wz = w * x2, w * y2, w * z2
    m = torch.stack(
        [
            1.0 - (yy + zz), xy - wz, xz + wy,
            xy + wz, 1.0 - (xx + zz), yz - wx,
            xz - wy, yz + wx, 1.0 - (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def fast_renormalize(q):
    """First-order renormalization (one Newton step)."""
    n2 = (
        q[..., 0] * q[..., 0] + q[..., 1] * q[..., 1]
        + q[..., 2] * q[..., 2] + q[..., 3] * q[..., 3]
    )
    return q * (0.5 * (3.0 - n2))[..., None]
