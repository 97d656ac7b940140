"""Vector helpers over trailing-axis tensors (port of ``avian_tpu/math/vec.py``).

Every function takes tensors whose last axis is the vector dimension and
broadcasts over leading axes. Sums over the three components are written
out in a fixed order, ``(x + y) + z``, so that the CUDA kernels, which
spell the same sums out by hand, round the same way.
"""

import torch

_EPS = 1e-12


def dot(a, b):
    """Dot product along the last axis."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    """3D cross product along the last axis (broadcasts)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def length_sq(a):
    return dot(a, a)


def length(a):
    return torch.sqrt(length_sq(a))


def normalize_or(a, fallback):
    """Normalize; returns ``fallback`` where the input norm is ~0."""
    n2 = length_sq(a)
    ok = n2 > _EPS
    inv = torch.where(ok, 1.0 / torch.sqrt(torch.clamp(n2, min=_EPS)), 0.0)
    return torch.where(ok[..., None], a * inv[..., None], fallback)


def clamp_length_max(a, max_len):
    """Clamp the vector length to at most ``max_len`` (broadcasts)."""
    n2 = length_sq(a)
    max2 = max_len * max_len
    scale = torch.where(
        n2 > max2, max_len / torch.sqrt(torch.clamp(n2, min=_EPS)), 1.0
    )
    return a * scale[..., None]


def any_orthonormal(n):
    """A unit vector orthogonal to unit vector ``n`` (Duff et al. 2017)."""
    z = n[..., 2]
    sign = torch.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = n[..., 0] * n[..., 1] * a
    return torch.stack(
        [1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0]],
        dim=-1,
    )


def mv3(m, v):
    """``[..., 3, 3] @ [..., 3]`` as written-out multiply-adds."""
    return (
        m[..., :, 0] * v[..., None, 0]
        + m[..., :, 1] * v[..., None, 1]
        + m[..., :, 2] * v[..., None, 2]
    )


def mtv3(m, v):
    """Transposed product ``m^T @ v``."""
    return (
        m[..., 0, :] * v[..., 0, None]
        + m[..., 1, :] * v[..., 1, None]
        + m[..., 2, :] * v[..., 2, None]
    )


def safe_recip(x):
    """1/x, returning 0 where x == 0."""
    return torch.where(x != 0.0, 1.0 / torch.where(x == 0.0, 1.0, x), 0.0)
