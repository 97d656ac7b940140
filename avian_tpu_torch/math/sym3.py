"""Symmetric 3x3 tensors stored as ``[..., 6]`` = (xx, yy, zz, xy, xz, yz)
(port of ``avian_tpu/math/sym3.py``)."""

import torch

XX, YY, ZZ, XY, XZ, YZ = 0, 1, 2, 3, 4, 5


def mv(s, v):
    """Matrix-vector product of the symmetric tensor with ``v``."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    rx = s[..., XX] * x + s[..., XY] * y + s[..., XZ] * z
    ry = s[..., XY] * x + s[..., YY] * y + s[..., YZ] * z
    rz = s[..., XZ] * x + s[..., YZ] * y + s[..., ZZ] * z
    return torch.stack([rx, ry, rz], dim=-1)


def to_mat(s):
    row0 = torch.stack([s[..., XX], s[..., XY], s[..., XZ]], dim=-1)
    row1 = torch.stack([s[..., XY], s[..., YY], s[..., YZ]], dim=-1)
    row2 = torch.stack([s[..., XZ], s[..., YZ], s[..., ZZ]], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def from_mat(m):
    return torch.stack(
        [m[..., 0, 0], m[..., 1, 1], m[..., 2, 2],
         m[..., 0, 1], m[..., 0, 2], m[..., 1, 2]],
        dim=-1,
    )


def rotate(s, rot_mat):
    """Congruence transform ``R S R^T`` as written-out multiply-adds."""
    m = to_mat(s)
    # tmp[i, j] = sum_k R[i, k] S[k, j]
    tmp = (
        rot_mat[..., :, 0, None] * m[..., None, 0, :]
        + rot_mat[..., :, 1, None] * m[..., None, 1, :]
        + rot_mat[..., :, 2, None] * m[..., None, 2, :]
    )
    # out[i, j] = sum_k tmp[i, k] R[j, k]
    out = (
        tmp[..., :, None, 0] * rot_mat[..., None, :, 0]
        + tmp[..., :, None, 1] * rot_mat[..., None, :, 1]
        + tmp[..., :, None, 2] * rot_mat[..., None, :, 2]
    )
    return from_mat(out)


def inverse_or_zero(s):
    """Closed-form inverse via the adjugate; a singular tensor maps to 0."""
    a, b, c = s[..., XX], s[..., YY], s[..., ZZ]
    d, e, f = s[..., XY], s[..., XZ], s[..., YZ]
    ca = b * c - f * f
    cb = a * c - e * e
    cc = a * b - d * d
    cd = e * f - d * c
    ce = d * f - e * b
    cf = d * e - a * f
    det = a * ca + d * cd + e * ce
    inv_det = torch.where(
        det != 0.0, 1.0 / torch.where(det == 0.0, 1.0, det), 0.0
    )
    return torch.stack([ca, cb, cc, cd, ce, cf], dim=-1) * inv_det[..., None]
