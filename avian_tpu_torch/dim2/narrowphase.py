"""2D narrowphase: rounded-convex-polygon manifolds, at most 2 points a pair
(port of ``avian_tpu/dim2/narrowphase.py``).

One function covers every 2D shape pair: ``compute_manifold_2d`` runs Kernel
V (``kernels/manifold_2d.py``) over a batch of collider pairs. Conventions
are the reference's: the normal points from a to b, a negative separation
penetrates, ``point_a``/``point_b`` lie on each shape's surface, and unused
points carry separation 1e9.
"""

import torch

from avian_tpu_torch.kernels import manifold_2d as kv
from avian_tpu_torch.kernels.manifold_2d import Manifold2D

__all__ = ["Manifold2D", "compute_manifold_2d", "rotate"]


def rotate(c, s, v):
    """``v`` [..., 2] rotated by the angle of cosine ``c`` and sine ``s``."""
    return torch.stack([c * v[..., 0] - s * v[..., 1], s * v[..., 0] + c * v[..., 1]], -1)


def compute_manifold_2d(ca, cb, pos, cs, colliders) -> Manifold2D:
    """Manifolds of the collider pairs ``(ca[k], cb[k])`` (i64[K]) at the
    colliders' world positions ``pos`` f32[M, 2] and the cosines and sines
    of their world angles ``cs`` f32[M, 2]."""
    col = colliders
    return kv.manifold_2d(ca.contiguous(), cb.contiguous(), pos.contiguous(), cs.contiguous(),
                          col.poly_verts, col.vert_count, col.radius, col.is_plane)
