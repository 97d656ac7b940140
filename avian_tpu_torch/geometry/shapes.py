"""Collider AABBs (port of ``avian_tpu/geometry/shapes.py:24-83``) for the
shapes the port supports: spheres, capsules, boxes, half-spaces, cylinders,
cones, segments and pool-backed convex shapes (hulls, round cuboids,
triangles), plus the zero-size sphere that padded collider slots carry."""

import torch

from avian_tpu_torch.core.types import ShapeType
from avian_tpu_torch.math import quat as quat_m
from avian_tpu_torch.math import vec

# Half-extent used for "infinite" shapes (half-spaces); such colliders go to
# the broadphase's dense global pass.
BIG = 1.0e9


def local_aabb_half_extents(shape_type, params):
    """Local-frame AABB half extents ``f32[..., 3]``."""
    r = params[..., 0]
    half = torch.stack([r, r, r], dim=-1)  # sphere (and padding) default
    # Capsule, cylinder, cone: params = (half height along local Y, radius).
    ch, cr = params[..., 0], params[..., 1]
    capsule = torch.stack([cr, ch + cr, cr], dim=-1)
    cyl = torch.stack([cr, ch, cr], dim=-1)
    box = params[..., :3]
    plane = torch.full_like(box, BIG)
    zero = torch.zeros_like(r)
    seg = torch.stack([r, zero, zero], dim=-1)  # segment on local X
    convex = params[..., 2:5]  # the builder's precomputed half extents
    st = shape_type[..., None]
    out = torch.where(st == ShapeType.CAPSULE, capsule, half)
    out = torch.where(st == ShapeType.BOX, box, out)
    out = torch.where((st == ShapeType.CYLINDER) | (st == ShapeType.CONE), cyl, out)
    out = torch.where(st == ShapeType.SEGMENT, seg, out)
    out = torch.where(st == ShapeType.CONVEX, convex, out)
    return torch.where(st == ShapeType.PLANE, plane, out)


def world_aabb(shape_type, params, pos, quat):
    """World AABB via ``|R| @ h`` on the local box (sphere unrotated)."""
    h = local_aabb_half_extents(shape_type, params)
    m = torch.abs(quat_m.to_mat3(quat))
    world_h = vec.mv3(m, h)
    r = params[..., 0]
    sphere_h = torch.stack([r, r, r], dim=-1)
    is_sphere = (shape_type == ShapeType.SPHERE)[..., None]
    world_h = torch.where(is_sphere, sphere_h, world_h)
    return pos - world_h, pos + world_h
