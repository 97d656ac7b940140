"""2D kinematic character movement (port of ``avian_tpu/dim2/character.py``,
the reference's ``MoveAndSlide`` on the 2D engine): depenetrate, then up to
``max_slides`` times cast the shape along the velocity, move to the hit less
the skin width and project the velocity on the contact line, then
depenetrate again. Two contact lines meet in a corner in 2D, so a slid
velocity that still pushes into an earlier line stops.

Each cast is one launch of Kernel AE (``dim2/queries.py::cast_shape``), each
depenetration round one 0-round launch of it; every branch of a slide is a
``torch.where`` on the world's device, so a move reads nothing back to the
host.
"""

from dataclasses import dataclass

import torch

from avian_tpu_torch.dim2.queries import cast_shape, manifold_vs_all, vec
from avian_tpu_torch.kernels.manifold_2d import dot2, normalize
from avian_tpu_torch.math.vec import sqrt_rn
from avian_tpu_torch.queries.filter import QueryFilter, collider_query_mask


@dataclass(frozen=True)
class MoveAndSlideConfig2D:
    """Mirrors ``MoveAndSlideConfig``'s defaults (``move_and_slide.rs``)."""

    max_slides: int = 4
    skin_width: float = 0.01
    max_depenetration_iters: int = 2
    min_move_distance: float = 1e-5


def project_velocity(velocity, normal, prev_normals, num_prev):
    """``velocity`` slid along the contact line of ``normal``, and stopped
    where it then points into one of the first ``num_prev`` of
    ``prev_normals`` f32[K, 2] (reference :32, ``velocity_project.rs:122``
    read in 2D)."""
    vn = torch.clamp(dot2(velocity, normal), max=0.0)
    v = velocity - vn * normal
    for k in range(prev_normals.shape[0]):
        into = dot2(v, prev_normals[k]) < -1e-6
        v = torch.where((k < num_prev) & into, torch.zeros_like(v), v)
    return v


def depenetrate(world, shape, pos, angle=0.0, qfilter: QueryFilter = None, iters: int = 2,
                skin: float = 0.01):
    """``pos`` pushed out of every collider the shape overlaps or comes
    within ``skin`` of (reference :47, ``move_and_slide.rs:868``): each round
    moves it by the sum over the colliders of ``skin - separation`` (at most
    1) against each manifold's normal."""
    qfilter = qfilter if qfilter is not None else QueryFilter()
    ok = collider_query_mask(world.colliders, qfilter)
    p = vec(world, pos)
    for _ in range(iters):
        m = manifold_vs_all(world, shape, p, angle)
        push = torch.where(ok & (m.sep < skin), skin - m.sep, 0.0)
        p = p + (-m.normal * torch.clamp(push, max=1.0)[:, None]).sum(0)
    return p


def move_and_slide(world, shape, pos, velocity, dt, angle=0.0,
                   config: MoveAndSlideConfig2D = MoveAndSlideConfig2D(),
                   qfilter: QueryFilter = None):
    """Move the kinematic ``shape`` (a triple of ``dim2/queries.py``) from
    ``pos`` by ``velocity * dt``, sliding along what it meets (reference :78,
    ``move_and_slide.rs:464``). Returns ``(new_pos, new_velocity,
    last_normal)``, the last a zero vector where nothing blocked the move."""
    qfilter = qfilter if qfilter is not None else QueryFilter()
    velocity = vec(world, velocity)
    pos = depenetrate(world, shape, pos, angle, qfilter, config.max_depenetration_iters,
                      config.skin_width)
    k = config.max_slides
    lanes = torch.arange(k, device=world.device)
    planes = torch.zeros((k, 2), dtype=torch.float32, device=world.device)
    num_planes = torch.zeros((), dtype=torch.int32, device=world.device)
    remaining = vec(world, dt)
    last_normal = torch.zeros((2,), dtype=torch.float32, device=world.device)
    for _ in range(k):
        speed = sqrt_rn(dot2(velocity, velocity))
        move_dist = speed * remaining
        do_move = move_dist > config.min_move_distance
        direction = torch.where(speed > 1e-9, normalize(velocity), 0.0)
        hit = cast_shape(world, shape, pos, angle, direction, torch.clamp(move_dist, min=0.0),
                         qfilter)
        travel = torch.where(hit.hit, torch.clamp(hit.distance - config.skin_width, min=0.0),
                             move_dist)
        travel = torch.where(do_move, travel, 0.0)
        pos = pos + direction * travel
        used = torch.where(speed > 1e-9, travel / torch.clamp(speed, min=1e-9), 0.0)
        remaining = torch.clamp(remaining - used, min=0.0)

        blocked = hit.hit & do_move
        n = hit.normal
        velocity = torch.where(blocked, project_velocity(velocity, n, planes, num_planes),
                               velocity)
        slot = (lanes == torch.clamp(num_planes, max=k - 1)) & blocked
        planes = torch.where(slot[:, None], n, planes)
        num_planes = num_planes + blocked.to(torch.int32)
        last_normal = torch.where(blocked, n, last_normal)
    pos = depenetrate(world, shape, pos, angle, qfilter, config.max_depenetration_iters,
                      config.skin_width)
    return pos, velocity, last_normal
