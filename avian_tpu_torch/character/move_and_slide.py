"""Kinematic character movement (port of
``avian_tpu/character/move_and_slide.py``, the reference's ``MoveAndSlide``,
``src/character_controller/move_and_slide.rs:19-36,464,745,868``):
depenetrate, then up to ``max_slides`` times cast the shape along the
velocity, move to the hit less the skin width and project the velocity on
the contact plane, sliding along the crease where two planes meet
(``velocity_project.rs:15,122``), then depenetrate again.

A call buckets the colliders by canonical shape pair once
(``queries/shapecast.py::cast_buckets``: one launch of Kernel E for the
poses, one sort and the call's one host read). Each slide is one cast,
Kernel S a bucket; each depenetration round is one launch a bucket of S's
manifold mode, its push summed in torch. Every branch is a ``torch.where``
and ``project_velocity``'s crease loop is unrolled, so with its position,
velocity, rotation and params on the card a call synchronises with the host
once.
"""

from dataclasses import dataclass

import numpy as np
import torch

from avian_tpu_torch.math import vec
from avian_tpu_torch.queries.filter import QueryFilter, collider_query_mask
from avian_tpu_torch.queries.shapecast import (cast_buckets, cast_query, first_hit,
                                               manifold_vs_all, sweep)


@dataclass(frozen=True)
class MoveAndSlideConfig:
    """Mirrors ``MoveAndSlideConfig``'s defaults (``move_and_slide.rs``)."""

    max_slides: int = 4
    skin_width: float = 0.01
    max_depenetration_iters: int = 2
    min_move_distance: float = 1e-5


def _device_floats(x, device):
    """``x`` as f32 on ``device``. Host values reach the card by fills of
    their elements, which copy nothing from the host and so do not
    synchronise with it (an element assignment or ``torch.tensor`` would)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    vals = np.asarray(x, dtype=np.float32)
    if device.type == "cpu":
        return torch.from_numpy(vals.copy())
    out = torch.empty(vals.shape, dtype=torch.float32, device=device)
    flat = out.reshape(-1)
    for k, v in enumerate(vals.reshape(-1).tolist()):
        flat[k].fill_(v)
    return out


def project_velocity(velocity, normal, prev_normals, num_prev):
    """Project ``velocity`` out of a contact plane, sliding along the crease
    where it then pushes into one of the first ``num_prev`` of
    ``prev_normals`` f32[K, 3] (reference :33, ``velocity_project.rs:122``)."""
    vn = torch.clamp(vec.dot(velocity, normal), max=0.0)
    v = velocity - vn[..., None] * normal
    zero = torch.zeros_like(normal)
    for k in range(prev_normals.shape[0]):
        p = prev_normals[k]
        into = vec.dot(v, p) < -1e-6
        crease = vec.normalize_or_rn(vec.cross(normal, p), zero)
        v_crease = crease * vec.dot(v, crease)[..., None]
        v = torch.where((k < num_prev) & into, v_crease, v)
    return v


def _depenetrate(plan, shape_type, prm, pos, quat, ok, iters, skin):
    """``iters`` rounds of the push out of every admitted collider (``ok``)
    that the shape overlaps or comes within ``skin`` of: the sum over them of
    ``skin - separation`` (at most 1) against each manifold's normal. The sum
    is taken in f64 and rounded once, so that the card and the CPU agree bit
    for bit whatever order their reductions add in."""
    zero3 = pos.new_zeros((3,))
    for _ in range(iters):
        query = cast_query(prm, pos, quat, zero3, pos.new_zeros(()), pos.device)
        sep, normal = manifold_vs_all(plan, shape_type, query)
        push = torch.where(ok & (sep < skin), skin - sep, 0.0)
        pushes = -normal * torch.clamp(push, max=1.0)[:, None]
        pos = pos + pushes.double().sum(0).to(torch.float32)
    return pos


def depenetrate(world, shape_type, params, pos, quat, qfilter: QueryFilter = None,
                iters: int = 2, skin: float = 0.01, shape_pairs=None):
    """Push the shape out of all overlapping colliders (reference :57,
    ``move_and_slide.rs:868``). Pool-backed colliders (hulls, round cuboids,
    the triangles of meshes and heightfields) are tested against their own
    vertices: the reference passes no vertex pool here and pushes nothing out
    of them (ROADMAP 3b)."""
    qfilter = qfilter if qfilter is not None else QueryFilter()
    dev = world.device
    plan = cast_buckets(world, shape_type, shape_pairs)
    ok = collider_query_mask(world.colliders, qfilter)
    prm, pos, quat = (_device_floats(x, dev) for x in (params, pos, quat))
    return _depenetrate(plan, int(shape_type), prm, pos, quat, ok, iters, skin)


def move_and_slide(world, shape_type, params, pos, quat, velocity, dt,
                   config: MoveAndSlideConfig = MoveAndSlideConfig(),
                   qfilter: QueryFilter = None):
    """Move a kinematic shape by ``velocity * dt``, sliding along surfaces
    (reference :95, ``move_and_slide.rs:464``). Returns ``(new_pos,
    new_velocity, last_normal)``, the last a zero vector where nothing
    blocked the move."""
    qfilter = qfilter if qfilter is not None else QueryFilter()
    dev = world.device
    st = int(shape_type)
    plan = cast_buckets(world, st)
    ok = collider_query_mask(world.colliders, qfilter)
    prm, quat, pos, velocity, remaining = (_device_floats(x, dev)
                                           for x in (params, quat, pos, velocity, dt))
    skin = config.skin_width
    pos = _depenetrate(plan, st, prm, pos, quat, ok, config.max_depenetration_iters, skin)

    k = config.max_slides
    lanes = torch.arange(k, device=dev)
    planes = torch.zeros((k, 3), dtype=torch.float32, device=dev)
    num_planes = torch.zeros((), dtype=torch.int32, device=dev)
    last_normal = torch.zeros((3,), dtype=torch.float32, device=dev)
    for _ in range(k):
        speed = vec.length_rn(velocity)
        move_dist = speed * remaining
        do_move = move_dist > config.min_move_distance
        direction = vec.normalize_or_rn(velocity, torch.zeros_like(velocity))
        query = cast_query(prm, pos, quat, direction, torch.clamp(move_dist, min=0.0), dev)
        hit = first_hit(world, *sweep(plan, st, query, ok))
        travel = torch.where(hit.hit, torch.clamp(hit.distance - skin, min=0.0), move_dist)
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
    pos = _depenetrate(plan, st, prm, pos, quat, ok, config.max_depenetration_iters, skin)
    return pos, velocity, last_normal
