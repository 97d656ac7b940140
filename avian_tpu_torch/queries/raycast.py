"""Ray casts against the collider set (port of
``avian_tpu/queries/raycast.py``, ``SpatialQuery::cast_ray`` /
``ray_hits``): each ray in each collider's frame, Parry's ``solid``
semantics (a ray that starts inside a solid shape hits at 0 with normal
``-direction``); segments and triangles are never hit.

The colliders are bucketed by shape type with one sort and one host read,
and each bucket is one launch of Kernel T (``kernels/ray_cast.py``) for all
the rays at once; the colliders of each of the world's custom shapes are one
launch of Kernel AJ (``kernels/custom_shapes.py::ray_support``), whose hits
``first_hits``' argmin and ``ray_hits``' top-k take with T's. ``cast_ray``
and ``ray_hits`` cast one.
"""

from dataclasses import dataclass, fields

import torch

from avian_tpu_torch.core.types import ShapeType
from avian_tpu_torch.kernels import custom_shapes as kcs
from avian_tpu_torch.kernels import ray_cast as kt
from avian_tpu_torch.math import vec
from avian_tpu_torch.pipeline.broadphase import collider_poses
from avian_tpu_torch.queries.filter import QueryFilter, collider_query_mask
from avian_tpu_torch.queries.shapecast import nearest

BIG = kt.BIG
CUSTOM = kt.CONVEX + 1  # the kind of a custom collider: Kernel AJ's, no T bucket


@dataclass(frozen=True)
class RayHit:
    """Mirrors ``RayHitData``; fields carry a leading ``max_hits`` axis from
    ``ray_hits``."""

    collider: torch.Tensor  # i32, -1 = miss
    body: torch.Tensor      # i32
    distance: torch.Tensor  # f32
    point: torch.Tensor     # f32[3]
    normal: torch.Tensor    # f32[3]
    hit: torch.Tensor       # bool


def ray_kinds(world) -> torch.Tensor:
    """i64[M]: each collider's Kernel T instance: its shape type, ``MISS`` for
    segments and triangles (and for CONVEX shapes in a world without a
    vertex pool, as the reference lowers no convex branch there), ``CUSTOM``
    for a custom shape's collider, which T never takes. Raises for the
    TRIMESH and HEIGHTFIELD codes, which the builder never writes, and for a
    custom code that names none of the world's custom shapes."""
    st, custom = kcs.custom_codes(world.colliders.shape_type, len(world.custom_shapes),
                                  "ray casts")
    miss = (st == int(ShapeType.SEGMENT)) | (st == int(ShapeType.TRIANGLE))
    if world.convex_verts.shape[0] <= 1:
        miss = miss | (st == int(ShapeType.CONVEX))
    return torch.where(custom, CUSTOM, torch.where(miss, kt.MISS, st))


def all_hits(world, origins, directions, solid, qfilter: QueryFilter):
    """``(t f32[R, M], normal f32[R, M, 3])`` of R rays (origins and unit
    directions f32[R, 3]) against every collider; ``t`` = ``BIG`` where
    missed or filtered out."""
    col = world.colliders
    dev = world.device
    m, r_n = col.capacity, origins.shape[0]
    pos, quat = collider_poses(world)
    ok = collider_query_mask(col, qfilter)
    kinds = ray_kinds(world)
    counts = torch.bincount(kinds, minlength=CUSTOM + 1).tolist()[:CUSTOM]
    order = torch.argsort(kinds, stable=True).to(torch.int32)
    rays = torch.cat([origins, directions], 1).to(device=dev, dtype=torch.float32).contiguous()
    t = torch.empty((r_n, m), dtype=torch.float32, device=dev)
    n = torch.empty((r_n, m, 3), dtype=torch.float32, device=dev)
    args = (pos.contiguous(), quat.contiguous(), col.params.contiguous(),
            world.convex_verts.contiguous())
    start = 0
    for kind, count in enumerate(counts):
        if count:
            kt.ray_cast(kind, order[start:start + count].contiguous(), rays, solid, *args, t, n)
        start += count
    shapes = tuple(world.custom_shapes)
    if shapes:
        corder, spans = kcs.buckets(col.shape_type, shapes)
        for code, a, b in spans:
            kcs.ray_support(shapes, code, corder[a:b].contiguous(), rays, solid, *args[:3], t, n)
    return torch.where(ok[None, :], t, BIG), n


def _ray(origin, direction):
    o = torch.as_tensor(origin, dtype=torch.float32)
    d = vec.normalize_or_rn(torch.as_tensor(direction, dtype=torch.float32),
                            torch.tensor([1.0, 0.0, 0.0]))
    return o, d


def first_hits(world, origins, directions, max_distance=BIG, solid=True,
               qfilter: QueryFilter = None) -> RayHit:
    """The first hit of each of R rays (origins and unit directions f32[R,
    3]) from one ``all_hits`` call: a ``RayHit`` with a leading [R] axis, the
    lower collider index first among equal distances."""
    qfilter = qfilter if qfilter is not None else QueryFilter()
    t, n = all_hits(world, origins, directions, solid, qfilter)
    t = torch.where(t <= max_distance, t, BIG)
    i = torch.argmin(t, dim=1)  # the first of equals
    rows = torch.arange(t.shape[0], device=t.device)
    ti = t[rows, i]
    hit = ti < BIG
    o = origins.to(device=world.device, dtype=torch.float32)
    d = directions.to(device=world.device, dtype=torch.float32)
    return RayHit(
        collider=torch.where(hit, i, -1).to(torch.int32),
        body=torch.where(hit, world.colliders.body_idx[i], -1).to(torch.int32),
        distance=torch.where(hit, ti, float("inf")),
        point=o + d * torch.where(hit, ti, 0.0)[:, None], normal=n[rows, i], hit=hit,
    )


def cast_ray(world, origin, direction, max_distance=BIG, solid=True,
             qfilter: QueryFilter = None) -> RayHit:
    """First hit along the ray."""
    o, d = _ray(origin, direction)
    hits = first_hits(world, o[None], d[None], max_distance, solid, qfilter)
    return RayHit(*(getattr(hits, f.name)[0] for f in fields(RayHit)))


def ray_hits(world, origin, direction, max_hits: int, max_distance=BIG, solid=True,
             qfilter: QueryFilter = None) -> RayHit:
    """Up to ``max_hits`` nearest hits, by distance; a ``RayHit`` with a
    leading ``max_hits`` axis, misses padded with ``hit`` False."""
    qfilter = qfilter if qfilter is not None else QueryFilter()
    o, d = _ray(origin, direction)
    t, n = all_hits(world, o[None], d[None], solid, qfilter)
    t, n = t[0], n[0]
    t = torch.where(t <= max_distance, t, BIG)
    idx, tk, hit = nearest(t, min(max_hits, world.colliders.capacity), max_hits)
    o, d = o.to(world.device), d.to(world.device)
    return RayHit(
        collider=torch.where(hit, idx, -1).to(torch.int32),
        body=torch.where(hit, world.colliders.body_idx[idx], -1).to(torch.int32),
        distance=torch.where(hit, tk, float("inf")),
        point=o[None, :] + d[None, :] * torch.where(hit, tk, 0.0)[:, None],
        normal=n[idx], hit=hit,
    )
