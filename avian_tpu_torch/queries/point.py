"""Point queries: projection and containment (port of
``avian_tpu/queries/point.py``, ``SpatialQuery::project_point`` /
``point_intersections``).

``all_point_hits`` projects P points onto every collider: the colliders are
bucketed by shape type with one sort and one host read, and each bucket is
one launch of Kernel AF (``kernels/point_3d.py``) for all the points. A point
inside a pool-backed convex shape's inner hull is found by an exact test and
reports distance ``-radius`` and itself as the closest point, where the
reference's Frank-Wolfe map reports it outside (ROADMAP 3b).
"""

import torch

from avian_tpu_torch.core.types import ShapeType
from avian_tpu_torch.kernels import point_3d as kaf
from avian_tpu_torch.pipeline.broadphase import collider_poses
from avian_tpu_torch.queries.filter import QueryFilter, collider_query_mask

BIG = kaf.BIG


def point_kinds(world) -> torch.Tensor:
    """i64[M]: each collider's Kernel AF instance: its shape type, ``MISS``
    for triangles and for CONVEX shapes in a world without a vertex pool (the
    reference's default branch there). Raises for the TRIMESH and
    HEIGHTFIELD codes, which the builder never writes."""
    st = world.colliders.shape_type.long()
    if bool((st > int(ShapeType.CONVEX)).any()):
        raise NotImplementedError("point queries against raw TRIMESH/HEIGHTFIELD codes are not "
                                  "ported (the builder makes CONVEX triangles)")
    miss = st == int(ShapeType.TRIANGLE)
    if world.convex_verts.shape[0] <= 1:
        miss = miss | (st == int(ShapeType.CONVEX))
    return torch.where(miss, kaf.MISS, st)


def all_point_hits(world, points, work=None):
    """``(distance f32[P, M], closest point f32[P, M, 3], inside bool[P, M])``
    of the P points ``points`` f32[P, 3] against every collider, unfiltered:
    negative distances inside, ``BIG`` for the shapes a point query never
    meets. ``work``: see ``kernels.point_3d.point_3d``."""
    col = world.colliders
    dev = world.device
    m = col.capacity
    pos, quat = collider_poses(world)
    kinds = point_kinds(world)
    counts = torch.bincount(kinds, minlength=kaf.CONVEX + 1).tolist()
    order = torch.argsort(kinds, stable=True).to(torch.int32)
    pts = torch.as_tensor(points, dtype=torch.float32).to(dev).reshape(-1, 3).contiguous()
    p_n = pts.shape[0]
    dist = torch.empty((p_n, m), dtype=torch.float32, device=dev)
    closest = torch.empty((p_n, m, 3), dtype=torch.float32, device=dev)
    inside = torch.empty((p_n, m), dtype=torch.bool, device=dev)
    args = (pos.contiguous(), quat.contiguous(), col.params.contiguous(),
            world.convex_verts.contiguous())
    start = 0
    for kind, count in enumerate(counts):
        if count:
            kaf.point_3d(kind, order[start:start + count].contiguous(), pts, *args, dist, closest,
                         inside, work)
        start += count
    return dist, closest, inside


def first_true(mask, width):
    """i32[..., width]: the indices where ``mask`` [..., M] holds, ascending,
    padded with -1 (``lax.top_k`` of a 0/1 score puts the lower index first
    among equals; a width past M pads too)."""
    m = mask.shape[-1]
    k = min(width, m)
    idx = torch.sort((~mask).to(torch.int8), dim=-1, stable=True)[1][..., :k]
    out = torch.where(mask.gather(-1, idx), idx, -1).to(torch.int32)
    if k < width:
        out = torch.cat([out, out.new_full(out.shape[:-1] + (width - k,), -1)], -1)
    return out


def project_point(world, point, solid=True, qfilter: QueryFilter = None):
    """(collider, body, point_on_collider, is_inside, distance, hit) of the
    collider closest to ``point``; with ``solid`` a point inside a collider
    projects onto itself at key 0."""
    qfilter = qfilter if qfilter is not None else QueryFilter()
    point = torch.as_tensor(point, dtype=torch.float32).to(world.device)
    col = world.colliders
    dist, cpts, inside = (x[0] for x in all_point_hits(world, point[None]))
    ok = collider_query_mask(col, qfilter)
    key = torch.where(ok, torch.where(inside & solid, 0.0, dist.abs()), BIG)
    i = torch.argmin(key)  # the first of equals
    hit = key[i] < BIG
    return {
        "collider": torch.where(hit, i, -1).to(torch.int32),
        "body": torch.where(hit, col.body_idx[i], -1).to(torch.int32),
        "point": torch.where(inside[i] & solid, point, cpts[i]),
        "is_inside": inside[i] & hit,
        "distance": torch.where(hit, dist[i], float("inf")),
        "hit": hit,
    }


def point_intersections(world, point, max_hits: int = 8, qfilter: QueryFilter = None):
    """i32[max_hits]: the colliders containing ``point`` (distance <= 0 or
    inside), lowest index first, padded with -1."""
    qfilter = qfilter if qfilter is not None else QueryFilter()
    point = torch.as_tensor(point, dtype=torch.float32).to(world.device)
    dist, _, inside = all_point_hits(world, point[None])
    contains = collider_query_mask(world.colliders, qfilter) & (inside[0] | (dist[0] <= 0.0))
    return first_true(contains, max_hits)
