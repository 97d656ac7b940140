"""2D spatial queries (port of ``avian_tpu/dim2/queries.py``, the reference's
``SpatialQuery`` surface on the 2D engine): ray casts, point projections,
AABB and shape intersections, shape casts and their predicate variants.

Every 2D collider is a rounded convex polygon (at most 8 vertices and a
radius) or a half-space, so one kernel serves every shape for each kind of
query:

- rays are Kernel AC (``kernels/ray_cast_2d.py``), the exact first hit on
  the union of the core polygon, a disk a vertex and a rectangle an edge, R
  rays in one launch (``all_ray_hits``; ``cast_ray`` and ``ray_hits`` cast
  one);
- points are Kernel AD (``kernels/point_2d.py``), the signed distance to the
  rounded surface and the closest surface point;
- shape casts are Kernel AE (``kernels/shape_cast_2d.py``), 24 rounds of
  conservative advancement on Kernel V's manifold of the query shape and each
  collider; its 0-round launch is the manifold of the shape at its pose,
  which ``shape_intersections`` and the character's depenetration read.

AABB intersections are a mask over the stored AABBs. Filters are the 3D
``QueryFilter`` (``queries/filter.py``, a layer mask and excluded
colliders), as in the reference; the predicate variants fold a user mask
function into it. The selections are the reference's: the first index among
equal distances, and ``lax.top_k``'s order (the lower index first among
equal scores) by a stable sort. A query shape is a ``(verts f32[8, 2],
count i32[], radius f32[])`` triple from ``shape_circle``, ``shape_capsule``,
``shape_polygon`` or ``shape_rect``, built on the card unless ``device=``
says otherwise; every query runs on its world's device.
"""

from dataclasses import dataclass

import numpy as np
import torch

from avian_tpu_torch.core.device import resolve
from avian_tpu_torch.dim2.broadphase import collider_poses
from avian_tpu_torch.dim2.state import MAX_POLY_VERTS
from avian_tpu_torch.kernels import point_2d as kad
from avian_tpu_torch.kernels import ray_cast_2d as kac
from avian_tpu_torch.kernels import shape_cast_2d as kae
from avian_tpu_torch.kernels.manifold_2d import normalize
from avian_tpu_torch.queries.filter import QueryFilter, collider_query_mask, with_predicate
from avian_tpu_torch.queries.shapecast import nearest

BIG = kac.BIG  # a miss (reference ``_BIG``)

__all__ = [
    "shape_circle", "shape_capsule", "shape_polygon", "shape_rect", "RayHit2D", "ShapeHit2D",
    "collider_tables", "all_ray_hits", "cast_ray", "ray_hits", "all_point_hits",
    "project_point", "point_intersections", "aabb_intersections", "manifold_vs_all",
    "shape_intersections", "cast_query", "sweep_all", "cast_shape", "shape_hits",
    "cast_ray_predicate", "cast_shape_predicate", "project_point_predicate", "QueryFilter",
]


# ---------------------------------------------------------------------------
# Query shapes
# ---------------------------------------------------------------------------


def _shape(verts, count, radius, device):
    dev = resolve(device)
    return (torch.as_tensor(verts, dtype=torch.float32).to(dev),
            torch.tensor(count, dtype=torch.int32, device=dev),
            torch.tensor(radius, dtype=torch.float32, device=dev))


def shape_circle(radius, device=None):
    """(verts, count, radius) of a circle query shape."""
    return _shape(np.zeros((MAX_POLY_VERTS, 2), np.float32), 1, radius, device)


def shape_capsule(radius, length, axis=(0.0, 1.0), device=None):
    """A capsule whose segment of total ``length`` lies along ``axis``."""
    a = np.asarray(axis, np.float32)
    a = a / max(float(np.linalg.norm(a)), 1e-9)
    h = 0.5 * float(length)
    v = np.zeros((MAX_POLY_VERTS, 2), np.float32)
    v[0] = -h * a
    v[1:] = h * a  # padding repeats the last vertex
    return _shape(v, 2, radius, device)


def shape_polygon(points, radius=0.0, device=None):
    """A convex polygon query shape from CCW (or CW: rewound) points."""
    pts = np.asarray(points, np.float32)
    if pts.shape[0] > MAX_POLY_VERTS:
        raise ValueError(f"2D query shapes support <= {MAX_POLY_VERTS} vertices")
    area2 = 0.0
    for i in range(pts.shape[0]):
        x0, y0 = pts[i]
        x1, y1 = pts[(i + 1) % pts.shape[0]]
        area2 += x0 * y1 - x1 * y0
    if area2 < 0.0:
        pts = pts[::-1].copy()
    v = np.zeros((MAX_POLY_VERTS, 2), np.float32)
    v[:pts.shape[0]] = pts
    v[pts.shape[0]:] = pts[-1]
    return _shape(v, pts.shape[0], radius, device)


def shape_rect(hx, hy, radius=0.0, device=None):
    """A rectangle of half extents (hx, hy); ``radius`` rounds its corners."""
    return shape_polygon([(-hx, -hy), (hx, -hy), (hx, hy), (-hx, hy)], radius, device)


# ---------------------------------------------------------------------------
# Results and shared pieces
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RayHit2D:
    """Mirrors ``RayHitData``; fields carry a leading ``max_hits`` axis from
    ``ray_hits``."""

    collider: torch.Tensor  # i32, -1 = miss
    body: torch.Tensor      # i32
    distance: torch.Tensor  # f32
    point: torch.Tensor     # f32[2]
    normal: torch.Tensor    # f32[2] outward surface normal at the hit
    hit: torch.Tensor       # bool


@dataclass(frozen=True)
class ShapeHit2D:
    """Mirrors ``ShapeHitData``; fields carry a leading ``max_hits`` axis
    from ``shape_hits``."""

    collider: torch.Tensor  # i32, -1 = miss
    body: torch.Tensor      # i32
    distance: torch.Tensor  # f32 travel distance along the cast
    point_a: torch.Tensor   # f32[2] witness on the cast shape at impact
    point_b: torch.Tensor   # f32[2] witness on the hit collider
    normal: torch.Tensor    # f32[2] surface normal on the hit collider
    hit: torch.Tensor       # bool


def collider_tables(world):
    """The kernels' collider tables: world positions, cosines and sines of
    the world angles (reference ``_world_geom`` :279), local vertices,
    counts, radii, half-space flags."""
    col = world.colliders
    p = collider_poses(world)
    return p.pos, p.cs, col.poly_verts, col.vert_count, col.radius, col.is_plane


def vec(world, x):
    """``x`` as an f32 tensor on the world's device."""
    return torch.as_tensor(x, dtype=torch.float32).to(world.device)


def _first(mask, max_hits):
    """i32[max_hits]: the indices where ``mask`` holds, lowest first, -1 after
    (reference ``lax.top_k`` of the 1/0 scores)."""
    k = min(max_hits, mask.shape[0])
    idx = torch.sort((~mask).to(torch.int32), stable=True).indices[:k]
    out = torch.where(mask[idx], idx, -1).to(torch.int32)
    return torch.cat([out, out.new_full((max_hits - k,), -1)])


# ---------------------------------------------------------------------------
# Rays (Kernel AC)
# ---------------------------------------------------------------------------


def all_ray_hits(world, origins, directions, solid=True, qfilter: QueryFilter = None):
    """``(t f32[R, M], normal f32[R, M, 2])`` of R rays (origins and unit
    directions f32[R, 2]) on every collider, in one launch; ``t`` is ``BIG``
    where a ray misses or the filter leaves the collider out."""
    qfilter = qfilter if qfilter is not None else QueryFilter()
    rays = torch.cat([vec(world, origins), vec(world, directions)], 1).contiguous()
    t, n = kac.ray_cast_2d(rays, solid, *collider_tables(world))
    ok = collider_query_mask(world.colliders, qfilter)
    return torch.where(ok[None, :], t, BIG), n


def cast_ray(world, origin, direction, max_distance=BIG, solid=True,
             qfilter: QueryFilter = None) -> RayHit2D:
    """First hit along the ray (``SpatialQuery::cast_ray``, 2D)."""
    o, d = vec(world, origin), normalize(vec(world, direction))
    t, n = all_ray_hits(world, o[None], d[None], solid, qfilter)
    t, n = t[0], n[0]
    t = torch.where(t <= max_distance, t, BIG)
    i = torch.argmin(t)  # the first of equals
    hit = t[i] < BIG
    return RayHit2D(
        collider=torch.where(hit, i, -1).to(torch.int32),
        body=torch.where(hit, world.colliders.body_idx[i], -1).to(torch.int32),
        distance=torch.where(hit, t[i], float("inf")),
        point=o + d * torch.where(hit, t[i], 0.0), normal=n[i], hit=hit,
    )


def ray_hits(world, origin, direction, max_hits: int, max_distance=BIG, solid=True,
             qfilter: QueryFilter = None) -> RayHit2D:
    """Up to ``max_hits`` nearest hits, sorted by distance (2D
    ``SpatialQuery::ray_hits``); misses padded with ``hit`` False."""
    o, d = vec(world, origin), normalize(vec(world, direction))
    t, n = all_ray_hits(world, o[None], d[None], solid, qfilter)
    t, n = t[0], n[0]
    t = torch.where(t <= max_distance, t, BIG)
    idx, tk, hit = nearest(t, min(max_hits, t.shape[0]), max_hits)
    return RayHit2D(
        collider=torch.where(hit, idx, -1).to(torch.int32),
        body=torch.where(hit, world.colliders.body_idx[idx], -1).to(torch.int32),
        distance=torch.where(hit, tk, float("inf")),
        point=o[None, :] + d[None, :] * torch.where(hit, tk, 0.0)[:, None],
        normal=n[idx], hit=hit,
    )


# ---------------------------------------------------------------------------
# Points (Kernel AD)
# ---------------------------------------------------------------------------


def all_point_hits(world, points):
    """``(distance f32[P, M], surface point f32[P, M, 2])`` of P points
    f32[P, 2] to every collider's rounded surface (negative inside), in one
    launch."""
    return kad.point_2d(vec(world, points).contiguous(), *collider_tables(world))


def project_point(world, point, solid=True, qfilter: QueryFilter = None):
    """The collider closest to ``point`` (2D ``SpatialQuery::project_point``):
    a dict of ``collider``, ``body``, ``point``, ``is_inside``, ``distance``
    and ``hit``, as the reference returns."""
    qfilter = qfilter if qfilter is not None else QueryFilter()
    p = vec(world, point)
    col = world.colliders
    dists, cpts = all_point_hits(world, p[None])
    dists, cpts = dists[0], cpts[0]
    ok = collider_query_mask(col, qfilter)
    inside = dists < 0.0
    held = inside & solid
    key = torch.where(ok, torch.where(held, 0.0, dists.abs()), BIG)
    i = torch.argmin(key)
    hit = key[i] < BIG
    return {
        "collider": torch.where(hit, i, -1).to(torch.int32),
        "body": torch.where(hit, col.body_idx[i], -1).to(torch.int32),
        "point": torch.where(held[i], p, cpts[i]),
        "is_inside": inside[i] & hit,
        "distance": torch.where(hit, dists[i], float("inf")),
        "hit": hit,
    }


def point_intersections(world, point, max_hits: int = 8, qfilter: QueryFilter = None):
    """i32[max_hits]: the colliders containing ``point``, lowest index first,
    padded with -1."""
    qfilter = qfilter if qfilter is not None else QueryFilter()
    dists, _ = all_point_hits(world, vec(world, point)[None])
    return _first(collider_query_mask(world.colliders, qfilter) & (dists[0] <= 0.0), max_hits)


# ---------------------------------------------------------------------------
# Intersections
# ---------------------------------------------------------------------------


def aabb_intersections(world, aabb_min, aabb_max, max_hits: int = 8,
                       qfilter: QueryFilter = None):
    """i32[max_hits]: the colliders whose stored AABB (as the step or
    ``broadphase.update_aabbs`` left it) overlaps the given one, lowest index
    first, padded with -1."""
    qfilter = qfilter if qfilter is not None else QueryFilter()
    col = world.colliders
    lo, hi = vec(world, aabb_min), vec(world, aabb_max)
    overlap = ((col.aabb_min <= hi[None, :]) & (lo[None, :] <= col.aabb_max)).all(-1)
    return _first(collider_query_mask(col, qfilter) & overlap, max_hits)


def _shape_on(world, shape):
    verts, count, radius = shape
    dev = world.device
    return (torch.as_tensor(verts, dtype=torch.float32).to(dev).contiguous(),
            torch.as_tensor(count, dtype=torch.int32).to(dev),
            torch.as_tensor(radius, dtype=torch.float32).to(dev))


def cast_query(world, origin, angle, direction, max_distance):
    """Kernel AE's query vector of one cast (see ``kernels/shape_cast_2d.py``):
    the origin, the cosine and sine of the angle, the direction normalized,
    ``max_distance`` and ``max_distance + 1``, the 1 added before rounding to
    f32 where ``max_distance`` is a Python number, as the reference's weakly
    typed constant is."""
    a = vec(world, angle)
    if isinstance(max_distance, (int, float)):
        md, md1 = vec(world, max_distance), vec(world, max_distance + 1.0)
    else:
        md = vec(world, max_distance)
        md1 = md + 1.0
    return torch.cat([vec(world, origin), torch.cos(a)[None], torch.sin(a)[None],
                      normalize(vec(world, direction)), md[None], md1[None]]).contiguous()


def manifold_vs_all(world, shape, pose_pos, pose_angle=0.0) -> kae.Cast2D:
    """The manifold of the query shape at its pose against every collider
    (reference ``_manifold_vs_all`` :447): one 0-round launch of Kernel AE.
    ``normal`` points from the shape to the collider; ``sep`` is the least
    separation (negative: overlapping), ``count`` the manifold's points."""
    query = cast_query(world, pose_pos, pose_angle, (0.0, 0.0), 0.0)
    return kae.shape_cast_2d(query, *_shape_on(world, shape), *collider_tables(world), rounds=0)


def shape_intersections(world, shape, shape_pos, shape_angle=0.0, max_hits: int = 8,
                        qfilter: QueryFilter = None):
    """i32[max_hits]: the colliders that the query shape at its pose overlaps,
    lowest index first, padded with -1."""
    qfilter = qfilter if qfilter is not None else QueryFilter()
    m = manifold_vs_all(world, shape, shape_pos, shape_angle)
    hits = collider_query_mask(world.colliders, qfilter) & (m.count > 0) & (m.sep < 0.0)
    return _first(hits, max_hits)


# ---------------------------------------------------------------------------
# Shape casts (Kernel AE)
# ---------------------------------------------------------------------------


def sweep_all(world, shape, origin, angle, direction, max_distance,
              qfilter: QueryFilter = None):
    """Every collider's cast (reference ``_sweep_all`` :500), in one launch of
    Kernel AE: ``(t f32[M], point_a, point_b, normal f32[M, 2])``, ``t`` =
    ``BIG`` where missed or filtered out, ``normal`` from the shape to the
    collider."""
    qfilter = qfilter if qfilter is not None else QueryFilter()
    c = kae.shape_cast_2d(cast_query(world, origin, angle, direction, max_distance),
                          *_shape_on(world, shape), *collider_tables(world))
    ok = collider_query_mask(world.colliders, qfilter)
    return torch.where(ok & c.hit, c.t, BIG), c.point_a, c.point_b, c.normal


def cast_shape(world, shape, origin, angle, direction, max_distance,
               qfilter: QueryFilter = None) -> ShapeHit2D:
    """The first hit when the query shape (not turning, at ``angle``) sweeps
    from ``origin`` along ``direction`` up to ``max_distance``."""
    t, pa, pb, n = sweep_all(world, shape, origin, angle, direction, max_distance, qfilter)
    i = torch.argmin(t)  # the first of equals
    found = t[i] < BIG
    return ShapeHit2D(
        collider=torch.where(found, i, -1).to(torch.int32),
        body=torch.where(found, world.colliders.body_idx[i], -1).to(torch.int32),
        distance=torch.where(found, t[i], float("inf")),
        point_a=pa[i], point_b=pb[i], normal=-n[i], hit=found,
    )


def shape_hits(world, shape, origin, angle, direction, max_distance, max_hits: int = 4,
               qfilter: QueryFilter = None) -> ShapeHit2D:
    """Up to ``max_hits`` hits of one sweep, nearest first."""
    t, pa, pb, n = sweep_all(world, shape, origin, angle, direction, max_distance, qfilter)
    idx, tk, found = nearest(t, min(max_hits, world.colliders.capacity), max_hits)
    return ShapeHit2D(
        collider=torch.where(found, idx, -1).to(torch.int32),
        body=torch.where(found, world.colliders.body_idx[idx], -1).to(torch.int32),
        distance=torch.where(found, tk, float("inf")),
        point_a=pa[idx], point_b=pb[idx], normal=-n[idx], hit=found,
    )


# ---------------------------------------------------------------------------
# Predicate variants (``system_param.rs:194`` family)
# ---------------------------------------------------------------------------


def cast_ray_predicate(world, origin, direction, predicate, max_distance=BIG, solid=True,
                       qfilter: QueryFilter = None) -> RayHit2D:
    """The first ray hit among the colliders passing ``predicate``."""
    return cast_ray(world, origin, direction, max_distance, solid,
                    with_predicate(world, qfilter, predicate))


def cast_shape_predicate(world, shape, origin, angle, direction, predicate, max_distance=BIG,
                         qfilter: QueryFilter = None) -> ShapeHit2D:
    """The first shape-cast hit among the colliders passing ``predicate``."""
    return cast_shape(world, shape, origin, angle, direction, max_distance,
                      with_predicate(world, qfilter, predicate))


def project_point_predicate(world, point, predicate, solid=True, qfilter: QueryFilter = None):
    """The closest point among the colliders passing ``predicate``."""
    return project_point(world, point, solid, with_predicate(world, qfilter, predicate))
