"""Intersection queries (port of ``avian_tpu/queries/intersect.py``,
``SpatialQuery::aabb_intersections_with_aabb`` / ``shape_intersections``).

``aabb_intersections`` tests the colliders' stored AABBs (those of the last
``update_aabbs``, not recomputed poses) with Kernel AH
(``kernels/aabb_overlap.py``); ``shape_intersections`` takes the query
shape's manifold at its pose against every collider with Kernel S's overlap
mode, one launch a canonical shape pair. Both list the lowest indices first
and pad with -1, also where ``max_hits`` exceeds the collider slots (the
reference's ``lax.top_k`` raises there, ROADMAP 3b).
"""

import torch

from avian_tpu_torch.kernels import aabb_overlap as kah
from avian_tpu_torch.kernels import shape_cast as ks
from avian_tpu_torch.queries.filter import QueryFilter, collider_query_mask
from avian_tpu_torch.queries.point import first_true
from avian_tpu_torch.queries.shapecast import cast_setup


def all_aabb_overlaps(world, aabb_min, aabb_max, qfilter: QueryFilter = None):
    """bool[Q, M]: which colliders the query filter admits and whose stored
    AABB overlaps each box [``aabb_min``, ``aabb_max``] f32[Q, 3]."""
    qfilter = qfilter if qfilter is not None else QueryFilter()
    col = world.colliders
    lo = torch.as_tensor(aabb_min, dtype=torch.float32).to(world.device).reshape(-1, 3)
    hi = torch.as_tensor(aabb_max, dtype=torch.float32).to(world.device).reshape(-1, 3)
    ok = collider_query_mask(col, qfilter)
    return kah.aabb_overlap(lo.contiguous(), hi.contiguous(), col.aabb_min.contiguous(),
                            col.aabb_max.contiguous(), ok.contiguous())


def aabb_intersections(world, aabb_min, aabb_max, max_hits: int = 8, qfilter=None):
    """i32[max_hits]: the colliders whose AABB overlaps the given AABB, lowest
    index first, padded with -1."""
    return first_true(all_aabb_overlaps(world, aabb_min, aabb_max, qfilter)[0], max_hits)


def shape_overlaps(world, shape_type, params, shape_pos, shape_quat, qfilter=None,
                   shape_pairs=None):
    """bool[M]: which colliders the query filter admits and the shape at
    (``shape_pos``, ``shape_quat``) overlaps: their manifold has a point
    (count > 0) of negative separation. A pair outside the hint
    (``shapecast.cast_pairs``) or of two half-spaces never overlaps."""
    qfilter = qfilter if qfilter is not None else QueryFilter()
    query, tabs, out, buckets = cast_setup(world, shape_type, params, shape_pos, shape_quat,
                                           (1.0, 0.0, 0.0), 0.0, shape_pairs)
    for pair, cols in buckets:
        ks.shape_overlap(pair, cols, int(shape_type), query, *tabs, out)
    return out.hit & collider_query_mask(world.colliders, qfilter)


def shape_intersections(world, shape_type, params, shape_pos, shape_quat, max_hits: int = 8,
                        qfilter=None, shape_pairs=None):
    """i32[max_hits]: the colliders intersecting the given shape, lowest
    index first, padded with -1."""
    return first_true(shape_overlaps(world, shape_type, params, shape_pos, shape_quat, qfilter,
                                     shape_pairs), max_hits)
