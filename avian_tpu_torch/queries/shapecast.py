"""Shape casts by conservative advancement (port of
``avian_tpu/queries/shapecast.py``, ``SpatialQuery::cast_shape``): the
narrowphase's manifold of the query shape and each collider is the distance
and normal oracle of 16 rounds of advancement along the cast direction.

One sweep of the scene computes every collider's travel distance: the
colliders are bucketed by the canonical pair of (query shape, collider
shape) with one sort and one host read, and each bucket is one launch of
Kernel S (``kernels/shape_cast.py``). ``cast_shape`` takes the first
nearest hit, ``shape_hits`` the ``max_hits`` nearest (ties to the lower
collider index, as the reference's ``lax.top_k``).
"""

from dataclasses import dataclass

import torch

from avian_tpu_torch.geometry.narrowphase import canonical_spans
from avian_tpu_torch.kernels import shape_cast as ks
from avian_tpu_torch.math import vec
from avian_tpu_torch.pipeline.broadphase import collider_poses
from avian_tpu_torch.queries.filter import QueryFilter, collider_query_mask

BIG = ks.BIG


@dataclass(frozen=True)
class ShapeHit:
    """Mirrors ``ShapeHitData``; fields carry a leading ``max_hits`` axis
    from ``shape_hits``."""

    collider: torch.Tensor  # i32, -1 = miss
    body: torch.Tensor      # i32
    distance: torch.Tensor  # f32 travel distance along the cast
    point_a: torch.Tensor   # f32[3] witness on the cast shape at impact
    point_b: torch.Tensor   # f32[3] witness on the hit collider
    normal: torch.Tensor    # f32[3] surface normal on the hit collider
    hit: torch.Tensor       # bool


def cast_pairs(world, cast_type, override):
    """The canonical (cast shape x scene shapes) pair hint (reference
    ``_cast_pairs``): ``override`` if given, else every present shape type
    of the world's ``shape_pairs`` against the cast shape, or ``None`` (all
    pairs) for a world without them."""
    if override is not None:
        return override
    if world.shape_pairs is None:
        return None
    present = sorted({t for p in world.shape_pairs for t in p})
    return tuple(sorted({(min(cast_type, t), max(cast_type, t)) for t in present}))


def _f32(x):
    return float(torch.tensor(x, dtype=torch.float32))


def cast_setup(world, shape_type, params, origin, rotation, direction, max_distance,
               shape_pairs=None):
    """What one cast's launches take: ``(query f32[20], collider tables
    (pos, quat, params, shape_type, pool), out, buckets)``, where ``out`` is a
    ``CastOut`` holding the reference's empty-manifold result for every
    collider and ``buckets`` lists ``(canonical pair, cols i32[K])``."""
    st = int(shape_type)
    col = world.colliders
    dev = world.device
    m = col.capacity
    pos, quat = collider_poses(world)
    prm = torch.zeros((8,), dtype=torch.float32)
    prm[:len(params)] = torch.as_tensor(params, dtype=torch.float32)
    d = vec.normalize_or_rn(torch.as_tensor(direction, dtype=torch.float32),
                            torch.tensor([1.0, 0.0, 0.0]))
    query = torch.cat([
        torch.as_tensor(origin, dtype=torch.float32), torch.as_tensor(rotation, dtype=torch.float32),
        d, prm, torch.tensor([_f32(max_distance), _f32(max_distance + 1.0)]),
    ]).to(dev)
    # Colliders of no bucket (half-space pairs, pairs outside the hint) get
    # the reference's empty manifold: never a hit, the normal +x un-swapped.
    swapped = st > col.shape_type
    x_axis = torch.tensor([1.0, 0.0, 0.0], device=dev)
    out = ks.CastOut(
        t=torch.full((m,), float(query[19]), device=dev),
        hit=torch.zeros((m,), dtype=torch.bool, device=dev),
        pa=torch.zeros((m, 3), device=dev), pb=torch.zeros((m, 3), device=dev),
        n=torch.where(swapped[:, None], -x_axis, x_axis),
    )
    order, _, spans = canonical_spans(torch.full_like(col.shape_type, st), col.shape_type,
                                      torch.ones_like(col.active),
                                      cast_pairs(world, st, shape_pairs))
    order = order.to(torch.int32)
    tabs = (pos.contiguous(), quat.contiguous(), col.params.contiguous(),
            col.shape_type.contiguous(), world.convex_verts.contiguous())
    return query, tabs, out, [(pair, order[a:b].contiguous()) for pair, a, b in spans]


def sweep_all(world, shape_type, params, origin, rotation, direction, max_distance,
              qfilter: QueryFilter, shape_pairs=None):
    """Every collider's cast (reference ``_sweep_all``): ``(t f32[M], point_a,
    point_b, normal f32[M, 3])``, ``t`` = ``BIG`` where filtered out or
    missed."""
    query, tabs, out, buckets = cast_setup(world, shape_type, params, origin, rotation,
                                           direction, max_distance, shape_pairs)
    for pair, cols in buckets:
        ks.shape_cast(pair, cols, int(shape_type), query, *tabs, out)
    ok = collider_query_mask(world.colliders, qfilter)
    t = torch.where(ok & out.hit, out.t, BIG)
    return t, out.pa, out.pb, out.n


def cast_shape(world, shape_type, params, origin, rotation, direction, max_distance,
               qfilter: QueryFilter = None, shape_pairs=None) -> ShapeHit:
    """First hit when sweeping the shape from ``origin`` along ``direction``
    up to ``max_distance``."""
    qfilter = qfilter if qfilter is not None else QueryFilter()
    t, pa, pb, n = sweep_all(world, shape_type, params, origin, rotation, direction,
                             max_distance, qfilter, shape_pairs)
    i = torch.argmin(t)  # the first of equals
    found = t[i] < BIG
    return ShapeHit(
        collider=torch.where(found, i, -1).to(torch.int32),
        body=torch.where(found, world.colliders.body_idx[i], -1).to(torch.int32),
        distance=torch.where(found, t[i], float("inf")),
        point_a=pa[i], point_b=pb[i], normal=-n[i], hit=found,
    )


def nearest(t, k, width):
    """``(idx i64[width], t[width], found bool[width])``: the ``k`` smallest of
    ``t`` in ascending order, the lower index first among equals (as
    ``lax.top_k(-t, k)``), padded to ``width`` with misses."""
    tk, idx = torch.sort(t, stable=True)
    tk, idx = tk[:k], idx[:k]
    found = tk < BIG
    if k < width:
        pad = width - k
        idx = torch.cat([idx, idx.new_zeros((pad,))])
        tk = torch.cat([tk, tk.new_full((pad,), BIG)])
        found = torch.cat([found, found.new_zeros((pad,))])
    return idx, tk, found


def shape_hits(world, shape_type, params, origin, rotation, direction, max_distance,
               max_hits: int = 4, qfilter: QueryFilter = None, shape_pairs=None) -> ShapeHit:
    """Up to ``max_hits`` hits along the sweep, nearest first, from one sweep
    of the scene; a ``ShapeHit`` with a leading ``max_hits`` axis."""
    qfilter = qfilter if qfilter is not None else QueryFilter()
    t, pa, pb, n = sweep_all(world, shape_type, params, origin, rotation, direction,
                             max_distance, qfilter, shape_pairs)
    idx, tk, found = nearest(t, min(max_hits, world.colliders.capacity), max_hits)
    return ShapeHit(
        collider=torch.where(found, idx, -1).to(torch.int32),
        body=torch.where(found, world.colliders.body_idx[idx], -1).to(torch.int32),
        distance=torch.where(found, tk, float("inf")),
        point_a=pa[idx], point_b=pb[idx], normal=-n[idx], hit=found,
    )
