"""Shape casts by conservative advancement (port of
``avian_tpu/queries/shapecast.py``, ``SpatialQuery::cast_shape``): the
narrowphase's manifold of the query shape and each collider is the distance
and normal oracle of 16 rounds of advancement along the cast direction.

One sweep of the scene computes every collider's travel distance: the
colliders are bucketed by the canonical pair of (query shape, collider
shape) with one sort and one host read (``cast_buckets``, which a caller
that casts many times into one world shares), and each bucket is one launch
of Kernel S (``kernels/shape_cast.py``). ``cast_shape`` takes the first
nearest hit, ``shape_hits`` the ``max_hits`` nearest (ties to the lower
collider index, as the reference's ``lax.top_k``). ``manifold_vs_all`` is S's
manifold mode on the same buckets: the query shape's manifold against every
collider, which the character's depenetration reads.
"""

from dataclasses import dataclass
from typing import NamedTuple

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


class CastPlan(NamedTuple):
    """What every cast of one query shape type into a world as it stands
    shares (``cast_buckets``)."""

    tabs: tuple            # (pos, quat, params, shape_type, pool): S's collider tables
    buckets: list          # one (canonical pair, cols i32[K]) per launch
    swapped: torch.Tensor  # bool[M] the collider's shape code is the lower


def cast_buckets(world, shape_type, shape_pairs=None) -> CastPlan:
    """The colliders' poses (one launch of Kernel E) and tables, and their
    buckets by the canonical pair of (query shape, collider shape): one sort
    and one host read. A caller that casts many times into one world (the
    character controller) buckets once."""
    st = int(shape_type)
    col = world.colliders
    pos, quat = collider_poses(world)
    order, _, spans = canonical_spans(torch.full_like(col.shape_type, st), col.shape_type,
                                      torch.ones_like(col.active),
                                      cast_pairs(world, st, shape_pairs))
    order = order.to(torch.int32)
    tabs = (pos.contiguous(), quat.contiguous(), col.params.contiguous(),
            col.shape_type.contiguous(), world.convex_verts.contiguous())
    return CastPlan(tabs, [(pair, order[a:b].contiguous()) for pair, a, b in spans],
                    st > col.shape_type)


def _floats(x):
    return (x.to(torch.float32) if isinstance(x, torch.Tensor)
            else torch.as_tensor(x, dtype=torch.float32)).reshape(-1)


def cast_query(params, origin, rotation, direction, max_distance, device):
    """The f32[20] query of one cast (``kernels/shape_cast.py``) on
    ``device``: the direction normalized (+x where it is ~0) and the params
    padded to 8 lanes where they stand. A Python ``max_distance`` and
    ``max_distance + 1`` are each rounded once to f32 on the host, as the
    reference's weakly typed Python floats are; for a tensor, ``max_distance
    + 1`` is computed in f32 on its device, as the reference computes it on a
    traced value (its ``shapecast.py:108``). Inputs that are all on the host
    are copied to ``device`` once; inputs already there read nothing back."""
    o, rot, d, prm = (_floats(x) for x in (origin, rotation, direction, params))
    d = vec.normalize_or_rn(d, torch.eye(3, device=d.device)[0])
    prm = torch.cat([prm, prm.new_zeros((8 - prm.shape[0],))])
    if isinstance(max_distance, torch.Tensor):
        md = max_distance.to(torch.float32).reshape(1)
        dist = torch.cat([md, md + 1.0])
    else:
        dist = torch.tensor([_f32(max_distance), _f32(max_distance + 1.0)])
    parts = (o, rot, d, prm, dist)
    if all(x.device.type == "cpu" for x in parts):
        return torch.cat(parts).to(device)
    return torch.cat([x.to(device) for x in parts])


def empty_results(fill, swapped) -> ks.CastOut:
    """Every collider's result before a launch: the reference's empty
    manifold's, where no bucket reaches it (half-space pairs, pairs outside
    the hint): ``fill`` (a 0-d tensor) for t, never a hit, the normal +x
    un-swapped."""
    m = swapped.shape[0]
    x_axis = torch.eye(3, device=swapped.device)[0]
    return ks.CastOut(
        t=fill.expand(m).clone(), hit=torch.zeros((m,), dtype=torch.bool, device=swapped.device),
        pa=swapped.new_zeros((m, 3), dtype=torch.float32),
        pb=swapped.new_zeros((m, 3), dtype=torch.float32),
        n=torch.where(swapped[:, None], -x_axis, x_axis))


def cast_setup(world, shape_type, params, origin, rotation, direction, max_distance,
               shape_pairs=None):
    """What one cast's launches take: ``(query f32[20], collider tables
    (pos, quat, params, shape_type, pool), out, buckets)``, where ``out`` is a
    ``CastOut`` holding the reference's empty-manifold result for every
    collider (t = ``max_distance + 1``) and ``buckets`` lists ``(canonical
    pair, cols i32[K])``."""
    plan = cast_buckets(world, shape_type, shape_pairs)
    query = cast_query(params, origin, rotation, direction, max_distance, world.device)
    return query, plan.tabs, empty_results(query[19], plan.swapped), plan.buckets


def sweep(plan: CastPlan, shape_type, query, ok):
    """Every collider's cast of ``query`` (one launch of Kernel S a bucket):
    ``(t f32[M], point_a, point_b, normal f32[M, 3])``, ``t`` = ``BIG`` where
    ``ok`` (bool[M]) is False or the cast missed."""
    out = empty_results(query[19], plan.swapped)
    for pair, cols in plan.buckets:
        ks.shape_cast(pair, cols, int(shape_type), query, *plan.tabs, out)
    return torch.where(ok & out.hit, out.t, BIG), out.pa, out.pb, out.n


def manifold_vs_all(plan: CastPlan, shape_type, query):
    """The manifold of the query shape at its origin against every collider
    (one launch of Kernel S's manifold mode a bucket): ``(separation f32[M],
    normal f32[M, 3])``, the smallest of each manifold's separations and its
    normal from the query shape to the collider; 1e9 (the empty manifold's)
    and +x un-swapped where no bucket reaches the collider."""
    out = empty_results(query.new_full((), ks.EMPTY_SEP), plan.swapped)
    for pair, cols in plan.buckets:
        ks.shape_manifold(pair, cols, int(shape_type), query, *plan.tabs, out)
    return out.t, out.n


def sweep_all(world, shape_type, params, origin, rotation, direction, max_distance,
              qfilter: QueryFilter, shape_pairs=None):
    """Every collider's cast (reference ``_sweep_all``): ``(t f32[M], point_a,
    point_b, normal f32[M, 3])``, ``t`` = ``BIG`` where filtered out or
    missed."""
    plan = cast_buckets(world, shape_type, shape_pairs)
    query = cast_query(params, origin, rotation, direction, max_distance, world.device)
    return sweep(plan, shape_type, query, collider_query_mask(world.colliders, qfilter))


def first_hit(world, t, pa, pb, n) -> ShapeHit:
    """The first nearest of a sweep's hits (``cast_shape``'s selection),
    gathered on the device: nothing is read back to the host."""
    i = torch.argmin(t).reshape(1)  # the first of equals

    def at(x):
        return x.index_select(0, i)[0]

    ti = at(t)
    found = ti < BIG
    return ShapeHit(
        collider=torch.where(found, i[0], -1).to(torch.int32),
        body=torch.where(found, at(world.colliders.body_idx), -1).to(torch.int32),
        distance=torch.where(found, ti, float("inf")),
        point_a=at(pa), point_b=at(pb), normal=-at(n), hit=found,
    )


def cast_shape(world, shape_type, params, origin, rotation, direction, max_distance,
               qfilter: QueryFilter = None, shape_pairs=None) -> ShapeHit:
    """First hit when sweeping the shape from ``origin`` along ``direction``
    up to ``max_distance``."""
    qfilter = qfilter if qfilter is not None else QueryFilter()
    return first_hit(world, *sweep_all(world, shape_type, params, origin, rotation, direction,
                                       max_distance, qfilter, shape_pairs))


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
