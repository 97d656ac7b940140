"""Physics picking: pointer rays to hit bodies (port of
``avian_tpu/picking.py``, the reference's ``PhysicsPickingPlugin``,
``src/picking/mod.rs:1-60``).

Each pointer casts a ray into the world; its closest hit that the query
filter and an optional pickable mask admit (the ``PhysicsPickable``
require-markers mode) is the pick. ``pick`` is one ray cast (Kernel T,
``queries/raycast.py``), ``pick_batch`` casts P pointers in one call of
``all_hits`` and takes each row's first nearest hit, and ``pick_2d`` is the
2D engine's ray cast (Kernel AC, ``dim2/queries.py``).
"""

import torch

from avian_tpu_torch.dim2 import queries as q2d
from avian_tpu_torch.math import vec
from avian_tpu_torch.queries.filter import QueryFilter
from avian_tpu_torch.queries.raycast import RayHit, cast_ray, first_hits

__all__ = ["pick", "pick_batch", "pick_2d"]


def _pickable_filter(world, qfilter: QueryFilter, pickable) -> QueryFilter:
    """``qfilter`` (or the default) with the colliders that ``pickable``
    (bool[M], or None for every collider) leaves out excluded (reference
    ``picking.py:34-40``)."""
    qfilter = qfilter if qfilter is not None else QueryFilter()
    if pickable is None:
        return qfilter
    keep = torch.as_tensor(pickable, dtype=torch.bool).to(world.device)
    excluded = qfilter.excluded
    excluded = (excluded.to(device=world.device, dtype=torch.bool)
                if isinstance(excluded, torch.Tensor) else torch.full_like(keep, bool(excluded)))
    return QueryFilter(mask=qfilter.mask, excluded=excluded | ~keep)


def pick(world, pointer_origin, pointer_direction, max_distance=1e30, solid=True,
         qfilter: QueryFilter = None, pickable=None) -> RayHit:
    """Closest pickable hit for one pointer ray. ``pickable``: optional
    bool[M] mask of pickable colliders, the counterpart of requiring
    ``PhysicsPickable`` markers (``picking/mod.rs:34-43``); None: every
    collider."""
    return cast_ray(world, pointer_origin, pointer_direction, max_distance, solid,
                    _pickable_filter(world, qfilter, pickable))


def pick_batch(world, pointer_origins, pointer_directions, max_distance=1e30, solid=True,
               qfilter: QueryFilter = None, pickable=None) -> RayHit:
    """Batch picking: [P, 3] pointer origins and directions to a ``RayHit``
    with a leading [P] axis, every pointer in one call."""
    o = torch.as_tensor(pointer_origins, dtype=torch.float32).to(world.device).reshape(-1, 3)
    d = torch.as_tensor(pointer_directions, dtype=torch.float32).to(world.device).reshape(-1, 3)
    d = vec.normalize_or_rn(d, torch.eye(3, device=d.device)[0])
    return first_hits(world, o, d, max_distance, solid, _pickable_filter(world, qfilter, pickable))


def pick_2d(world, pointer_origin, pointer_direction, max_distance=1e30, solid=True,
            qfilter: QueryFilter = None, pickable=None):
    """Closest pickable hit for one pointer ray on the 2D engine
    (``World2D``); the same pickable mask as ``pick``."""
    return q2d.cast_ray(world, pointer_origin, pointer_direction, max_distance, solid,
                        _pickable_filter(world, qfilter, pickable))
