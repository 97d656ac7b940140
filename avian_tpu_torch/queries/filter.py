"""Query filtering (port of ``avian_tpu/queries/filter.py``, the reference's
``SpatialQueryFilter``): a layer mask and excluded colliders."""

from dataclasses import dataclass

import torch

_ALL = 0xFFFFFFFF


@dataclass(frozen=True)
class QueryFilter:
    """``mask``: the layers the query interacts with (a u32 mask, as a Python
    int); ``excluded``: bool[M] colliders the query skips, or ``False`` for
    none."""

    mask: int = _ALL
    excluded: object = False


def _i32_bits(mask) -> int:
    """A u32 mask as the int32 bit pattern the port stores layers in."""
    mask = int(mask) & _ALL
    return mask - (1 << 32) if mask >= 1 << 31 else mask


def collider_query_mask(colliders, qfilter: QueryFilter) -> torch.Tensor:
    """bool[M]: the colliders this query may hit (reference
    ``collider_query_mask``, ``layers.rs:423`` semantics)."""
    ok = colliders.active & ((colliders.layer_members & _i32_bits(qfilter.mask)) != 0)
    excluded = qfilter.excluded
    if isinstance(excluded, torch.Tensor):
        return ok & ~excluded.to(device=ok.device, dtype=torch.bool)
    return ok & (not excluded)


def with_predicate(world, qfilter, predicate) -> QueryFilter:
    """``qfilter`` (or the default filter) with every collider that
    ``predicate(world, collider_ids) -> bool[M]`` rejects excluded (reference
    ``predicate.py::_with_predicate``; the 2D module's is the same)."""
    qfilter = qfilter if qfilter is not None else QueryFilter()
    m = world.colliders.capacity
    ids = torch.arange(m, dtype=torch.int32, device=world.device)
    keep = torch.as_tensor(predicate(world, ids), dtype=torch.bool, device=world.device)
    excluded = qfilter.excluded
    if not isinstance(excluded, torch.Tensor):
        excluded = torch.full((m,), bool(excluded), device=world.device)
    return QueryFilter(mask=qfilter.mask, excluded=excluded.to(torch.bool) | ~keep)
