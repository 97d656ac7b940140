"""Spatial queries (port of ``avian_tpu/queries``): ray casts and shape casts
against every collider, with layer filters, excluded colliders and
predicates. Ray casts are Kernel T (``kernels/ray_cast.py``), shape casts
Kernel S (``kernels/shape_cast.py``). Point projection, intersections and
the grid-accelerated casters (``point.py``, ``intersect.py``, ``accel.py``)
are not ported yet."""

from avian_tpu_torch.queries.filter import QueryFilter
from avian_tpu_torch.queries.predicate import cast_ray_predicate, cast_shape_predicate
from avian_tpu_torch.queries.raycast import RayHit, cast_ray, ray_hits
from avian_tpu_torch.queries.shapecast import ShapeHit, cast_shape, shape_hits

__all__ = [
    "cast_ray", "ray_hits", "RayHit", "cast_shape", "shape_hits", "ShapeHit", "QueryFilter",
    "cast_ray_predicate", "cast_shape_predicate",
]
