"""Spatial queries (port of ``avian_tpu/queries``): ray casts, shape casts,
point projections and intersections against every collider, with layer
filters, excluded colliders and predicates, and the grid-accelerated ray
casts with the persistent ray and shape casters. Ray casts are Kernel T
(``kernels/ray_cast.py``), shape casts Kernel S (``kernels/shape_cast.py``)
and shape intersections its overlap mode, point projections Kernel AF
(``kernels/point_3d.py``), AABB intersections Kernel AH
(``kernels/aabb_overlap.py``), and the grid's ray casts Kernel AG
(``kernels/ray_cast_grid.py``) over Kernel E's cell keys."""

from avian_tpu_torch.queries.accel import (QueryGrid, RayCasters, ShapeCasters,
                                           build_query_grid, cast_ray_grid, update_ray_casters,
                                           update_shape_casters)
from avian_tpu_torch.queries.filter import QueryFilter
from avian_tpu_torch.queries.intersect import aabb_intersections, shape_intersections
from avian_tpu_torch.queries.point import point_intersections, project_point
from avian_tpu_torch.queries.predicate import (cast_ray_predicate, cast_shape_predicate,
                                               project_point_predicate)
from avian_tpu_torch.queries.raycast import RayHit, cast_ray, ray_hits
from avian_tpu_torch.queries.shapecast import ShapeHit, cast_shape, shape_hits

__all__ = [
    "cast_ray", "ray_hits", "RayHit", "project_point", "point_intersections",
    "aabb_intersections", "shape_intersections", "cast_shape", "shape_hits", "ShapeHit",
    "QueryFilter", "cast_ray_predicate", "cast_shape_predicate", "project_point_predicate",
    "QueryGrid", "RayCasters", "build_query_grid", "cast_ray_grid", "update_ray_casters",
    "ShapeCasters", "update_shape_casters",
]
