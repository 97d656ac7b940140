"""Predicate query variants (port of ``avian_tpu/queries/predicate.py``,
``SpatialQuery::cast_ray_predicate`` et al.): a user function evaluated over
every collider slot at once, ``predicate(world, collider_ids) -> bool[M]``
(True = eligible), folded into the query's exclusion mask
(``filter.with_predicate``)."""

from avian_tpu_torch.queries.filter import QueryFilter, with_predicate
from avian_tpu_torch.queries.point import project_point
from avian_tpu_torch.queries.raycast import BIG, cast_ray
from avian_tpu_torch.queries.shapecast import cast_shape


def cast_ray_predicate(world, origin, direction, predicate, max_distance=BIG, solid=True,
                       qfilter: QueryFilter = None):
    """First ray hit among the colliders passing ``predicate``."""
    return cast_ray(world, origin, direction, max_distance, solid,
                    with_predicate(world, qfilter, predicate))


def cast_shape_predicate(world, shape_type, params, origin, rotation, direction, predicate,
                         max_distance=BIG, qfilter: QueryFilter = None, **kw):
    """First shape-cast hit among the colliders passing ``predicate``."""
    return cast_shape(world, shape_type, params, origin, rotation, direction, max_distance,
                      qfilter=with_predicate(world, qfilter, predicate), **kw)


def project_point_predicate(world, point, predicate, solid=True, qfilter: QueryFilter = None):
    """The closest point among the colliders passing ``predicate``."""
    return project_point(world, point, solid, with_predicate(world, qfilter, predicate))
