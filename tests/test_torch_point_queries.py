"""The port's 3D point projections, point, AABB and shape intersections and
the point predicate against the JAX reference on five worlds, with the
reference's two faults on that path held to their intent: the cases of
``torch_cases/cases_point_queries.py``, run in a child process by
``torch_child.run_cases``."""

from torch_child import run_cases


def test_point_queries_cases():
    run_cases("cases_point_queries.py")
