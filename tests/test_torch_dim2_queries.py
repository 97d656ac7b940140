"""The port's 2D queries and character controller against the JAX
reference: rays, points, intersections and shape casts on three worlds, with
filters and predicates, Kernels AC, AD and AE's twins on many inputs at once,
``move_and_slide`` over 20 frames and ``depenetrate``: the cases of
``torch_cases/cases_dim2_queries.py``, run in a child process by
``torch_child.run_cases``."""

from torch_child import run_cases


def test_dim2_queries_cases():
    run_cases("cases_dim2_queries.py")
