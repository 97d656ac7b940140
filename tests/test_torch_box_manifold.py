"""The port's box/box and box/plane manifolds (Kernel A's twin), their
dispatch and the narrowphase stage against the JAX reference: the cases of
``torch_cases/cases_box_manifold.py``, run in a child process by
``torch_child.run_cases``."""

from torch_child import run_cases


def test_box_manifold_cases():
    run_cases("cases_box_manifold.py")
