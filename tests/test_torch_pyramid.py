"""The box-pyramid path against the JAX reference: scenes, one step, constraint
packing with locked axes (Kernel H's twin on CPU), and standing: the cases of
``torch_cases/cases_pyramid.py``, run in a child process by
``torch_child.run_cases``."""

from torch_child import run_cases


def test_pyramid_cases():
    run_cases("cases_pyramid.py")
