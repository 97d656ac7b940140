"""The port's edge coloring, bucketing and run rank (Kernel G's twin on CPU)
against the JAX reference, exactly: the cases of
``torch_cases/cases_coloring.py``, run in a child process by
``torch_child.run_cases``."""

from torch_child import run_cases


def test_coloring_cases():
    run_cases("cases_coloring.py")
