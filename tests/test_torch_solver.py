"""The port's coloring, constraint preparation, solver passes (Kernel D's
twin), restitution and sleeping against the JAX reference: the cases of
``torch_cases/cases_solver.py``, run in a child process by
``torch_child.run_cases``."""

from torch_child import run_cases


def test_solver_cases():
    run_cases("cases_solver.py")
