"""User shapes in the port (custom colliders through the step, the ray
casts and the point queries, on the plain versions of Kernel E's custom
pass, M, O and P's custom instances, Kernel AJ and AF's custom instance)
against the JAX reference: the cases of ``torch_cases/cases_custom_shapes.py``,
run in a child process by ``torch_child.run_cases``."""

from torch_child import run_cases


def test_custom_shapes_cases():
    run_cases("cases_custom_shapes.py")
