"""The mixed-shape path against the JAX reference: builder, AABBs, the
``many_shapes`` scene and its steps, and the cylinder stack on the plain
versions (the cases of ``torch_cases/cases_shapes.py``, run in a child
process by ``torch_child.run_cases``)."""

from torch_child import run_cases


def test_shapes_cases():
    run_cases("cases_shapes.py")
