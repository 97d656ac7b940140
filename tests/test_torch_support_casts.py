"""The port's shape casts of capsules, cylinders and cones (Kernel S's plain
version on the CPU) against the JAX reference: the cases of
``torch_cases/cases_support_casts.py``, run in a child process by
``torch_child.run_cases``."""

from torch_child import run_cases


def test_support_casts_cases():
    run_cases("cases_support_casts.py")
