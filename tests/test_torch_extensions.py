"""Collision hooks and custom joints of the port's 3D step against the JAX
reference: the cases of ``torch_cases/cases_extensions.py``, run in a child
process by ``torch_child.run_cases``."""

from torch_child import run_cases


def test_extensions_cases():
    run_cases("cases_extensions.py")
