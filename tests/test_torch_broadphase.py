"""The port's AABBs and broadphase (Kernel B's twin) against the JAX
reference: pair set, slot order and ``dropped`` exact: the cases of
``torch_cases/cases_broadphase.py``, run in a child process by
``torch_child.run_cases``."""

from torch_child import run_cases


def test_broadphase_cases():
    run_cases("cases_broadphase.py")
