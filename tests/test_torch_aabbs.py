"""The port's collider poses, AABBs and grid cell keys (Kernel E's twin on CPU)
against the JAX reference: the cases of
``torch_cases/cases_aabbs.py``, run in a child process by
``torch_child.run_cases``."""

from torch_child import run_cases


def test_aabbs_cases():
    run_cases("cases_aabbs.py")
