"""The port's hull and segment manifolds (the plain versions of Kernels P
and Q, and of Kernels M and O's segment instances) against the JAX
reference: the cases of ``torch_cases/cases_hull_manifold.py``, run in a
child process by ``torch_child.run_cases``."""

from torch_child import run_cases


def test_hull_manifold_cases():
    run_cases("cases_hull_manifold.py")
