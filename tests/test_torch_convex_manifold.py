"""The port's support-map manifolds (Kernels M and O's plain versions)
against the JAX reference: the cases of ``torch_cases/cases_convex_manifold.py``,
run in a child process by ``torch_child.run_cases``."""

from torch_child import run_cases


def test_convex_manifold_cases():
    run_cases("cases_convex_manifold.py")
