"""The port's analytic round-shape manifolds (Kernel N's plain version)
against the JAX reference: the cases of ``torch_cases/cases_round_manifold.py``,
run in a child process by ``torch_child.run_cases``."""

from torch_child import run_cases


def test_round_manifold_cases():
    run_cases("cases_round_manifold.py")
