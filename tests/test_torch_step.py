"""The ported slice end to end: one ``physics_step`` against the JAX
reference, the ``stack3`` golden, the early-out, the NaN quarantine,
determinism and the refused cases: the cases of
``torch_cases/cases_step.py``, run in a child process by
``torch_child.run_cases``."""

from torch_child import run_cases


def test_step_cases():
    run_cases("cases_step.py")
