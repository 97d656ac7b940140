"""The port's native 2D step end to end: one step of a base-20 pyramid and 60
steps of every 2D shape against the JAX reference, the ``pyramid2d_native``
golden, the NaN quarantine, determinism and what the 2D step refuses: the
cases of ``torch_cases/cases_dim2_step.py``, run in a child process by
``torch_child.run_cases``."""

from torch_child import run_cases


def test_dim2_step_cases():
    run_cases("cases_dim2_step.py")
