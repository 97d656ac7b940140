"""The port's swept CCD in the step (Kernel R's plain version on the CPU)
and the constant-force wake against the JAX reference: the cases of
``torch_cases/cases_ccd.py``, run in a child process by
``torch_child.run_cases``."""

from torch_child import run_cases


def test_ccd_cases():
    run_cases("cases_ccd.py")
