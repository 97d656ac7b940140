"""The port's solver bodies, velocity increments and substep integration
(Kernel C's twin) against the JAX reference: the cases of
``torch_cases/cases_integrator.py``, run in a child process by
``torch_child.run_cases``."""

from torch_child import run_cases


def test_integrator_cases():
    run_cases("cases_integrator.py")
