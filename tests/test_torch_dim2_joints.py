"""The port's 2D joints, custom joints, collision hooks and forces against
the JAX reference: Kernel AA's rows and one substep of every joint type,
``falling_hinges_2d(4, 4)``, the five 2D joint examples, the custom pendulum
and both hooks in one world, the forces API and the constant-force wake: the
cases of ``torch_cases/cases_dim2_joints.py``, run in a child process by
``torch_child.run_cases``."""

from torch_child import run_cases


def test_dim2_joints_cases():
    run_cases("cases_dim2_joints.py")
