"""The hinged-box path and the XPBD joint solver against the JAX reference:
the scene, ``prepare_joints``, one joint substep with all five types, the
joint-disabled broadphase pairs, island labels, one full step and the golden
trajectory: the cases of ``torch_cases/cases_joints.py``, run in a child
process by ``torch_child.run_cases``."""

from torch_child import run_cases


def test_joints_cases():
    run_cases("cases_joints.py")
