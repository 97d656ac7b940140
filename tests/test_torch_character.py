"""The port's kinematic character (``project_velocity``, ``depenetrate`` on
Kernel S's manifold mode, ``move_and_slide``) and picking against the JAX
reference, with the reference's depenetration fault held to its intent: the
cases of ``torch_cases/cases_character.py``, run in a child process by
``torch_child.run_cases``."""

from torch_child import run_cases


def test_character_cases():
    run_cases("cases_character.py")
