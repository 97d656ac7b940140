"""The port's types, config, state, builder and scenes against the JAX
reference, leaf for leaf: the cases of ``torch_cases/cases_state.py``, run
in a child process by ``torch_child.run_cases``."""

from torch_child import run_cases


def test_state_cases():
    run_cases("cases_state.py")
