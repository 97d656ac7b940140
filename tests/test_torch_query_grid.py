"""The port's query grid, grid ray casts and persistent ray and shape casters
against the JAX reference, with the reference's dropped ``solid`` flag of
its ray casters held to its intent: the cases of
``torch_cases/cases_query_grid.py``, run in a child process by
``torch_child.run_cases``."""

from torch_child import run_cases


def test_query_grid_cases():
    run_cases("cases_query_grid.py")
