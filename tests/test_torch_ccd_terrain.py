"""The port's swept CCD on the terrain (Kernel R's plain version on the
CPU) against the JAX reference: the cases of
``torch_cases/cases_ccd_terrain.py``, run in a child process by
``torch_child.run_cases``."""

from torch_child import run_cases


def test_ccd_terrain_cases():
    run_cases("cases_ccd_terrain.py")
