"""The port's 2D swept CCD against the JAX reference: the swept bullets and a
spinning capsule step by step, the two faults of the reference's sweep that
the port repairs, and ``pyramid_ccd_2d(6, 4)``: the cases of
``torch_cases/cases_dim2_ccd.py``, run in a child process by
``torch_child.run_cases``."""

from torch_child import run_cases


def test_dim2_ccd_cases():
    run_cases("cases_dim2_ccd.py")
