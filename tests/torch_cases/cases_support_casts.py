"""Shape casts of the support-mapped shapes against the JAX reference
(Kernel S's plain version on the CPU, through Kernels M and P's plain
pipelines): seeded casts of a capsule through ``tests/test_queries.py``'s
world, and of a cylinder and a cone through its walls, checked as
``cases_shape_casts.check_casts`` checks (the hull's casts are
``cases_shape_casts.py``'s). Each shape's pairs with the world are one
compile of the reference's support-map pipeline, so each has four casts.
The capsule's and the cone's are read from ``support_casts_reference.npz``
(``port_common.Recording``); the cylinder's run the reference live and hold
it to the recording."""

from port_common import ieee_reference

ieee_reference()

from avian_tpu import ShapeType  # noqa: E402

from cases_shape_casts import check_casts  # noqa: E402
from port_common import Recording  # noqa: E402

N = 4
RECORDING = Recording("support_casts")


def test_capsule_casts_match_reference():
    assert check_casts("queries", ShapeType.CAPSULE, (0.3, 0.15), N, seed=21,
                       recording=RECORDING) >= 1


def test_cylinder_casts_match_reference():
    assert check_casts("walls", ShapeType.CYLINDER, (0.3, 0.25), N, seed=22, live=True,
                       recording=RECORDING) >= 1


def test_cone_casts_match_reference():
    assert check_casts("walls", ShapeType.CONE, (0.35, 0.3), N, seed=23,
                       recording=RECORDING) >= 1
