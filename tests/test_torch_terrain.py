"""The port's hull-and-terrain path (segments, triangles, trimeshes,
heightfields, voxels, convex hulls and round cuboids) against the JAX
reference: the cases of ``torch_cases/cases_terrain.py``, run in a child
process by ``torch_child.run_cases``."""

from torch_child import run_cases


def test_terrain_cases():
    run_cases("cases_terrain.py")
