"""Scenes of the ported slice (port of ``avian_tpu/scenes.py::cube_pile`` and
the ``stack3`` golden scene of ``tests/golden_common.py``)."""

import math

import numpy as np

from avian_tpu_torch.core.builder import SceneBuilder
from avian_tpu_torch.core.types import BodyType


def cube_pile(
    n_cubes: int = 1000,
    half: float = 0.5,
    spacing: float | None = None,
    seed: int = 0,
    max_contacts: int | None = None,
    device=None,
):
    """N dynamic cubes in a loose jittered grid above a ground plane.
    Returns (world, ids). The jitter comes from ``numpy.random.default_rng(seed)``
    exactly as in the reference, so both packages build the same world."""
    rng = np.random.default_rng(seed)
    sp = spacing if spacing is not None else 2.0 * half * 1.1
    b = SceneBuilder()
    g = b.add_body(body_type=BodyType.STATIC)
    b.half_space(g, normal=(0, 1, 0))

    side = max(1, round(n_cubes ** (1.0 / 3.0)))
    ids = []
    k = 0
    y0 = half * 1.2
    for layer in range(math.ceil(n_cubes / (side * side))):
        for i in range(side):
            for j in range(side):
                if k >= n_cubes:
                    break
                jitter = rng.uniform(-0.05, 0.05, size=2) * half
                body = b.add_body(
                    pos=(
                        (i - side / 2) * sp + jitter[0],
                        y0 + layer * sp,
                        (j - side / 2) * sp + jitter[1],
                    )
                )
                b.box(body, half, half, half, friction=0.5)
                ids.append(body)
                k += 1
    world = b.finalize(
        max_bodies=n_cubes + 1,
        max_colliders=n_cubes + 1,
        max_contacts=max_contacts or max(8 * n_cubes, 64),
        device=device,
    )
    return world, ids


def stack3(device=None):
    """Three slightly offset unit cubes stacked on a ground plane: the
    ``stack3`` golden-trajectory scene. Returns (world, ids)."""
    b = SceneBuilder()
    g = b.add_body(body_type=BodyType.STATIC)
    b.half_space(g, normal=(0, 1, 0), friction=0.6)
    ids = []
    for i in range(3):
        body = b.add_body(pos=(0.1 * i, 0.55 + 1.02 * i, -0.05 * i))
        b.box(body, 0.5, 0.5, 0.5, friction=0.6)
        ids.append(body)
    world = b.finalize(
        max_bodies=4, max_colliders=4, max_contacts=32, device=device
    )
    return world, ids
