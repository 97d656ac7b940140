"""Scenes of the ported slices (port of ``avian_tpu/scenes.py::cube_pile``,
``box_pyramid``, ``many_pyramids`` and ``falling_hinges``, the ``stack3`` golden scene of
``tests/golden_common.py``, the mixed shapes of ``examples/many_shapes.py`` and
the cylinder stack of ``tests/test_shapes_convex.py``). ``device=None`` builds the world on the card
(``core.device.default_device``); pass ``device="cpu"`` for the CPU."""

import math

import numpy as np

from avian_tpu_torch.core.builder import SceneBuilder
from avian_tpu_torch.core.types import BodyType, JointType


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


def _pyramid_rows(b, base, half, x_off, y_off, z_off, planar):
    """One pyramid of ``base`` rows; returns the body ids."""
    size = 2.0 * half
    ids = []
    for row in range(base):
        n_in_row = base - row
        y = half + row * size + y_off
        x0 = x_off - 0.5 * n_in_row * size
        for i in range(n_in_row):
            p = (x0 + (i + 0.5) * size, y * 1.0001)
            if planar:
                # 2D profile: Z translation and X/Y rotation locked.
                body = b.add_body_2d(pos=p)
            else:
                body = b.add_body(pos=(p[0], p[1], z_off))
            b.box(body, half, half, half, friction=0.6)
            ids.append(body)
    return ids


def _finalize_boxes(b, ids, max_contacts, device):
    n = len(ids) + 1
    world = b.finalize(
        max_bodies=n, max_colliders=n,
        max_contacts=max_contacts or max(8 * n, 64), device=device,
    )
    return world, ids


def box_pyramid(base: int = 20, half: float = 0.5, dim3_depth: bool = False,
                max_contacts: int | None = None, device=None):
    """Box pyramid on a ground plane; ``base=100`` gives 5,050 boxes.

    ``dim3_depth=False``: the 2D profile (Z translation and X/Y rotation
    locked). ``dim3_depth=True``: the same planar layout with fully free 3D
    cubes. Returns (world, ids)."""
    b = SceneBuilder()
    g = b.add_body(body_type=BodyType.STATIC)
    b.half_space(g, normal=(0, 1, 0))
    ids = _pyramid_rows(b, base, half, 0.0, 0.0, 0.0, planar=not dim3_depth)
    return _finalize_boxes(b, ids, max_contacts, device)


def many_pyramids(grid: int = 10, base: int = 10, half: float = 0.5,
                  dim3: bool = False, max_contacts: int | None = None,
                  device=None):
    """A ``grid x grid`` field of base-``base`` pyramids (10 x 10 of base 10
    gives 5,500 boxes). ``dim3=False``: the 2D profile, pyramids tiled in
    the XY plane. ``dim3=True``: free 3D cubes, pyramids tiled over the XZ
    ground plane. Returns (world, ids)."""
    b = SceneBuilder()
    g = b.add_body(body_type=BodyType.STATIC)
    b.half_space(g, normal=(0, 1, 0))
    size = 2.0 * half
    spacing_x = base * size + 2.0
    ids = []
    for gx in range(grid):
        for gy in range(grid):
            x_off = (gx - grid / 2) * spacing_x
            y_off = 0.0 if dim3 else gy * (base * size + 1.0)
            z_off = (gy - grid / 2) * 4.0 if dim3 else 0.0
            ids += _pyramid_rows(b, base, half, x_off, y_off, z_off, planar=not dim3)
    return _finalize_boxes(b, ids, max_contacts, device)


def _hinge_rows(b, rows, cols, half, x0=0.0):
    """``rows x cols`` boxes with locked axes, each hinged to its neighbour
    in the row, left edge at ``x0 - cols * half``; returns the body ids."""
    size = 2.0 * half
    ids = []
    for r in range(rows):
        prev = None
        for c in range(cols):
            body = b.add_body_2d(
                pos=(x0 + c * size * 1.05 - 0.5 * cols * size, 2.0 + r * size * 1.2)
            )
            b.box(body, half, half, half, friction=0.6)
            ids.append(body)
            if prev is not None:
                b.add_joint(
                    JointType.REVOLUTE, prev, body,
                    anchor_a=(half, half, 0.0), anchor_b=(-half, half, 0.0),
                    basis_a=(0.0, 0.0, 0.0, 1.0), basis_b=(0.0, 0.0, 0.0, 1.0),
                )
            prev = body
    return ids


def _finalize_hinges(b, ids, n_joints, max_contacts, device):
    n = len(ids) + 1
    world = b.finalize(
        max_bodies=n, max_colliders=n, max_contacts=max_contacts or max(8 * n, 64),
        max_joints=max(n_joints, 1), device=device,
    )
    return world, ids


def falling_hinges(rows: int = 30, cols: int = 4, half: float = 0.25,
                   max_contacts: int | None = None, device=None):
    """Box2D's FallingHinges, the reference's cross-platform determinism
    scene (``src/tests/determinism_2d.rs:28-60``): ``rows x cols`` falling
    boxes with locked axes (the 2D profile) over a ground plane, each box
    hinged to its neighbour in the row by a revolute joint about Z. Returns
    (world, ids)."""
    b = SceneBuilder()
    g = b.add_body(body_type=BodyType.STATIC)
    b.half_space(g, normal=(0, 1, 0))
    ids = _hinge_rows(b, rows, cols, half)
    return _finalize_hinges(b, ids, rows * (cols - 1), max_contacts, device)


def hinge_blocks(blocks: int, rows: int = 30, cols: int = 4, half: float = 0.25,
                 max_contacts: int | None = None, device=None):
    """``blocks`` copies of ``falling_hinges(rows, cols)`` side by side over
    one ground plane, a box width apart: the reference's determinism scene at
    the scale of many bodies. ``hinge_blocks(1, ...)`` is
    ``falling_hinges(...)``. Returns (world, ids)."""
    b = SceneBuilder()
    g = b.add_body(body_type=BodyType.STATIC)
    b.half_space(g, normal=(0, 1, 0))
    size = 2.0 * half
    pitch = cols * size * 1.05 + size
    ids = []
    for k in range(blocks):
        ids += _hinge_rows(b, rows, cols, half, x0=(k - (blocks - 1) / 2) * pitch)
    return _finalize_hinges(b, ids, blocks * rows * (cols - 1), max_contacts, device)


def many_shapes(n: int = 150, per_row: int = 12, seed: int = 7,
                max_contacts: int | None = None, device=None):
    """Spheres, boxes, capsules, cylinders and cones (kinds in turn, body
    ``k`` of kind ``k % 5``) in layers of ``per_row x per_row`` 1.1 m apart,
    1.5 m between layers, the first 1 m above a ground plane: the layout of
    ``examples/many_shapes.py`` (its world leaf for leaf at ``n=150,
    per_row=12``, seed 7), centred the same way for a wider ``per_row``.
    Returns (world, ids)."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    g = b.add_body(body_type=BodyType.STATIC)
    b.half_space(g, normal=(0, 1, 0))
    x0 = -6.5 - (per_row - 12) * 0.55
    ids = []
    for k in range(n):
        x = (k % per_row) * 1.1 + x0 + rng.uniform(-0.05, 0.05)
        z = ((k // per_row) % per_row) * 1.1 + x0 + rng.uniform(-0.05, 0.05)
        y = 1.0 + (k // (per_row * per_row)) * 1.5
        body = b.add_body(pos=(x, y, z))
        kind = k % 5
        if kind == 0:
            b.sphere(body, 0.4)
        elif kind == 1:
            b.box(body, 0.35, 0.35, 0.35)
        elif kind == 2:
            b.capsule(body, 0.25, 0.5)
        elif kind == 3:
            b.cylinder(body, 0.3, 0.7)
        else:
            b.cone(body, 0.35, 0.7)
        ids.append(body)
    world = b.finalize(
        max_bodies=n + 1, max_colliders=n + 1,
        max_contacts=max_contacts or 8 * (n + 1), device=device,
    )
    return world, ids


def cylinder_stack(device=None):
    """Three upright cylinders (r 0.5, h 1) stacked on a ground plane,
    alternately 2 cm off axis, and a cone (r 0.5, h 1) resting on its base
    beside them: the world of ``tests/test_shapes_convex.py``. Returns
    (world, stack ids, cone id)."""
    b = SceneBuilder()
    g = b.add_body(body_type=BodyType.STATIC)
    b.half_space(g, normal=(0, 1, 0))
    stack = []
    for k in range(3):
        body = b.add_body(pos=(0.02 * (k % 2), 0.5 + 1.0 * k, 0))
        b.cylinder(body, 0.5, 1.0)
        stack.append(body)
    cone = b.add_body(pos=(3.0, 0.55, 0))
    b.cone(cone, 0.5, 1.0)
    world = b.finalize(max_bodies=8, max_colliders=8, max_contacts=64, device=device)
    return world, stack, cone
