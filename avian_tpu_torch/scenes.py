"""Scenes of the ported slices (port of ``avian_tpu/scenes.py::cube_pile``,
``box_pyramid``, ``many_pyramids`` and ``falling_hinges``, the ``stack3`` golden scene of
``tests/golden_common.py``, the mixed shapes of ``examples/many_shapes.py``,
the cylinder stack of ``tests/test_shapes_convex.py``, the worlds of
``examples/trimesh_shapes_3d.py``, ``examples/voxels_3d.py`` and
``tests/test_convex_hull.py``, mixed shapes, rocks and round cuboids on
a heightfield, the same with swept bullets fired into it, and the
reference's ``ccd_stress``). ``device=None`` builds the world on the card
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


def trimesh_valley(device=None):
    """Two balls (r 0.4, friction 0.1) dropped onto a static V-shaped
    trimesh of four triangles: the world of ``examples/trimesh_shapes_3d.py``.
    Returns (world, ball ids)."""
    verts = np.asarray(
        [[-4.0, 2.0, -4.0], [0.0, 0.0, -4.0], [4.0, 2.0, -4.0],
         [-4.0, 2.0, 4.0], [0.0, 0.0, 4.0], [4.0, 2.0, 4.0]], np.float32)
    faces = np.asarray([[0, 1, 3], [1, 4, 3], [1, 2, 4], [2, 5, 4]], np.int32)
    b = SceneBuilder()
    mesh = b.add_body(body_type=BodyType.STATIC)
    b.trimesh(mesh, verts, faces, friction=0.1)
    balls = []
    for x in (-2.5, 2.0):
        body = b.add_body(pos=(x, 4.0, 0.0))
        b.sphere(body, 0.4, friction=0.1)
        balls.append(body)
    world = b.finalize(max_bodies=4, max_colliders=8, max_contacts=64, device=device)
    return world, balls


def voxel_stairs(device=None):
    """A ball (r 0.4) dropped onto a staircase of unit voxels (column x
    filled up to height x, 3 deep): the world of ``examples/voxels_3d.py``.
    Returns (world, ball id)."""
    occ = np.zeros((4, 4, 3), bool)
    for x in range(4):
        occ[x, : x + 1, :] = True
    b = SceneBuilder()
    vox = b.add_body(body_type=BodyType.STATIC)
    b.voxels(vox, occ, voxel_size=1.0, origin=(0.0, 0.0, 0.0))
    ball = b.add_body(pos=(1.5, 5.0, 1.5))
    b.sphere(ball, 0.4)
    world = b.finalize(max_bodies=4, max_colliders=64, max_contacts=256, device=device)
    return world, ball


def _cube_points(h=0.5):
    return [(sx * h, sy * h, sz * h) for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]


def hull_stack(single: bool = False, device=None):
    """Convex hulls on a ground plane, the worlds of
    ``tests/test_convex_hull.py``: with ``single``, one hull of a unit
    cube's corners dropped from 0.8 m; else two such hulls stacked (the
    upper 5 cm off axis) and an octahedron hull (r 0.6) beside them.
    Returns (world, ids): the hull bodies, lower first."""
    b = SceneBuilder()
    g = b.add_body(body_type=BodyType.STATIC)
    b.half_space(g, normal=(0, 1, 0))
    if single:
        body = b.add_body(pos=(0, 0.8, 0))
        b.convex_hull(body, _cube_points(0.5))
        return b.finalize(max_bodies=4, max_colliders=4, max_contacts=16, device=device), [body]
    ids = []
    for pos in ((0, 0.55, 0), (0.05, 1.6, 0)):
        ids.append(b.add_body(pos=pos))
        b.convex_hull(ids[-1], _cube_points(0.5))
    ids.append(b.add_body(pos=(3.0, 0.7, 0)))
    r = 0.6
    b.convex_hull(ids[-1], [(r, 0, 0), (-r, 0, 0), (0, r, 0), (0, -r, 0), (0, 0, r), (0, 0, -r)])
    return b.finalize(max_bodies=6, max_colliders=6, max_contacts=64, device=device), ids


def terrain_heights(field: int = 65):
    """Heights f32[field, field] of ``terrain_shapes``' ground, 1 m apart
    over ``field - 1`` metres: the ripple of
    ``tests/test_trimesh.py::test_box_pile_on_heightfield``, ``0.3 sin(u)
    cos(v)`` with u and v running 0..3 across the field, plus a bowl
    ``0.004 (x^2 + z^2)`` that rises toward the edges."""
    half = (field - 1) / 2.0
    xs = np.linspace(-half, half, field)
    ripple = 0.3 * np.sin(np.linspace(0, 3, field))[:, None] * np.cos(np.linspace(0, 3, field))[None, :]
    return (ripple + 0.004 * (xs[:, None] ** 2 + xs[None, :] ** 2)).astype(np.float32)


def terrain_height_at(heights, x, z):
    """The height of the triangulated field ``heights`` (1 m apart, centred
    on the origin, the builder's two triangles a cell) at points ``x``,
    ``z`` (numpy arrays), interpolated on the triangle under each point."""
    field = heights.shape[0]
    half = (field - 1) / 2.0
    gx = np.clip(np.asarray(x, np.float64) + half, 0.0, field - 1 - 1e-9)
    gz = np.clip(np.asarray(z, np.float64) + half, 0.0, field - 1 - 1e-9)
    i, k = np.floor(gx).astype(np.int64), np.floor(gz).astype(np.int64)
    u, v = gx - i, gz - k
    h = heights.astype(np.float64)
    h00, h10, h01, h11 = h[i, k], h[i + 1, k], h[i, k + 1], h[i + 1, k + 1]
    lower = h00 + u * (h10 - h00) + v * (h01 - h00)  # triangle (i,k) (i+1,k) (i,k+1)
    upper = h11 + (1.0 - u) * (h01 - h11) + (1.0 - v) * (h10 - h11)
    return np.where(u + v <= 1.0, lower, upper)


def _rock(b, body, rng):
    """A convex hull of 12 points on a sphere of radius 0.4."""
    p = rng.normal(size=(12, 3))
    p = 0.4 * p / np.linalg.norm(p, axis=1, keepdims=True)
    b.convex_hull(body, p.astype(np.float32))


def _terrain_pile(b, n, per_row, rng, heights):
    """``terrain_shapes``' ground and bodies, added to builder ``b``;
    returns the bodies' ids."""
    field = heights.shape[0]
    ground = b.add_body(body_type=BodyType.STATIC)
    b.heightfield(ground, heights, float(field - 1), float(field - 1))
    x0 = -6.5 - (per_row - 12) * 0.55
    ids = []
    for k in range(n):
        x = (k % per_row) * 1.1 + x0 + rng.uniform(-0.05, 0.05)
        z = ((k // per_row) % per_row) * 1.1 + x0 + rng.uniform(-0.05, 0.05)
        y = float(terrain_height_at(heights, x, z)) + 1.0 + (k // (per_row * per_row)) * 1.5
        body = b.add_body(pos=(x, y, z))
        kind = k % 7
        if kind == 0:
            b.sphere(body, 0.4)
        elif kind == 1:
            b.box(body, 0.35, 0.35, 0.35)
        elif kind == 2:
            b.capsule(body, 0.25, 0.5)
        elif kind == 3:
            b.cylinder(body, 0.3, 0.7)
        elif kind == 4:
            b.cone(body, 0.35, 0.7)
        elif kind == 5:
            _rock(b, body, rng)
        else:
            b.round_cuboid(body, 0.5, 0.5, 0.5, 0.05)
        ids.append(body)
    return ids


def terrain_shapes(n: int = 10_000, per_row: int = 48, seed: int = 7, field: int = 65,
                   max_contacts: int | None = None, device=None):
    """Mixed shapes over a static heightfield: ``field x field`` heights 1 m
    apart (``terrain_heights``; 65 gives 8,192 triangles over 64 m x 64 m),
    and ``n`` bodies in ``many_shapes``' layout (rows of ``per_row`` 1.1 m
    apart, layers 1.5 m apart), each starting 1 m plus 1.5 m per layer above
    the field at its (x, z). Body ``k`` is of kind ``k % 7``: the five
    shapes of ``examples/many_shapes.py`` (sphere r 0.4, box 0.35, capsule r
    0.25 l 0.5, cylinder r 0.3 h 0.7, cone r 0.35 h 0.7), a rock (the hull
    of 12 points on a sphere of radius 0.4, drawn from ``seed``) and a round
    cuboid (0.5 m inner sides, 0.05 m border). Returns (world, ids)."""
    rng = np.random.default_rng(seed)
    heights = terrain_heights(field)
    b = SceneBuilder()
    ids = _terrain_pile(b, n, per_row, rng, heights)
    m = n + 2 * (field - 1) ** 2
    world = b.finalize(max_bodies=n + 1, max_colliders=m,
                       max_contacts=max_contacts or 8 * (n + 1), device=device)
    return world, ids


BULLET_HEIGHT, BULLET_SPEED, BULLET_SPIN = 12.0, 300.0, 40.0


def terrain_ccd(n: int = 10_000, per_row: int = 48, bullets: int = 32, seed: int = 7,
                field: int = 65, max_contacts: int | None = None, device=None):
    """The swept-CCD world at full width: ``terrain_shapes(n, per_row, seed,
    field)``'s world (the same bodies from the same draws) plus ``bullets``
    swept bodies fired down into it, every one with a speculative margin of
    0.05 m as in ``tests/test_scenes.py:77-97``. Even bullets are spheres of
    radius 0.1 with ``swept_ccd`` (the linear sweep); odd ones are capsules
    of radius 0.05 and length 0.4 with ``swept_ccd_nonlinear`` too, tilted
    by a seeded rotation and spinning at 40 rad/s about a seeded axis. Each
    starts 12 m above the field at a seeded (x, z) over the pile and flies
    down at 300 m/s (5 m a step at 60 Hz) with a seeded horizontal part of
    at most 3 m/s. Returns (world, ids of the pile's bodies, ids of the
    bullets)."""
    rng = np.random.default_rng(seed)
    heights = terrain_heights(field)
    b = SceneBuilder()
    ids = _terrain_pile(b, n, per_row, rng, heights)
    reach = min(20.0, 0.4 * (field - 1))
    shots = []
    for k in range(bullets):
        x, z = rng.uniform(-reach, reach, size=2)
        vx, vz = rng.uniform(-3.0, 3.0, size=2)
        y = float(terrain_height_at(heights, x, z)) + BULLET_HEIGHT
        vel = (float(vx), -BULLET_SPEED, float(vz))
        if k % 2 == 0:
            body = b.add_body(pos=(x, y, z), lin_vel=vel, swept_ccd=True)
            b.sphere(body, 0.1, speculative_margin=0.05)
        else:
            q = rng.normal(size=4)
            axis = rng.normal(size=3)
            spin = BULLET_SPIN * axis / np.linalg.norm(axis)
            body = b.add_body(pos=(x, y, z), quat=tuple(q / np.linalg.norm(q)), lin_vel=vel,
                              ang_vel=tuple(spin), swept_ccd=True, swept_ccd_nonlinear=True)
            b.capsule(body, 0.05, 0.4, speculative_margin=0.05)
        shots.append(body)
    n_bodies = n + bullets
    m = n_bodies + 2 * (field - 1) ** 2
    world = b.finalize(max_bodies=n_bodies + 1, max_colliders=m,
                       max_contacts=max_contacts or 8 * (n_bodies + 1), device=device)
    return world, ids, shots


def ccd_stress(n_bullets: int = 32, speed: float = 80.0, device=None):
    """Fast spheres shot at a thin wall (port of the reference's
    ``scenes.ccd_stress``, BASELINE config 4: speculative contacts only).
    Returns (world, ids)."""
    b = SceneBuilder()
    wall = b.add_body(body_type=BodyType.STATIC, pos=(5.0, 0.0, 0.0))
    b.box(wall, 0.05, 10.0, 10.0)
    g = b.add_body(body_type=BodyType.STATIC, pos=(0, -10.0, 0))
    b.half_space(g, normal=(0, 1, 0))
    ids = []
    for k in range(n_bullets):
        body = b.add_body(
            pos=(0.0, (k % 8) * 0.5 - 2.0, (k // 8) * 0.5 - 1.0),
            lin_vel=(speed, 0.0, 0.0),
        )
        b.sphere(body, 0.1, restitution=0.1)
        ids.append(body)
    n = n_bullets + 2
    world = b.finalize(max_bodies=n, max_colliders=n, max_contacts=max(8 * n, 64),
                       device=device)
    return world, ids
