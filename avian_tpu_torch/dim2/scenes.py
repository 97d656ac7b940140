"""2D scenes (port of ``avian_tpu/dim2/scenes.py``): the reference's Large
Pyramid 2D and Many Pyramids 2D, Box2D's FallingHinges on the 2D engine
(``falling_hinges_2d``, and ``hinge_blocks_2d``, copies of it side by side)
and the pyramid with swept bullets (``pyramid_ccd_2d``). Each takes
``max_contacts`` (default the reference's ``max(8 * n, 64)``) and
``device`` (``None`` builds on the card; pass ``device="cpu"`` for the CPU),
as the 3D ``scenes`` do. Returns ``(world, ids)``, and the bullets' ids
too for ``pyramid_ccd_2d``."""

import numpy as np

from avian_tpu_torch.core.types import BodyType, JointType
from avian_tpu_torch.dim2.builder import SceneBuilder2D

# pyramid_ccd_2d's bullets: start height above the apex (m), speed (m/s),
# the capsules' spin (rad/s) and the share of the base they are spread over.
BULLET_HEIGHT, BULLET_SPEED, BULLET_SPIN, BULLET_SPREAD = 12.0, 300.0, 40.0, 0.9


def _ground():
    b = SceneBuilder2D()
    g = b.add_body(body_type=BodyType.STATIC)
    b.half_space(g, normal=(0, 1), friction=0.6)
    return b


def _rows(b, base, half, ox, ids):
    for row in range(base):
        cols = base - row
        for c in range(cols):
            x = ox + (c - cols / 2.0) * 1.001 * 2 * half
            y = half * 1.001 + row * 2 * half * 1.001
            body = b.add_body(pos=(x, y))
            b.box(body, half, half, friction=0.6)
            ids.append(body)


def _finalize(b, ids, max_contacts, device):
    n = len(ids) + 1
    world = b.finalize(max_bodies=n, max_colliders=n,
                       max_contacts=max_contacts or max(8 * n, 64), device=device)
    return world, ids


def box_pyramid_2d(base: int = 100, half: float = 0.5, max_contacts: int | None = None,
                   device=None):
    """Large Pyramid 2D: rows of ``base`` .. 1 boxes, ``base * (base + 1) / 2``
    in all (``benches/src/dim2/large_pyramid.rs:6-39``)."""
    b = _ground()
    ids = []
    _rows(b, base, half, 0.0, ids)
    return _finalize(b, ids, max_contacts, device)


def many_pyramids_2d(grid: int = 10, base: int = 10, half: float = 0.5,
                     max_contacts: int | None = None, device=None):
    """Many Pyramids 2D: ``grid * grid`` base-``base`` pyramids in one row
    (``benches/src/dim2/mod.rs:17-24``)."""
    b = _ground()
    ids = []
    spacing = (base + 4) * 2 * half
    for gx in range(grid * grid):
        _rows(b, base, half, (gx - grid * grid / 2.0) * spacing, ids)
    return _finalize(b, ids, max_contacts, device)


def _hinge_rows(b, rows, cols, half, x0=0.0):
    """FallingHinges' boxes (``avian_tpu/scenes.py:147-179`` on the 2D
    builder): ``rows`` rows of ``cols`` boxes, each hinged to its neighbour in
    the row at their top corners."""
    size = 2.0 * half
    ids = []
    for r in range(rows):
        prev = None
        for c in range(cols):
            body = b.add_body(pos=(x0 + c * size * 1.05 - 0.5 * cols * size, 2.0 + r * size * 1.2))
            b.box(body, half, half, friction=0.6)
            ids.append(body)
            if prev is not None:
                b.add_joint(JointType.REVOLUTE, prev, body, anchor_a=(half, half),
                            anchor_b=(-half, half))
            prev = body
    return ids


def _finalize_hinges(b, ids, n_joints, max_contacts, device):
    n = len(ids) + 1
    world = b.finalize(max_bodies=n, max_colliders=n, max_contacts=max_contacts or max(8 * n, 64),
                       max_joints=max(n_joints, 1), device=device)
    return world, ids


def falling_hinges_2d(rows: int = 30, cols: int = 4, half: float = 0.25,
                      max_contacts: int | None = None, device=None):
    """Box2D's FallingHinges, the reference's cross-platform determinism
    scene (``src/tests/determinism_2d.rs:28-60``), on the 2D engine:
    ``rows x cols`` falling boxes over a ground half-space, each hinged to its
    neighbour in the row by a revolute joint."""
    b = SceneBuilder2D()
    g = b.add_body(body_type=BodyType.STATIC)
    b.half_space(g, normal=(0, 1))
    ids = _hinge_rows(b, rows, cols, half)
    return _finalize_hinges(b, ids, rows * (cols - 1), max_contacts, device)


def hinge_blocks_2d(blocks: int, rows: int = 30, cols: int = 4, half: float = 0.25,
                    max_contacts: int | None = None, device=None):
    """``blocks`` copies of ``falling_hinges_2d(rows, cols)`` side by side over
    one ground half-space, a box width apart (the 3D ``scenes.hinge_blocks``'s
    layout). ``hinge_blocks_2d(1, ...)`` is ``falling_hinges_2d(...)``."""
    b = SceneBuilder2D()
    g = b.add_body(body_type=BodyType.STATIC)
    b.half_space(g, normal=(0, 1))
    size = 2.0 * half
    pitch = cols * size * 1.05 + size
    ids = []
    for k in range(blocks):
        ids += _hinge_rows(b, rows, cols, half, x0=(k - (blocks - 1) / 2) * pitch)
    return _finalize_hinges(b, ids, blocks * rows * (cols - 1), max_contacts, device)


def pyramid_ccd_2d(base: int = 100, bullets: int = 32, half: float = 0.5,
                   max_contacts: int | None = None, device=None):
    """``box_pyramid_2d(base)`` and ``bullets`` swept bodies fired down into
    it (``tests/test_dim2_api.py:192-231``'s bullets at the scale of the 3D
    ``scenes.terrain_ccd``), each with a speculative margin of 0.05 m: even
    ones circles of radius 0.1 with ``swept_ccd`` (the linear sweep), odd
    ones capsules of radius 0.05 and length 0.4 with
    ``swept_ccd_nonlinear`` too, spinning at 40 rad/s. They start 12 m above
    the apex, evenly spread over the middle 90% of the base (90 m at base
    100), and fly straight down at 300 m/s (5 m a step at 60 Hz). Returns
    (world, ids of the boxes, ids of the bullets)."""
    b = _ground()
    ids = []
    _rows(b, base, half, 0.0, ids)
    top = half * 1.001 + (base - 1) * 2 * half * 1.001 + half
    reach = 0.5 * BULLET_SPREAD * base * 2 * half * 1.001
    shots = []
    for k, x in enumerate(np.linspace(-reach, reach, bullets)):
        pos, vel = (float(x), top + BULLET_HEIGHT), (0.0, -BULLET_SPEED)
        if k % 2 == 0:
            body = b.add_body(pos=pos, lin_vel=vel, swept_ccd=True)
            b.circle(body, 0.1, speculative_margin=0.05)
        else:
            body = b.add_body(pos=pos, lin_vel=vel, ang_vel=BULLET_SPIN, swept_ccd=True,
                              swept_ccd_nonlinear=True)
            b.capsule(body, 0.05, 0.4, speculative_margin=0.05)
        shots.append(body)
    world, _ = _finalize(b, ids + shots, max_contacts, device)
    return world, ids, shots
