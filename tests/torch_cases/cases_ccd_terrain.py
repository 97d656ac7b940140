"""Swept CCD on the terrain against the JAX reference: ``scenes.terrain_ccd``
(300 bodies of ``terrain_shapes``' seven kinds on a 17 x 17 heightfield, 512
triangles, and 4 bullets, 2 spheres swept linearly and 2 spinning capsules
swept nonlinearly) against the world its construction builds with the
reference's builder, leaf for leaf, and ``solve_swept_ccd`` on one solver
state (two steps' delta pose at each body's velocities) by both packages,
through ``cases_ccd.check_swept_ccd``: the swept colliders exactly, the
scaled delta positions within ``cases_ccd.CCD_TOL``.

The reference compiles every shape pair of the bullets against the
terrain's shapes (``TERRAIN_PAIRS``), seven of them support-map pipelines;
that compile took most of this file's minute, so the sweep is read from
``ccd_terrain_reference.npz`` (``port_common.Recording``; rerecord with
``record_references.py cases_ccd_terrain.py``), and the world built with the
reference's builder is the file's live reference case."""

from port_common import ieee_reference

ieee_reference()

import numpy as np  # noqa: E402

from avian_tpu import BodyType, SceneBuilder as JBuilder  # noqa: E402
from avian_tpu_torch import scenes  # noqa: E402

from cases_ccd import check_swept_ccd  # noqa: E402
from port_common import Recording, assert_worlds_equal  # noqa: E402

# Bullets (spheres, capsules) against the terrain's shapes.
TERRAIN_PAIRS = ((0, 0), (0, 1), (0, 2), (0, 4), (0, 5), (0, 8), (1, 1), (1, 2), (1, 4), (1, 5),
                 (1, 8))
WORLD = dict(n=300, per_row=12, bullets=4, seed=7, field=17)


def _j_terrain_ccd(n, per_row, bullets, seed, field):
    """``scenes.terrain_ccd``' world built with the reference's builder."""
    rng = np.random.default_rng(seed)
    heights = scenes.terrain_heights(field)
    b = JBuilder()
    ground = b.add_body(body_type=BodyType.STATIC)
    b.heightfield(ground, heights, float(field - 1), float(field - 1))
    x0 = -6.5 - (per_row - 12) * 0.55
    for k in range(n):
        x = (k % per_row) * 1.1 + x0 + rng.uniform(-0.05, 0.05)
        z = ((k // per_row) % per_row) * 1.1 + x0 + rng.uniform(-0.05, 0.05)
        y = float(scenes.terrain_height_at(heights, x, z)) + 1.0 + (k // (per_row * per_row)) * 1.5
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
            p = rng.normal(size=(12, 3))
            b.convex_hull(body, (0.4 * p / np.linalg.norm(p, axis=1, keepdims=True)).astype(np.float32))
        else:
            b.round_cuboid(body, 0.5, 0.5, 0.5, 0.05)
    reach = min(20.0, 0.4 * (field - 1))
    for k in range(bullets):
        x, z = rng.uniform(-reach, reach, size=2)
        vx, vz = rng.uniform(-3.0, 3.0, size=2)
        y = float(scenes.terrain_height_at(heights, x, z)) + scenes.BULLET_HEIGHT
        vel = (float(vx), -scenes.BULLET_SPEED, float(vz))
        if k % 2 == 0:
            body = b.add_body(pos=(x, y, z), lin_vel=vel, swept_ccd=True)
            b.sphere(body, 0.1, speculative_margin=0.05)
        else:
            q = rng.normal(size=4)
            axis = rng.normal(size=3)
            spin = scenes.BULLET_SPIN * axis / np.linalg.norm(axis)
            body = b.add_body(pos=(x, y, z), quat=tuple(q / np.linalg.norm(q)), lin_vel=vel,
                              ang_vel=tuple(spin), swept_ccd=True, swept_ccd_nonlinear=True)
            b.capsule(body, 0.05, 0.4, speculative_margin=0.05)
    nb = n + bullets
    return b.finalize(max_bodies=nb + 1, max_colliders=nb + 2 * (field - 1) ** 2,
                      max_contacts=8 * (nb + 1))


def test_terrain_ccd_builds_the_reference_s_world():
    port, ids, shots = scenes.terrain_ccd(**WORLD, device="cpu")
    assert_worlds_equal(_j_terrain_ccd(**WORLD), port)
    assert ids == list(range(1, 301)) and shots == [301, 302, 303, 304]


def test_solve_swept_ccd_matches_reference_on_the_terrain():
    """max_swept_colliders = 4: the reference computes all K rows of its grid
    however many are flagged, and 4 keep its run short. Three of the four
    bullets reach the pile or the field within the sweep."""
    rewound, swept = check_swept_ccd(_j_terrain_ccd(**WORLD), TERRAIN_PAIRS, 4, 2.0 / 60.0,
                                     seed=7, recording=Recording("ccd_terrain"))
    assert swept == 4 and int(rewound[301:305].sum()) == 3
