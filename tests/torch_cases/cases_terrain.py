"""The hull-and-terrain path against the JAX reference: the builder's
segments, triangles, trimeshes, heightfields, voxels, convex hulls and round
cuboids leaf for leaf (vertex pool, params, mass, inertia, centre of mass),
their world AABBs within 1e-6, the scenes ``trimesh_valley``,
``voxel_stairs``, ``hull_stack`` and a small ``terrain_shapes`` against the
worlds of their sources leaf for leaf, and full ``physics_step``s within
1e-4: the small terrain (a 6 x 6 heightfield, 50 triangles, 14 bodies of
all seven kinds) from its start and from the state the reference reaches
after 45 steps of its own, landed on the triangles, ``tests/test_trimesh.py``'s ramp and
``tests/test_convex_hull.py``'s hull stack from their start and once
landed.

The reference is compiled one IEEE operation at a time
(``port_common.ieee_reference``), once: every stepped world has the same
capacities, pool size and ``shape_pairs`` (``STEP_PAIRS``, what these
steps produce). The port's step evaluates every pair it meets, so a pair
missing from that list would show as a difference."""

from port_common import ieee_reference

ieee_reference()

from functools import partial  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from avian_tpu import BodyType, SceneBuilder as JBuilder  # noqa: E402
from avian_tpu.core.config import PhysicsConfig as JConfig  # noqa: E402
from avian_tpu.geometry import shapes as jshapes  # noqa: E402
from avian_tpu.pipeline.step import physics_step as j_step  # noqa: E402
from avian_tpu_torch import physics_step, scenes  # noqa: E402
from avian_tpu_torch.core.builder import SceneBuilder as TBuilder  # noqa: E402
from avian_tpu_torch.core.config import PhysicsConfig as TConfig  # noqa: E402
from avian_tpu_torch.geometry import shapes as tshapes  # noqa: E402

from port_common import as_numpy, assert_worlds_equal, quats, to_torch  # noqa: E402

STEP_TOL = 1e-4
AABB_TOL = 1e-6
MAX_COLORS = 6
# Every pool-backed convex shape's pair that the stepped worlds produce:
# each shape on the field's triangles, hulls on a half-space and on hulls.
STEP_PAIRS = ((0, 8), (1, 8), (2, 8), (3, 8), (4, 8), (5, 8), (8, 8))
CAPACITY = dict(max_bodies=16, max_colliders=64, max_contacts=128)
POOL_ROWS = 256
_J_STEP = jax.jit(partial(j_step, return_diagnostics=True), static_argnums=1)
_J_CONFIG = JConfig(max_colors=MAX_COLORS, shape_pairs=STEP_PAIRS)
_T_CONFIG = TConfig(max_colors=MAX_COLORS)


# ---- the seven constructors -------------------------------------------------

def _cloud(seed, n, radius):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(n, 3))
    return (radius * p / np.linalg.norm(p, axis=1, keepdims=True)).astype(np.float32)


def _segment(b):
    ground = b.add_body(body_type=BodyType.STATIC)
    b.segment(ground, (-1.0, 0.2, 0.5), (2.0, 0.4, -0.5))
    b.segment(ground, (1.0, 0.0, 0.0), (-1.0, 0.0, 0.0))  # reversed: 180 degrees about Z
    rod = b.add_body(pos=(0.0, 2.0, 0.0))
    b.segment(rod, (0.0, -0.5, 0.0), (0.0, 0.5, 0.0), local_pos=(0.1, 0.0, 0.0))
    b.sphere(rod, 0.2, local_pos=(0.0, 0.5, 0.0))


def _triangle(b):
    ground = b.add_body(body_type=BodyType.STATIC)
    b.triangle(ground, (0.0, 0.0, 0.0), (2.0, 0.1, 0.0), (0.5, -0.1, 1.5), friction=0.3)
    body = b.add_body(pos=(1.0, 2.0, 0.0))
    b.triangle(body, (5.0, 0.0, 0.0), (6.0, 0.0, 0.0), (5.0, 0.0, 1.0), local_pos=(0.0, 1.0, 0.0))
    b.box(body, 0.3, 0.2, 0.1)


def _trimesh(b):
    ground = b.add_body(body_type=BodyType.STATIC)
    v = [(-2, 0.0, -2), (2, 0.8, -2), (2, 0.8, 2), (-2, 0.0, 2), (0, 1.5, 0)]
    b.trimesh(ground, v, [(0, 1, 2), (0, 2, 3), (0, 1, 4), (1, 2, 4)], friction=0.8)


def _heightfield(b):
    ground = b.add_body(body_type=BodyType.STATIC, pos=(1.0, -0.5, 0.0))
    hf = np.random.default_rng(4).uniform(-0.3, 0.3, (4, 5))
    b.heightfield(ground, hf, 6.0, 8.0)


def _voxels(b):
    occ = np.zeros((4, 4, 3), bool)
    for x in range(4):
        occ[x, : x + 1, :] = True
    ground = b.add_body(body_type=BodyType.STATIC)
    b.voxels(ground, occ, voxel_size=0.5, origin=(-1.0, 0.0, -0.5), local_pos=(0.0, 0.2, 0.0))


def _convex_hull(b):
    rock = b.add_body(pos=(0.0, 2.0, 0.0))
    b.convex_hull(rock, _cloud(1, 12, 0.4) + np.float32([0.1, 0.0, -0.2]), density=2.5)
    ball = b.add_body(pos=(2.0, 2.0, 0.0))  # 60 points: simplified to 32 vertices
    b.convex_hull(ball, _cloud(2, 60, 0.5), local_pos=(0.0, 0.3, 0.0))
    b.sphere(ball, 0.2, local_pos=(0.0, -0.3, 0.0))


def _round_cuboid(b):
    body = b.add_body(pos=(0.0, 0.8, 0.0))
    b.round_cuboid(body, 1.0, 0.6, 0.8, 0.1, density=3.0)
    other = b.add_body(pos=(2.0, 0.8, 0.0))
    b.round_cuboid(other, 0.5, 0.5, 0.5, 0.05, local_pos=(0.2, 0.0, 0.0))
    b.box(other, 0.2, 0.2, 0.2, local_pos=(-0.3, 0.0, 0.0))


CONSTRUCTORS = {"segment": _segment, "triangle": _triangle, "trimesh": _trimesh,
                "heightfield": _heightfield, "voxels": _voxels, "convex_hull": _convex_hull,
                "round_cuboid": _round_cuboid}


@pytest.mark.parametrize("name", list(CONSTRUCTORS))
def test_builder_worlds_match_reference(name):
    jb, tb = JBuilder(), TBuilder()
    CONSTRUCTORS[name](jb)
    CONSTRUCTORS[name](tb)
    ref = jb.finalize(max_contacts=64)
    port = tb.finalize(max_contacts=64, device="cpu")
    assert_worlds_equal(ref, port)
    # World AABBs of these colliders at random poses, the reference's.
    col = port.colliders
    rng = np.random.default_rng(9)
    m = col.capacity
    pos = rng.uniform(-3.0, 3.0, (m, 3)).astype(np.float32)
    quat = quats(rng, m, 1.0)
    st, prm = as_numpy(col.shape_type), as_numpy(col.params)
    want = jax.jit(jshapes.world_aabb)(st, prm, pos, quat)
    got = tshapes.world_aabb(*(torch.from_numpy(x) for x in (st, prm, pos, quat)))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=AABB_TOL, rtol=0)


def test_hull_mass_properties_and_pool_layout():
    """A hull of a cube's corners gets the box's mass and inertia; a round
    cuboid the Steiner volume (``tests/test_round_shapes.py``); every pool
    ends in 32 zero rows."""
    b = TBuilder()
    hull = b.add_body()
    b.convex_hull(hull, [(sx * 0.5, sy * 0.5, sz * 0.5)
                         for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])
    box = b.add_body()
    b.box(box, 0.5, 0.5, 0.5)
    rc = b.add_body()
    b.round_cuboid(rc, 1.0, 1.0, 1.0, 0.1)
    w = b.finalize(device="cpu")
    inv_m = w.bodies.inv_mass.numpy()
    np.testing.assert_allclose(inv_m[hull], inv_m[box], rtol=1e-4)
    np.testing.assert_allclose(w.bodies.inv_inertia.numpy()[hull], w.bodies.inv_inertia.numpy()[box],
                               rtol=1e-3, atol=1e-6)
    h, r = 0.5, 0.1
    vol = 8 * h**3 + 24 * h * h * r + 6 * np.pi * h * r * r + 4.0 / 3.0 * np.pi * r**3
    assert abs(1.0 / inv_m[rc] - vol) / vol < 1e-3
    pool = w.convex_verts.numpy()
    assert pool.shape == (8 + 8 + 32, 3) and not pool[-32:].any()


# ---- scenes -----------------------------------------------------------------

def _j_terrain(n, per_row, seed, field, **finalize_kw):
    """``scenes.terrain_shapes``' world built with the reference's builder."""
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
    kw = dict(max_bodies=n + 1, max_colliders=n + 2 * (field - 1) ** 2, max_contacts=8 * (n + 1))
    kw.update(finalize_kw)
    return b.finalize(**kw)


def _j_trimesh_valley():
    """``examples/trimesh_shapes_3d.py``'s world."""
    verts = np.asarray([[-4.0, 2.0, -4.0], [0.0, 0.0, -4.0], [4.0, 2.0, -4.0],
                        [-4.0, 2.0, 4.0], [0.0, 0.0, 4.0], [4.0, 2.0, 4.0]], np.float32)
    faces = np.asarray([[0, 1, 3], [1, 4, 3], [1, 2, 4], [2, 5, 4]], np.int32)
    b = JBuilder()
    mesh = b.add_body(body_type=BodyType.STATIC)
    b.trimesh(mesh, verts, faces, friction=0.1)
    for x in (-2.5, 2.0):
        body = b.add_body(pos=(x, 4.0, 0.0))
        b.sphere(body, 0.4, friction=0.1)
    return b.finalize(max_bodies=4, max_colliders=8, max_contacts=64)


def _j_voxel_stairs():
    """``examples/voxels_3d.py``'s world."""
    occ = np.zeros((4, 4, 3), bool)
    for x in range(4):
        occ[x, : x + 1, :] = True
    b = JBuilder()
    vox = b.add_body(body_type=BodyType.STATIC)
    b.voxels(vox, occ, voxel_size=1.0, origin=(0.0, 0.0, 0.0))
    ball = b.add_body(pos=(1.5, 5.0, 1.5))
    b.sphere(ball, 0.4)
    return b.finalize(max_bodies=4, max_colliders=64, max_contacts=256)


def _cube(h=0.5):
    return [(sx * h, sy * h, sz * h) for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]


def _j_hull_stack(single=False, **finalize_kw):
    """``tests/test_convex_hull.py``'s worlds."""
    b = JBuilder()
    g = b.add_body(body_type=BodyType.STATIC)
    b.half_space(g, normal=(0, 1, 0))
    if single:
        body = b.add_body(pos=(0, 0.8, 0))
        b.convex_hull(body, _cube(0.5))
        kw = dict(max_bodies=4, max_colliders=4, max_contacts=16)
    else:
        lower = b.add_body(pos=(0, 0.55, 0))
        b.convex_hull(lower, _cube(0.5))
        upper = b.add_body(pos=(0.05, 1.6, 0))
        b.convex_hull(upper, _cube(0.5))
        octa = b.add_body(pos=(3.0, 0.7, 0))
        r = 0.6
        b.convex_hull(octa, [(r, 0, 0), (-r, 0, 0), (0, r, 0), (0, -r, 0), (0, 0, r), (0, 0, -r)])
        kw = dict(max_bodies=6, max_colliders=6, max_contacts=64)
    kw.update(finalize_kw)
    return b.finalize(**kw)


def _j_ramp(**finalize_kw):
    """``tests/test_trimesh.py::test_box_rests_on_triangulated_ramp``'s world."""
    b = JBuilder()
    ground = b.add_body(body_type=BodyType.STATIC)
    v = [(-2, 0.0, -2), (2, 0.8, -2), (2, 0.8, 2), (-2, 0.0, 2)]
    b.trimesh(ground, v, [(0, 1, 2), (0, 2, 3)], friction=0.8)
    box = b.add_body(pos=(0.0, 2.0, 0.0))
    b.box(box, 0.3, 0.3, 0.3, friction=0.8)
    kw = dict(max_bodies=4, max_colliders=4, max_contacts=32)
    kw.update(finalize_kw)
    return b.finalize(**kw)


def test_scenes_match_their_sources_leaf_for_leaf():
    port, balls = scenes.trimesh_valley(device="cpu")
    assert_worlds_equal(_j_trimesh_valley(), port)
    assert balls == [1, 2]
    port, ball = scenes.voxel_stairs(device="cpu")
    assert_worlds_equal(_j_voxel_stairs(), port)
    # 29 of the 30 voxels are on the surface (voxel (2, 1, 1) is not), and the ball.
    assert ball == 1 and int(port.colliders.active.sum()) == 30
    for single in (True, False):
        port, ids = scenes.hull_stack(single=single, device="cpu")
        assert_worlds_equal(_j_hull_stack(single), port)
        assert ids == ([1] if single else [1, 2, 3])
    port, ids = scenes.terrain_shapes(14, per_row=4, field=6, device="cpu")
    assert_worlds_equal(_j_terrain(14, 4, 7, 6), port)
    kinds = port.colliders.shape_type.tolist()
    assert kinds[:50] == [8] * 50 and kinds[50:57] == [0, 2, 1, 4, 5, 8, 8]
    assert ids == list(range(1, 15))


def test_terrain_height_at_follows_the_triangles():
    """``terrain_height_at`` at the vertices is the height, and in each
    triangle it is the plane through its three vertices."""
    heights = scenes.terrain_heights(6)
    xs = np.arange(6) - 2.5
    gx, gz = np.meshgrid(xs[:-1], xs[:-1], indexing="ij")
    np.testing.assert_allclose(scenes.terrain_height_at(heights, gx, gz), heights[:-1, :-1],
                               atol=1e-6)
    # The centre of cell (1, 2)'s lower triangle and its upper triangle.
    h = heights.astype(np.float64)
    lower = (h[1, 2] + h[2, 2] + h[1, 3]) / 3.0
    upper = (h[2, 2] + h[2, 3] + h[1, 3]) / 3.0
    got = scenes.terrain_height_at(heights, np.asarray([1 + 1 / 3 - 2.5, 1 + 2 / 3 - 2.5]),
                                   np.asarray([2 + 1 / 3 - 2.5, 2 + 2 / 3 - 2.5]))
    np.testing.assert_allclose(got, [lower, upper], atol=1e-9)


# ---- steps ------------------------------------------------------------------

def _same_shapes(jw):
    """``jw`` with its pool zero-padded to ``POOL_ROWS`` rows and the
    reference's static ``shape_pairs`` set to ``STEP_PAIRS``, so that one
    compile of the reference's step serves every world here."""
    pool = jnp.asarray(jw.convex_verts)
    pool = jnp.concatenate([pool, jnp.zeros((POOL_ROWS - pool.shape[0], 3), jnp.float32)])
    return jw.replace(convex_verts=pool, shape_pairs=STEP_PAIRS)


def _assert_step_matches(jw):
    """One step of the reference's world ``jw`` by both packages; the
    reference's next world."""
    rw, rd = _J_STEP(jw, _J_CONFIG)
    pw, pd = physics_step(to_torch(jw).replace(shape_pairs=None), _T_CONFIG,
                          return_diagnostics=True)
    assert set(pd["manifold_pairs"]) <= set(STEP_PAIRS), pd["manifold_pairs"]
    for name in ("pos", "quat", "lin_vel", "ang_vel", "sleep_timer"):
        np.testing.assert_allclose(as_numpy(getattr(pw.bodies, name)),
                                   np.asarray(getattr(rw.bodies, name)),
                                   atol=STEP_TOL, rtol=0, err_msg=name)
    np.testing.assert_array_equal(as_numpy(pw.bodies.sleeping), np.asarray(rw.bodies.sleeping))
    for name in ("pair_key", "active", "touching", "num_points", "contact_id"):
        p = as_numpy(getattr(pw.contacts, name))
        np.testing.assert_array_equal(p, np.asarray(getattr(rw.contacts, name)).astype(p.dtype),
                                      err_msg=name)
    np.testing.assert_allclose(as_numpy(pw.contacts.normal_impulse).sum(1),
                               np.asarray(rw.contacts.normal_impulse).sum(1), atol=STEP_TOL, rtol=0)
    for key in ("num_pairs", "dropped_pairs", "num_touching", "num_contact_points",
                "num_sleeping", "nonfinite_bodies"):
        assert int(pd[key]) == int(rd[key]), key
    return rw, pd


def _reference_steps(jw, steps):
    for _ in range(steps):
        jw, _ = _J_STEP(jw, _J_CONFIG)
    return jw


def test_terrain_steps_match_reference():
    """From the start (every body 1 m above the field) and after 45 steps
    of the reference, some 20 steps after the bodies landed on the
    triangles (and before two of them meet: their pairs are Kernels M and
    N's, held in ``cases_shapes.py``)."""
    jw = _same_shapes(_j_terrain(14, 4, 7, 6, **CAPACITY))
    _assert_step_matches(jw)
    jw = _reference_steps(jw, 45)
    _, pd = _assert_step_matches(jw)
    assert {(0, 8), (1, 8), (2, 8), (4, 8), (5, 8), (8, 8)} <= set(pd["manifold_pairs"])
    assert int(pd["num_touching"]) >= 14


def test_ramp_and_hull_stack_steps_match_reference():
    """``tests/test_trimesh.py``'s box over its ramp and
    ``tests/test_convex_hull.py``'s hull stack, from their start and once
    landed (Kernel P's box/triangle and hull/hull pairs, Kernel Q)."""
    ramp = _same_shapes(_j_ramp(**CAPACITY))
    _assert_step_matches(ramp)
    _, pd = _assert_step_matches(_reference_steps(ramp, 45))
    assert set(pd["manifold_pairs"]) == {(2, 8)}
    stack = _same_shapes(_j_hull_stack(**CAPACITY))
    _assert_step_matches(stack)
    _, pd = _assert_step_matches(_reference_steps(stack, 20))
    assert set(pd["manifold_pairs"]) == {(3, 8), (8, 8)}
