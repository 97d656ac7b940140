"""The mixed-shape path against the JAX reference: the builder's spheres,
capsules, cylinders and cones (mass, inertia, centre of mass, leaf for
leaf), world AABBs of every shape within 1e-6, ``scenes.many_shapes(150)``
against the world of ``examples/many_shapes.py`` leaf for leaf, one full
``physics_step`` of that scene from its start and one from the state the
reference reaches after 30 steps of its own, within 1e-4, and the cylinder
stack of ``tests/test_shapes_convex.py`` for 240 steps on the plain versions
with that test's bounds.

The reference is compiled one IEEE operation at a time
(``port_common.ieee_reference``). Its step lists the shape pairs this scene
produces in those steps (``_STEP_PAIRS``); the port's lists every pair, so a
pair missing from the list would show as a difference."""

from port_common import ieee_reference

ieee_reference()

from functools import partial  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from avian_tpu import BodyType, SceneBuilder as JBuilder  # noqa: E402
from avian_tpu.core.config import PhysicsConfig as JConfig  # noqa: E402
from avian_tpu.geometry import shapes as jshapes  # noqa: E402
from avian_tpu.pipeline.step import physics_step as j_step  # noqa: E402
from avian_tpu_torch import physics_step, scenes  # noqa: E402
from avian_tpu_torch.core.builder import SceneBuilder as TBuilder  # noqa: E402
from avian_tpu_torch.core.config import PhysicsConfig as TConfig  # noqa: E402
from avian_tpu_torch.geometry import shapes as tshapes  # noqa: E402

from port_common import (as_numpy, assert_worlds_equal, example_many_shapes, pad8,  # noqa: E402
                         quats, to_torch)

STEP_TOL = 1e-4
AABB_TOL = 1e-6
MAX_COLORS = 6
# What many_shapes(150) produces in its first 31 steps: every shape on the
# plane, and the few pairs of neighbours that meet as the sixth row lands.
_STEP_PAIRS = ((0, 0), (0, 1), (0, 2), (0, 3), (1, 1), (1, 2), (1, 3), (1, 4), (2, 2), (2, 3),
               (3, 4), (3, 5))
_J_STEP = jax.jit(partial(j_step, return_diagnostics=True), static_argnums=1)


def _mixed(builder, **finalize_kw):
    """Every shape, at two sizes and two densities, one body with two
    colliders off its origin (a cone and a sphere), and a static plane."""
    g = builder.add_body(body_type=BodyType.STATIC)
    builder.half_space(g, normal=(0.0, 1.0, 0.0))
    for i, (size, density) in enumerate(((0.4, 1.0), (0.7, 2.5))):
        for j, make in enumerate((
            lambda b: builder.sphere(b, size, density=density),
            lambda b: builder.capsule(b, 0.5 * size, 2.0 * size, density=density),
            lambda b: builder.box(b, size, 0.5 * size, 0.8 * size, density=density),
            lambda b: builder.cylinder(b, size, 1.5 * size, density=density),
            lambda b: builder.cone(b, 0.8 * size, 2.0 * size, density=density),
        )):
            make(builder.add_body(pos=(2.0 * j, 1.0 + 2.0 * i, 0.0)))
    b = builder.add_body(pos=(0.0, 5.0, 3.0))
    builder.cone(b, 0.3, 0.9, local_pos=(0.2, 0.1, -0.3))
    builder.sphere(b, 0.25, local_pos=(-0.4, 0.0, 0.2), density=3.0)
    return builder.finalize(max_bodies=16, max_colliders=16, max_contacts=64, **finalize_kw)


def test_builder_mass_properties_match_reference():
    ref = _mixed(JBuilder())
    port = _mixed(TBuilder(), device="cpu")
    assert_worlds_equal(ref, port)
    # The cone's centre of mass sits a quarter of its height below its origin.
    cone = ref.colliders.body_idx[10]
    np.testing.assert_allclose(np.asarray(ref.bodies.com[cone]), [0.0, -0.35, 0.0], atol=1e-6)


def test_world_aabbs_match_reference():
    """Every shape, the half-space and a padded slot, at random poses."""
    rng = np.random.default_rng(5)
    k = 7 * 32
    shape = np.repeat(np.asarray([0, 1, 2, 3, 4, 5, 0], np.int32), 32)
    prm = rng.uniform(0.1, 0.9, (k, 3)).astype(np.float32)
    prm[shape == 3] = (0.0, 1.0, 0.0)
    prm[-32:] = 0.0  # padding: a zero-size sphere
    pos = rng.uniform(-5.0, 5.0, (k, 3)).astype(np.float32)
    quat = quats(rng, k, 1.0)
    ref = jax.jit(jshapes.world_aabb)(shape, pad8(prm), pos, quat)
    port = tshapes.world_aabb(*(torch.from_numpy(x) for x in (shape, pad8(prm), pos, quat)))
    for r, p in zip(ref, port):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=AABB_TOL, rtol=0)
    # A capsule's half height is its segment's plus its radius.
    cap = np.nonzero(shape == 1)[0][0]
    upright = tshapes.local_aabb_half_extents(torch.tensor([1]), torch.from_numpy(pad8(prm[cap:cap + 1])))
    np.testing.assert_allclose(upright[0].numpy(), [prm[cap, 1], prm[cap, 0] + prm[cap, 1], prm[cap, 1]])


def test_many_shapes_matches_the_example_leaf_for_leaf():
    ref = example_many_shapes()
    port, ids = scenes.many_shapes(device="cpu")
    assert_worlds_equal(ref, port)
    assert ids == list(range(1, 151))
    kinds = port.colliders.shape_type[1:].tolist()
    assert kinds[:5] == [0, 2, 1, 4, 5] and kinds == kinds[:5] * 30
    wide, _ = scenes.many_shapes(2 * 24 * 24 + 5, per_row=24, max_contacts=99, device="cpu")
    assert wide.contacts.capacity == 99
    assert sorted(set(wide.bodies.pos[1:, 1].tolist())) == [1.0, 2.5, 4.0]  # three layers


def _assert_step_matches(jw):
    jcfg = JConfig(max_colors=MAX_COLORS, shape_pairs=_STEP_PAIRS)
    tcfg = TConfig(max_colors=MAX_COLORS)
    rw, rd = _J_STEP(jw, jcfg)
    pw, pd = physics_step(to_torch(jw), tcfg, return_diagnostics=True)
    assert set(pd["manifold_pairs"]) <= set(_STEP_PAIRS), pd["manifold_pairs"]
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


def test_one_step_from_the_start_and_one_from_step_30_match_reference():
    jw = example_many_shapes()
    _, pd = _assert_step_matches(jw)
    assert set(pd["manifold_pairs"]) == {(0, 3), (1, 3), (2, 3), (3, 4), (3, 5)}
    jcfg = JConfig(max_colors=MAX_COLORS, shape_pairs=_STEP_PAIRS)
    for _ in range(30):
        jw, _ = _J_STEP(jw, jcfg)
    _, pd = _assert_step_matches(jw)
    # Landed: Kernel N's and O's pairs on the plane, and the support-map
    # pairs of neighbours that meet.
    assert int(pd["num_touching"]) > 140
    assert {(1, 2), (1, 4)} <= set(pd["manifold_pairs"])


def test_cylinder_stack_rests_upright_and_asleep():
    """``tests/test_shapes_convex.py::test_cylinder_stack_rests_and_cone_rests``
    on the port's plain versions, with its config and bounds."""
    cfg = TConfig(max_colors=4, shape_pairs=((3, 4), (4, 4), (3, 5)))
    world, stack, cone = scenes.cylinder_stack(device="cpu")
    for _ in range(240):
        world = physics_step(world, cfg)
    pos = world.bodies.pos.numpy()
    quat = world.bodies.quat.numpy()
    assert np.isfinite(pos).all()
    for k, body in enumerate(stack):
        assert abs(pos[body][1] - (0.5 + 1.0 * k)) < 0.08, (k, pos[body])
        assert abs(quat[body][0]) < 0.05 and abs(quat[body][2]) < 0.05
    assert abs(pos[cone][1] - 0.5) < 0.05, pos[cone]
    assert abs(quat[cone][0]) < 0.05 and abs(quat[cone][2]) < 0.05
    sleeping = world.bodies.sleeping.numpy()
    assert sleeping[np.asarray(stack)].all() and sleeping[cone]
