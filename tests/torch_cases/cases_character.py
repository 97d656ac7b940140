"""The port's kinematic character (``avian_tpu_torch.character``:
``project_velocity``, ``depenetrate`` on S's manifold mode, ``move_and_slide``
on Kernel S) and picking (``avian_tpu_torch.picking``: ``pick``,
``pick_batch`` on Kernel T, ``pick_2d`` on Kernel AC), their plain versions
on the CPU, against ``avian_tpu.character`` and ``avian_tpu.picking`` compiled
one IEEE operation at a time (``port_common.ieee_reference``).

- ``project_velocity`` on seeded velocities, normals and earlier planes,
  exactly.
- ``depenetrate`` on S's manifold mode: a sphere at seeded positions in
  the ground and the wall of ``tests/test_character.py``'s wall world, and a
  turned box among three spheres (the box's shape code is the higher, so
  every manifold is swapped), within ``TOL``, and that file's check.
- The reference's fault (ROADMAP 3b): its ``depenetrate`` tests a hull
  against no vertex pool, so a sphere 0.3 m into a cube hull stays where it
  is, while the port pushes it out as far as out of the same cube as a box.
- ``move_and_slide`` on ``examples/kinematic_character_3d.py``'s world (a
  ramp, a platform, a wall), the reference compiled once for its 120 frames:
  the port's own first ``SEQUENTIAL_FRAMES`` frames, then one frame from the
  reference's state at each of ``SAMPLED_FRAMES`` (a frame of the plain
  versions takes about a second on one CPU thread, so not all 120 run),
  each within ``TOL`` of the reference, and the example's checks on the
  port's last frame.
- ``pick``, ``pick_batch`` and ``pick_2d`` on ``tests/test_queries.py``'s
  three spheres, ``examples/picking_demo.py``'s world and a small 2D world,
  with and without pickable masks, exactly; and the two files' checks.

The reference's outputs are read from ``character_reference.npz``
(``port_common.Recording``, keyed by a digest of the reference's inputs;
rerecord with ``record_references.py cases_character.py``): compiling its
120 frames took some 35 s. ``project_velocity``'s reference runs live and
is held to the recording."""

from port_common import ieee_reference

ieee_reference()

import dataclasses  # noqa: E402
import functools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from avian_tpu import BodyType, PhysicsConfig, SceneBuilder, ShapeType  # noqa: E402
from avian_tpu import character as jchar  # noqa: E402
from avian_tpu import picking as jpick  # noqa: E402
from avian_tpu.pipeline.broadphase import update_aabbs  # noqa: E402
from avian_tpu_torch import character as tchar  # noqa: E402
from avian_tpu_torch import picking as tpick  # noqa: E402
from avian_tpu_torch.dim2 import SceneBuilder2D  # noqa: E402

from cases_dim2 import to_jax2d  # noqa: E402
from port_common import Recording, as_numpy, quats, to_torch  # noqa: E402

torch.set_num_threads(1)
TOL = 1e-5
ID = (0.0, 0.0, 0.0, 1.0)
CAPSULE = (0.5, 0.4)
FRAMES, DT, WALK = 120, 1.0 / 30.0, (2.0, -1.0, 0.0)
SEQUENTIAL_FRAMES = 6
SAMPLED_FRAMES = (30, 60, 90, FRAMES - 1)
CFG = PhysicsConfig(max_colors=4)


# ---------------------------------------------------------------------------
# Worlds (the reference's builder; the port takes the same arrays)
# ---------------------------------------------------------------------------


def wall_world():
    """``tests/test_character.py::_world_with_wall``."""
    b = SceneBuilder()
    g = b.add_body(body_type=BodyType.STATIC)
    b.half_space(g, normal=(0, 1, 0))
    wall = b.add_body(body_type=BodyType.STATIC, pos=(3.0, 1.0, 0.0))
    b.box(wall, 0.25, 2.0, 5.0)
    return update_aabbs(b.finalize(max_bodies=4, max_colliders=4, max_contacts=16), CFG)


def cube_world(hull):
    """A cube of half extent 1 at the origin, as a hull of its 8 corners or
    as a box."""
    b = SceneBuilder()
    body = b.add_body(body_type=BodyType.STATIC)
    if hull:
        b.convex_hull(body, [(x, y, z) for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)])
    else:
        b.box(body, 1.0, 1.0, 1.0)
    return update_aabbs(b.finalize(max_bodies=2, max_colliders=2, max_contacts=4), CFG)


def kinematic_world():
    """``examples/kinematic_character_3d.py``'s world."""
    b = SceneBuilder()
    g = b.add_body(body_type=BodyType.STATIC)
    b.half_space(g, normal=(0, 1, 0))
    ang = np.pi / 14.0
    s, c = np.sin(ang / 2.0), np.cos(ang / 2.0)
    ramp = b.add_body(body_type=BodyType.STATIC, pos=(2.6, 0.28, 0.0), quat=(0.0, 0.0, s, c))
    b.box(ramp, 1.6, 0.08, 2.0)
    plat = b.add_body(body_type=BodyType.STATIC, pos=(5.6, 0.52, 0.0))
    b.box(plat, 1.6, 0.08, 2.0)
    wall = b.add_body(body_type=BodyType.STATIC, pos=(7.6, 2.0, 0.0))
    b.box(wall, 0.3, 2.0, 4.0)
    return update_aabbs(b.finalize(max_bodies=8, max_colliders=8, max_contacts=32), PhysicsConfig())


def spheres_world(xs, cap=4):
    """Static spheres of radius 0.5 on the x axis (``tests/test_queries.py::
    _three_spheres``, ``examples/picking_demo.py``)."""
    b = SceneBuilder()
    for x in xs:
        b.sphere(b.add_body(body_type=BodyType.STATIC, pos=(x, 0.0, 0.0)), 0.5)
    return update_aabbs(b.finalize(max_bodies=cap, max_colliders=cap, max_contacts=8), CFG)


def world_2d():
    """A ground, a circle, a box and a capsule, built by the port's 2D
    builder."""
    b = SceneBuilder2D()
    ground = b.add_body(pos=(0.0, -3.0), body_type=BodyType.STATIC)
    b.half_space(ground, normal=(0.0, 1.0))
    b.circle(b.add_body(pos=(0.0, 0.0), body_type=BodyType.STATIC), 1.0)
    b.box(b.add_body(pos=(4.0, 0.0), body_type=BodyType.STATIC), 1.0, 1.0)
    b.capsule(b.add_body(pos=(-4.0, 0.0), body_type=BodyType.STATIC), 0.5, 2.0)
    return b.finalize(max_bodies=6, max_colliders=6, device="cpu")


# ---------------------------------------------------------------------------
# Seeded inputs
# ---------------------------------------------------------------------------


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def projection_inputs(n=64, seed=4):
    """Velocities, unit normals, 4 earlier planes (some the crease's
    neighbours) and how many of them are valid."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3)).astype(np.float32) * 3.0
    normal = _unit(rng.normal(size=(n, 3)))
    planes = _unit(rng.normal(size=(n, 4, 3)))
    planes[::3, 0] = normal[::3] * -1.0
    planes[1::3, 1] = _unit(normal[1::3] + np.float32(0.3))
    return v, normal, planes, rng.integers(0, 5, n).astype(np.int32)


def wall_positions(n=16, seed=6):
    """Positions in the ground (y 0.1-0.6) and at or in the wall's face (x
    2.3-3.0)."""
    rng = np.random.default_rng(seed)
    ground = np.stack([rng.uniform(-2, 2, n), rng.uniform(0.1, 0.6, n),
                       rng.uniform(-2, 2, n)], 1)
    wall = np.stack([rng.uniform(2.3, 3.0, n), rng.uniform(0.6, 2.5, n),
                     rng.uniform(-2, 2, n)], 1)
    return np.concatenate([ground, wall]).astype(np.float32)


def sphere_positions(n=16, seed=7):
    """Positions in and around ``spheres_world``'s three spheres."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-2.8, 2.8, n), rng.uniform(-0.7, 0.7, n),
                     rng.uniform(-0.7, 0.7, n)], 1).astype(np.float32)


def pointer_rays(n=16, seed=9):
    """Pointers above the spheres looking down, and level ones along x."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-3, 3, n), np.full(n, 5.0), rng.uniform(-0.6, 0.6, n)], 1)
    d = np.tile([0.0, -1.0, 0.0], (n, 1)) + rng.uniform(-0.1, 0.1, (n, 3))
    o[::4] = np.stack([np.full(n, -10.0), rng.uniform(-0.4, 0.4, n),
                       rng.uniform(-0.4, 0.4, n)], 1)[::4]
    d[::4] = [1.0, 0.0, 0.0]
    return o.astype(np.float32), _unit(d)


# ---------------------------------------------------------------------------
# The reference (numpy results), recorded
# ---------------------------------------------------------------------------

RECORDING = Recording("character")

_MAS = jax.jit(jchar.move_and_slide, static_argnames=("shape_type", "config"))


def _ref_frames():
    """The reference's 120 frames: inputs f32[F, 3] and (pos, vel, normal)."""
    world = kinematic_world()
    pos = np.asarray([0.0, 0.91, 0.0], np.float32)
    ins, outs = [], []
    for _ in range(FRAMES):
        ins.append(pos)
        p, v, n = _MAS(world, ShapeType.CAPSULE, CAPSULE, pos, ID, np.asarray(WALK, np.float32),
                       DT)
        pos = np.array(p)
        outs.append((pos, np.asarray(v), np.asarray(n)))
    return np.stack(ins), [np.stack(x) for x in zip(*outs)]


def _ref_projection():
    fn = jax.jit(jax.vmap(jchar.project_velocity))
    return np.asarray(fn(*(jnp.asarray(x) for x in projection_inputs())))


# (world, query shape type, params, positions) of the depenetration cases
def depenetration_cases():
    return (("wall", wall_world(), int(ShapeType.SPHERE), (0.5,), wall_positions()),
            ("spheres", spheres_world((-2.0, 0.0, 2.0)), int(ShapeType.BOX), (0.3, 0.2, 0.25),
             sphere_positions()))


def _ref_depenetration():
    out = {}
    for name, w, st, prm, positions in depenetration_cases():
        quat = quats(np.random.default_rng(st), 1, 0.5)[0]
        fn = jax.jit(jax.vmap(lambda p, w=w, st=st, prm=prm, q=quat: jchar.depenetrate(
            w, st, prm, p, q, iters=3)))
        out[name] = np.asarray(fn(jnp.asarray(positions)))
    return out


def _ref_cubes():
    start = jnp.asarray([0.0, 1.2, 0.0], jnp.float32)
    return {("hull" if hull else "box"): np.asarray(jax.jit(
        lambda p, w=cube_world(hull): jchar.depenetrate(w, int(ShapeType.SPHERE), (0.5,), p, ID)
    )(start)) for hull in (True, False)}


def _numpy_hit(hit):
    return {f.name: np.asarray(getattr(hit, f.name)) for f in dataclasses.fields(hit)}


def _ref_picks():
    three = spheres_world((-2.0, 0.0, 2.0))
    demo = spheres_world((-2.0, 0.0, 2.0))
    o, d = pointer_rays()
    mask = np.asarray([True, False, True, True])
    w2 = to_jax2d(world_2d())
    mask2 = np.asarray([True, False, True, True, True, True])
    hits = {
        "pick": jpick.pick(three, (-10.0, 0.0, 0.0), (1.0, 0.0, 0.0)),
        "pick_far": jpick.pick(three, (-10.0, 0.0, 0.0), (1.0, 0.0, 0.0),
                               pickable=jnp.asarray([False, False, True, False])),
        "batch_two": jpick.pick_batch(three, [(-10.0, 0.0, 0.0), (0.0, 10.0, 0.0)],
                                      [(1.0, 0.0, 0.0), (0.0, -1.0, 0.0)]),
        "demo": jpick.pick_batch(demo, [(-2.0, 5.0, 0.0), (0.0, 5.0, 0.0), (2.0, 5.0, 0.0)],
                                 [(0.0, -1.0, 0.0)] * 3),
        "seeded": jpick.pick_batch(three, o, d, 8.0),
        "seeded_mask": jpick.pick_batch(three, o, d, pickable=jnp.asarray(mask)),
        "pick_2d": jpick.pick_2d(w2, (-10.0, 0.5), (1.0, 0.0)),
        "pick_2d_mask": jpick.pick_2d(w2, (-10.0, 0.2), (1.0, 0.0),
                                      pickable=jnp.asarray(mask2)),
        "pick_2d_down": jpick.pick_2d(w2, (4.2, 5.0), (0.0, -1.0), 3.0),
    }
    return {name: _numpy_hit(hit) for name, hit in hits.items()}


class _Done:
    def __init__(self, value):
        self.value = value

    def result(self):
        return self.value


@functools.cache
def _jobs():
    """Every reference computation, by name, each from the recording of its
    inputs (the worlds and seeded arrays it builds), ``projection`` run
    live."""
    inputs = {
        "frames": ("frames", kinematic_world(), FRAMES, DT, WALK, CAPSULE),
        "projection": ("projection", projection_inputs()),
        "depenetration": ("depenetration", [c[1:] for c in depenetration_cases()]),
        "cubes": ("cubes", cube_world(True), cube_world(False)),
        "picks": ("picks", spheres_world((-2.0, 0.0, 2.0)), pointer_rays(),
                  jax.tree.map(np.asarray, to_jax2d(world_2d()))),
    }
    fns = {"frames": _ref_frames, "projection": _ref_projection,
           "depenetration": _ref_depenetration, "cubes": _ref_cubes, "picks": _ref_picks}
    return {name: _Done(RECORDING(inputs[name], fns[name], live=name == "projection"))
            for name in fns}


def _close(what, got, want, tol=TOL):
    got, want = as_numpy(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


# ---------------------------------------------------------------------------
# Cases
# ---------------------------------------------------------------------------


def test_project_velocity_matches_reference():
    jobs = _jobs()
    v, n, planes, num = (torch.from_numpy(x) for x in projection_inputs())
    got = torch.stack([tchar.project_velocity(v[i], n[i], planes[i], num[i])
                       for i in range(v.shape[0])])
    np.testing.assert_array_equal(as_numpy(got), jobs["projection"].result())
    # tests/test_character.py::test_project_velocity_crease
    planes = torch.zeros((4, 3))
    out = tchar.project_velocity(torch.tensor([1.0, -1.0, 0.0]), torch.tensor([0.0, 1.0, 0.0]),
                                 planes, 0)
    np.testing.assert_allclose(as_numpy(out), [1, 0, 0], atol=1e-6)
    planes[0] = torch.tensor([0.0, 1.0, 0.0])
    out = tchar.project_velocity(torch.tensor([1.0, -1.0, 0.2]), torch.tensor([-1.0, 0.0, 0.0]),
                                 planes, torch.tensor(1))
    assert abs(float(out[0])) < 1e-5 and abs(float(out[1])) < 1e-5


def test_depenetrate_matches_reference():
    jobs = _jobs()
    for name, w, st, prm, positions in depenetration_cases():
        quat = quats(np.random.default_rng(st), 1, 0.5)[0]
        got = np.stack([as_numpy(tchar.depenetrate(to_torch(w), st, prm, p, quat, iters=3))
                        for p in positions])
        _close(f"depenetrate in {name}", got, jobs["depenetration"].result()[name])
        assert (np.abs(got - positions).max(1) > 1e-3).sum() >= 4, name
    # tests/test_character.py::test_depenetrate
    p = tchar.depenetrate(to_torch(wall_world()), ShapeType.SPHERE, (0.5,), (0.0, 0.2, 0.0), ID)
    assert float(p[1]) >= 0.5


def test_depenetrate_pushes_out_of_a_hull():
    """The port pushes a sphere out of a cube hull as out of the same cube
    as a box (to y = 1.51: the surface, the radius and the skin); the
    reference leaves it unmoved at y = 1.2 (no vertex pool)."""
    jobs = _jobs()
    got = {hull: as_numpy(tchar.depenetrate(to_torch(cube_world(hull)), ShapeType.SPHERE,
                                            (0.5,), (0.0, 1.2, 0.0), ID))
           for hull in (True, False)}
    ref = jobs["cubes"].result()
    _close("box", got[False], ref["box"])
    assert abs(float(got[False][1]) - 1.51) < 1e-5
    _close("hull against the box", got[True], got[False])
    np.testing.assert_array_equal(ref["hull"], np.asarray([0.0, 1.2, 0.0], np.float32))


def _frame(world, pos):
    return tchar.move_and_slide(world, ShapeType.CAPSULE, CAPSULE, pos, ID,
                                np.asarray(WALK, np.float32), DT)


def test_move_and_slide_matches_reference():
    jobs = _jobs()
    world = to_torch(kinematic_world())
    pos = torch.tensor([0.0, 0.91, 0.0])
    own = []
    for _ in range(SEQUENTIAL_FRAMES):
        pos, vel, normal = _frame(world, pos)
        own.append((pos, vel, normal))
    ins, (r_pos, r_vel, r_n) = jobs["frames"].result()
    for k, (p, v, n) in enumerate(own):
        for what, x, y in (("pos", p, r_pos[k]), ("vel", v, r_vel[k]), ("normal", n, r_n[k])):
            _close(f"frame {k} {what}", x, y)
    for k in SAMPLED_FRAMES:
        p, v, n = _frame(world, torch.from_numpy(ins[k]))
        for what, x, y in (("pos", p, r_pos[k]), ("vel", v, r_vel[k]), ("normal", n, r_n[k])):
            _close(f"frame {k} {what}", x, y)
    # examples/kinematic_character_3d.py's checks, on the port's last frame.
    p = as_numpy(p)
    assert np.isfinite(p).all()
    assert p[0] > 5.5, f"did not cross the ramp: {p}"
    assert p[0] < 7.05, f"went through the wall: {p}"
    assert p[1] > 1.3, f"sank through the platform: {p}"


def _same_hit(what, got, want):
    for f in ("collider", "body", "distance", "point", "normal", "hit"):
        np.testing.assert_array_equal(as_numpy(getattr(got, f)), want[f], err_msg=f"{what} {f}")


def test_picking_matches_reference():
    jobs = _jobs()
    three = to_torch(spheres_world((-2.0, 0.0, 2.0)))
    o, d = pointer_rays()
    mask = torch.tensor([True, False, True, True])
    w2 = world_2d()
    mask2 = torch.tensor([True, False, True, True, True, True])
    got = {
        "pick": tpick.pick(three, (-10.0, 0.0, 0.0), (1.0, 0.0, 0.0)),
        "pick_far": tpick.pick(three, (-10.0, 0.0, 0.0), (1.0, 0.0, 0.0),
                               pickable=torch.tensor([False, False, True, False])),
        "batch_two": tpick.pick_batch(three, [(-10.0, 0.0, 0.0), (0.0, 10.0, 0.0)],
                                      [(1.0, 0.0, 0.0), (0.0, -1.0, 0.0)]),
        "demo": tpick.pick_batch(three, [(-2.0, 5.0, 0.0), (0.0, 5.0, 0.0), (2.0, 5.0, 0.0)],
                                 [(0.0, -1.0, 0.0)] * 3),
        "seeded": tpick.pick_batch(three, o, d, 8.0),
        "seeded_mask": tpick.pick_batch(three, o, d, pickable=mask),
        "pick_2d": tpick.pick_2d(w2, (-10.0, 0.5), (1.0, 0.0)),
        "pick_2d_mask": tpick.pick_2d(w2, (-10.0, 0.2), (1.0, 0.0), pickable=mask2),
        "pick_2d_down": tpick.pick_2d(w2, (4.2, 5.0), (0.0, -1.0), 3.0),
    }
    ref = jobs["picks"].result()
    for name, hit in got.items():
        _same_hit(name, hit, ref[name])
    # tests/test_queries.py::test_picking and examples/picking_demo.py
    assert bool(got["pick"].hit)
    assert bool(got["pick_far"].hit) and int(got["pick_far"].collider) == 2
    assert bool(got["batch_two"].hit.all())
    assert as_numpy(got["demo"].collider).tolist() == [0, 1, 2]
    only_middle = torch.tensor([False, True, False, False])
    assert not bool(tpick.pick(three, (-2.0, 5.0, 0.0), (0.0, -1.0, 0.0),
                               pickable=only_middle).hit)
    h = tpick.pick(three, (0.0, 5.0, 0.0), (0.0, -1.0, 0.0), pickable=only_middle)
    assert bool(h.hit) and int(h.collider) == 1
    seeded = as_numpy(got["seeded_mask"].collider)
    assert (seeded != 1).all() and (seeded >= 0).any()
    assert int(got["pick_2d_mask"].collider) != 1
