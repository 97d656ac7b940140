"""Ray casts and shape casts against the JAX reference (Kernels T and S's
plain versions on the CPU): ``tests/test_queries.py``'s worlds (a
half-space, a sphere, a box and a capsule on its own layer; three walls; a
hull), a world of every ray-cast shape (sphere, capsule, box, half-space,
cylinder, cone, segment, hull, round cuboid, triangle), and a 300-body
``terrain_shapes`` after 20 steps, with:

- 64 seeded rays through each world in both ``solid`` modes, every (ray,
  collider) distance and normal;
- ``cast_ray`` and ``ray_hits`` for 8 rays through two of them;
- a ``QueryFilter`` layer mask, an ``excluded`` set and both predicate
  variants.

The shape casts through these worlds are ``cases_shape_casts.py``'s and
``cases_support_casts.py``'s.

Collider indices and hit flags must match exactly, distances, points and
normals within ``TOL``. The reference is compiled one IEEE operation at a
time (``port_common.ieee_reference``). Its 64-ray batches are read from
``queries_reference.npz`` (``port_common.Recording``, keyed by a digest of
its inputs; rerecord with ``record_references.py cases_queries.py``),
except the walls', which run live and are held to the recording."""

from port_common import ieee_reference

ieee_reference()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from avian_tpu import BodyType, ShapeType, SceneBuilder as JBuilder  # noqa: E402
from avian_tpu import queries as jq  # noqa: E402
from avian_tpu.queries import raycast as jraycast  # noqa: E402
from avian_tpu_torch import PhysicsConfig, physics_step, queries as tq, scenes  # noqa: E402

from cases_ccd_terrain import _j_terrain_ccd  # noqa: E402
from port_common import Recording, as_numpy, to_jax, to_torch  # noqa: E402

# Distances, points and normals: the analytic tests round alike in both
# packages; the hull march's 24 x 12 Frank-Wolfe steps and its face fit
# amplify a last-bit difference of XLA's fused loops to a few 1e-6.
TOL = 1e-5
N_RAYS, N_CASTS = 64, 8


# ---- worlds -------------------------------------------------------------------

def _queries_world():
    """tests/test_queries.py::_world."""
    b = JBuilder()
    g = b.add_body(body_type=BodyType.STATIC)
    b.half_space(g, normal=(0, 1, 0))
    s = b.add_body(body_type=BodyType.STATIC, pos=(0, 2, 0))
    b.sphere(s, 0.5)
    bx = b.add_body(body_type=BodyType.STATIC, pos=(3, 1, 0))
    b.box(bx, 1.0, 1.0, 1.0)
    cp = b.add_body(body_type=BodyType.STATIC, pos=(-3, 1, 0))
    b.capsule(cp, 0.4, 1.2, layer_members=0b10, layer_filter=0b10)
    return b.finalize(max_bodies=8, max_colliders=8, max_contacts=16)


def _walls():
    """tests/test_queries.py::test_shape_hits_multiple_sorted's walls."""
    b = JBuilder()
    for x in (2.0, 5.0, 8.0):
        body = b.add_body(body_type=BodyType.STATIC, pos=(x, 0.0, 0.0))
        b.box(body, 0.5, 2.0, 2.0)
    return b.finalize(max_bodies=4, max_colliders=4, max_contacts=16)


def _hull():
    """tests/test_queries.py::test_cast_shape_vs_convex_hull's octahedron."""
    b = JBuilder()
    h = b.add_body(body_type=BodyType.STATIC, pos=(0.0, 1.0, 0.0))
    b.convex_hull(h, [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)])
    return b.finalize(max_bodies=2, max_colliders=2, max_contacts=8)


def _every_shape():
    """One collider of every shape a ray meets, each turned, on a half-space."""
    rng = np.random.default_rng(3)
    b = JBuilder()
    g = b.add_body(body_type=BodyType.STATIC)
    b.half_space(g, normal=(0, 1, 0))
    makers = (
        lambda body: b.sphere(body, 0.5),
        lambda body: b.capsule(body, 0.3, 1.0),
        lambda body: b.box(body, 0.4, 0.6, 0.3),
        lambda body: b.cylinder(body, 0.4, 1.0),
        lambda body: b.cone(body, 0.5, 1.2),
        lambda body: b.segment(body, (-0.5, 0.0, 0.0), (0.5, 0.2, 0.0)),
        lambda body: b.convex_hull(body, rng.normal(size=(12, 3)).astype(np.float32) * 0.5),
        lambda body: b.round_cuboid(body, 0.6, 0.4, 0.5, 0.1),
        lambda body: b.triangle(body, (0.0, 0.0, 0.0), (1.0, 0.1, 0.0), (0.2, 0.0, 0.9)),
    )
    for k, make in enumerate(makers):
        q = rng.normal(size=4)
        body = b.add_body(body_type=BodyType.STATIC, pos=((k % 3) * 2.5 - 2.5, 1.5 + (k // 3),
                                                         (k // 3) * 2.0 - 2.0),
                          quat=tuple(q / np.linalg.norm(q)))
        make(body)
    return b.finalize(max_bodies=12, max_colliders=12, max_contacts=16)


_TERRAIN = dict(n=300, per_row=12, bullets=0, seed=7, field=17)
_TERRAIN_STEPS = 20


def _terrain():
    """``terrain_shapes(300, per_row=12, field=17)`` after 20 steps of the
    port (the reference's world with the port's state)."""
    world, _ = scenes.terrain_shapes(300, per_row=12, field=17, device="cpu")
    config = PhysicsConfig(substeps=4, sap_window=64)
    for _ in range(_TERRAIN_STEPS):
        world = physics_step(world, config)
    return to_jax(world, _j_terrain_ccd(**_TERRAIN))


WORLDS = {"queries": _queries_world, "walls": _walls, "hull": _hull,
          "every_shape": _every_shape, "terrain": _terrain}
_CACHE = {}


def world(name):
    """(reference world, port world) of ``name``, built once."""
    if name not in _CACHE:
        jw = WORLDS[name]()
        _CACHE[name] = (jw, to_torch(jw))
    return _CACHE[name]


def _unit(v):
    v = np.asarray(v, np.float32)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def rays(name, n, seed):
    """``n`` seeded rays (origins, unit directions) through world ``name``:
    from a box around it toward points inside it; on the terrain three in
    four straight down through the pile onto the field, the rest level
    through it."""
    rng = np.random.default_rng(seed)
    if name == "terrain":
        down = n * 3 // 4
        o = np.concatenate([
            np.stack([rng.uniform(-7, 7, down), np.full(down, 15.0), rng.uniform(-7, 7, down)], 1),
            np.stack([np.full(n - down, -9.0), rng.uniform(0.3, 3.0, n - down),
                      rng.uniform(-7, 7, n - down)], 1)])
        d = np.concatenate([np.tile([[0.0, -1.0, 0.0]], (down, 1)),
                            np.tile([[1.0, 0.0, 0.0]], (n - down, 1))])
        d = d + rng.uniform(-0.05, 0.05, d.shape)
        return o.astype(np.float32), _unit(d)
    o = rng.uniform(-6, 6, (n, 3)) + [0.0, 4.0, 0.0]
    target = rng.uniform(-3, 3, (n, 3)) + [0.0, 1.5, 0.0]
    o[: n // 8] = target[: n // 8] + rng.uniform(-0.1, 0.1, (n // 8, 3))  # start inside some
    return o.astype(np.float32), _unit(target - o + [1e-3, 0.0, 0.0])


# ---- rays ----------------------------------------------------------------------

RAYS = Recording("queries")


@jax.jit
def _j_all_hits(jw, origins, dirs, solid, mask, excluded):
    qf = jq.QueryFilter(mask=mask, excluded=excluded)
    return jax.vmap(lambda o, d: jraycast._all_hits(jw, o, d, solid, qf))(origins, dirs)


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(as_numpy(got), np.asarray(want), atol=tol, rtol=0, err_msg=what)


def _filters(name, seed):
    """(reference filter args, port filter): the layer mask of every layer
    but layer 1 on a third of the cases, and every seventh collider
    excluded."""
    m = world(name)[0].colliders.capacity
    excluded = np.zeros(m, bool)
    excluded[seed % 7::7] = True
    mask = 0xFFFFFFFD if seed % 3 == 0 else 0xFFFFFFFF
    return ((jnp.asarray(mask, jnp.uint32), jnp.asarray(excluded)),
            tq.QueryFilter(mask=mask, excluded=torch.from_numpy(excluded)))


@pytest.mark.parametrize("solid", [True, False])
@pytest.mark.parametrize("name", sorted(WORLDS))
def test_rays_match_reference(name, solid):
    jw, tw = world(name)
    o, d = rays(name, N_RAYS, seed=len(name))
    (mask, excl), qf = _filters(name, len(name))
    args = (jw, jnp.asarray(o), jnp.asarray(d), jnp.asarray(solid), mask, excl)
    jt, jn = RAYS(args, lambda: _j_all_hits(*args), live=name == "walls")
    tt, tn = tq.raycast.all_hits(tw, torch.from_numpy(o), torch.from_numpy(d), solid, qf)
    np.testing.assert_array_equal(as_numpy(tt) < jraycast._BIG, jt < jraycast._BIG)
    hit = jt < jraycast._BIG
    assert hit.sum() >= 4, hit.sum()
    _close(as_numpy(tt)[hit], jt[hit], "distance")
    _close(as_numpy(tn)[hit], jn[hit], "normal")


def _same_hit(got, want, fields):
    for field in fields:
        g, w = getattr(got, field), np.asarray(getattr(want, field))
        if field in ("collider", "body", "hit"):
            np.testing.assert_array_equal(as_numpy(g), w, err_msg=field)
    hit = np.asarray(want.hit)
    for field in fields:
        if field not in ("collider", "body", "hit"):
            _close(as_numpy(getattr(got, field))[hit], np.asarray(getattr(want, field))[hit],
                   field)


_J_CAST_RAY = jax.jit(jq.cast_ray, static_argnums=(3,))
_J_RAY_HITS = jax.jit(jq.ray_hits, static_argnums=(3, 4))
_RAY_FIELDS = ("collider", "body", "hit", "distance", "point", "normal")


@pytest.mark.parametrize("name", ["every_shape", "queries"])
def test_cast_ray_and_ray_hits_match_reference(name):
    jw, tw = world(name)
    o, d = rays(name, 8, seed=100 + len(name))
    for k in range(8):
        solid = k % 2 == 0
        origin, direction = tuple(map(float, o[k])), tuple(map(float, d[k] * 2.0))
        _same_hit(tq.cast_ray(tw, origin, direction, 30.0, solid),
                  _J_CAST_RAY(jw, origin, direction, 30.0, jnp.asarray(solid)), _RAY_FIELDS)
        # The reference's ray_hits takes at most M hits (lax.top_k).
        k_hits = min(4, tw.colliders.capacity)
        _same_hit(tq.ray_hits(tw, origin, direction, k_hits, 30.0, solid),
                  _J_RAY_HITS(jw, origin, direction, k_hits, 30.0, jnp.asarray(solid)),
                  _RAY_FIELDS)


def test_the_reference_s_ray_checks():
    """tests/test_queries.py::test_cast_ray_sphere on the port."""
    _, tw = world("queries")
    hit = tq.cast_ray(tw, (0, 5, 0), (0, -1, 0))
    assert bool(hit.hit) and int(hit.collider) == 1
    assert abs(float(hit.distance) - 2.5) < 1e-6


# ---- shape casts (the casts themselves are cases_shape_casts.py's) -----------

_SHAPE_FIELDS = ("collider", "body", "hit", "distance", "point_a", "point_b", "normal")


# ---- filters and predicates ----------------------------------------------------------

def test_layer_mask_and_exclusion():
    """The capsule is on layer 1 only: a mask without layer 1 misses it; an
    excluded sphere lets the ray through to the half-space."""
    _, tw = world("queries")
    assert int(tq.cast_ray(tw, (-3, 5, 0), (0, -1, 0)).collider) == 3
    no_layer_1 = tq.QueryFilter(mask=0xFFFFFFFD)
    assert int(tq.cast_ray(tw, (-3, 5, 0), (0, -1, 0), qfilter=no_layer_1).collider) == 0
    excluded = torch.zeros(tw.colliders.capacity, dtype=torch.bool)
    excluded[1] = True
    hit = tq.cast_ray(tw, (0, 5, 0), (0, -1, 0), qfilter=tq.QueryFilter(excluded=excluded))
    assert int(hit.collider) == 0 and abs(float(hit.distance) - 5.0) < 1e-6


def _no_box(world, ids):
    return world.colliders.shape_type[ids] != int(ShapeType.BOX)


_J_RAY_PRED = jax.jit(jq.cast_ray_predicate, static_argnums=(3,))
_J_SHAPE_PRED = jax.jit(jq.cast_shape_predicate, static_argnums=(1, 6, 7))


def test_predicates_match_reference():
    jw, tw = world("queries")
    for origin in ((3.0, 5.0, 0.0), (3.2, 4.0, 0.3)):
        _same_hit(tq.cast_ray_predicate(tw, origin, (0, -1, 0), _no_box),
                  _J_RAY_PRED(jw, origin, (0, -1, 0), _no_box), _RAY_FIELDS)
        got = tq.cast_shape_predicate(tw, ShapeType.SPHERE, (0.3,), origin, (0, 0, 0, 1),
                                      (0, -1, 0), _no_box, max_distance=10.0)
        want = _J_SHAPE_PRED(jw, int(ShapeType.SPHERE), (0.3,), origin, (0, 0, 0, 1),
                             (0, -1, 0), _no_box, 10.0)
        _same_hit(got, want, _SHAPE_FIELDS)
        assert int(got.collider) == 0  # through the box to the half-space
