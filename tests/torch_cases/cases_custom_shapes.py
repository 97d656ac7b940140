"""User shapes (``avian_tpu_torch.api.CustomShape``) against the JAX
reference, on the plain versions of their kernels: the ellipsoid of
``examples/custom_collider.py`` (``shared_ext.ELLIPSOID``), with

- every custom pair's manifold (the ellipsoid against a sphere, capsule,
  box, half-space, cylinder, cone, segment, hull and ellipsoid) on 64 seeded
  poses, half of them given custom side first, through ``compute_manifolds``
  (the bucketing and the swap) against the reference's ``compute_manifold``,
  counts and feature ids exactly, the rest within ``TOL``, as
  ``cases_convex_manifold.py`` and ``cases_hull_manifold.py`` hold M and P;
- the AABBs of a world of turned ellipsoids among built-in shapes exactly
  (Kernel E's custom pass), the reference run live;
- 256 seeded rays into that world in both ``solid`` modes (Kernel AJ beside
  T): every (ray, collider) hit flag exactly, distance and normal within
  ``TOL``, as ``cases_queries.py`` holds T;
- 256 seeded points, 64 at ellipsoid centres (AF's custom instance): every
  (point, collider) distance and closest point within ``TOL``, inside flags
  exactly, and ``project_point`` and ``point_intersections``;
- the example's world, 40 steps on the port and then 10 by both packages,
  every body within ``STEP_TOL``;
- the swept CCD's rule: a swept sphere fired at an ellipsoid, and a swept
  ellipsoid fired at a box or a hull, are not rewound by the reference's
  sweep, whose dispatch gives custom pairs no manifold, nor by the port's;
- every entry point left for later raising on a world with custom shapes,
  a custom shape without CUDA source and a failed build raising, naming the
  shape, and the builder's and ``World.from_numpy``'s checks.

The reference is compiled one IEEE operation at a time
(``port_common.ieee_reference``); its outputs are read from
``custom_shapes_reference.npz`` (``port_common.Recording``, keyed by a digest
of its inputs; ``record_custom_shapes.py`` records them, some 20 s of
compile a support-map pair)."""

from port_common import ieee_reference

ieee_reference()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from avian_tpu import BodyType, CustomShape as JCustomShape, SceneBuilder as JBuilder  # noqa: E402
from avian_tpu.core.config import PhysicsConfig as JConfig  # noqa: E402
from avian_tpu.geometry import narrowphase as jgeo  # noqa: E402
from avian_tpu.math import quat as jquat  # noqa: E402
from avian_tpu.pipeline import broadphase as jbp  # noqa: E402
from avian_tpu.pipeline import ccd as jccd  # noqa: E402
from avian_tpu.pipeline import solver_body as jsb  # noqa: E402
from avian_tpu.pipeline.step import physics_step as j_step  # noqa: E402
from avian_tpu.queries import point as jpoint  # noqa: E402
from avian_tpu.queries import raycast as jraycast  # noqa: E402
from avian_tpu.queries.filter import QueryFilter as JQueryFilter  # noqa: E402
from avian_tpu_torch import SceneBuilder as TBuilder, ShapeType, physics_step  # noqa: E402
from avian_tpu_torch import character, contact_query, picking, queries as tq  # noqa: E402
from avian_tpu_torch.api import CustomShape  # noqa: E402
from avian_tpu_torch.core.config import PhysicsConfig as TConfig  # noqa: E402
from avian_tpu_torch.core.state import World  # noqa: E402
from avian_tpu_torch.geometry import narrowphase as tgeo  # noqa: E402
from avian_tpu_torch.kernels import custom_build, custom_shapes as kcs  # noqa: E402
from avian_tpu_torch.pipeline import broadphase as tbp  # noqa: E402
from avian_tpu_torch.pipeline import ccd as tccd  # noqa: E402
from avian_tpu_torch.pipeline import solver_body as tsb  # noqa: E402

import shared_ext as se  # noqa: E402
from port_common import (Recording, as_numpy, assert_manifolds_equal, quats,  # noqa: E402
                         rotate_np, to_jax)

TOL = 1e-5
STEP_TOL = 1e-4
K = 64
C = 16  # the ellipsoid's shape code
SPHERE, CAPSULE, BOX, PLANE, CYLINDER, CONE, SEGMENT, CONVEX = 0, 1, 2, 3, 4, 5, 6, 8
PAIRS = tuple((t, C) for t in (SPHERE, CAPSULE, BOX, PLANE, CYLINDER, CONE, SEGMENT, CONVEX)) \
    + ((C, C),)
RECORDING = Recording("custom_shapes")
ID = (0.0, 0.0, 0.0, 1.0)


def _j_support(prm, d):
    a2 = prm[:3] * prm[:3]
    v = a2 * d
    return v / jnp.sqrt(jnp.maximum(jnp.dot(d, v), 1e-12))


# The reference's ellipsoid: examples/custom_collider.py's make_ellipsoid.
J_ELLIPSOID = JCustomShape("ellipsoid", support=_j_support, aabb_half_extents=lambda p: p[:3])
T_ELLIPSOID = se.ELLIPSOID


def _plain(jw):
    """The reference world without its custom shapes, whose functions'
    addresses would enter a digest of it."""
    return jw.replace(custom_shapes=())


def _port(jw):
    return World.from_numpy(jax.tree.map(np.asarray, jw), device="cpu",
                            custom_shapes=(T_ELLIPSOID,))


# ---- pairs -------------------------------------------------------------------------

def _hull():
    """A 12-vertex hull of radius 0.5: its params row and the vertex pool."""
    rng = np.random.default_rng(31)
    p = rng.normal(size=(12, 3))
    b = JBuilder()
    b.convex_hull(b.add_body(), (0.5 * p / np.linalg.norm(p, axis=1, keepdims=True)).astype(
        np.float32))
    w = b.finalize()
    return np.asarray(w.colliders.params[0]), np.asarray(w.convex_verts)


def _params(rng, shape, k, hull_row):
    u = lambda lo, hi: rng.uniform(lo, hi, k).astype(np.float32)  # noqa: E731
    out = np.zeros((k, 8), np.float32)
    if shape == SPHERE:
        out[:, 0] = u(0.2, 0.5)
    elif shape in (CAPSULE, CYLINDER, CONE):
        out[:, 0], out[:, 1] = u(0.2, 0.5), u(0.2, 0.4)
    elif shape == BOX:
        out[:, :3] = np.stack([u(0.2, 0.6), u(0.2, 0.6), u(0.2, 0.6)], 1)
    elif shape == PLANE:
        out[:, 1] = 1.0
    elif shape == SEGMENT:
        out[:, 0] = u(0.2, 0.6)
    elif shape == CONVEX:
        out[:] = hull_row
    else:  # the ellipsoid's semi-axes
        out[:, :3] = np.stack([u(0.2, 0.6), u(0.15, 0.4), u(0.2, 0.6)], 1)
    return out


def _reach(shape, prm):
    if shape == SPHERE:
        return prm[:, 0]
    if shape in (CAPSULE, CYLINDER, CONE):
        return prm[:, 0] + prm[:, 1]
    if shape in (BOX, C):
        return np.linalg.norm(prm[:, :3], axis=1) if shape == BOX else prm[:, :3].max(1)
    if shape == SEGMENT:
        return prm[:, 0]
    return np.full(prm.shape[0], 0.5, np.float32)


def pair_inputs(pair, seed):
    """K seeded poses of ``pair``: centres 0.4-1.1 of the summed reaches
    apart (a half-space's normal tilted a little, the shape 0-1.1 of its
    reach above it), odd rows given custom side first. Returns (types i32[2,
    K], pos f32[2, K, 3], quat f32[2, K, 4], params f32[2, K, 8], pool)."""
    rng = np.random.default_rng(seed)
    hull_row, pool = _hull()
    ta, tb = pair
    prm_a, prm_b = _params(rng, ta, K, hull_row), _params(rng, tb, K, hull_row)
    pa = rng.uniform(-1.0, 1.0, (K, 3)).astype(np.float32)
    qa, qb = quats(rng, K, 0.8), quats(rng, K, 0.8)
    if ta == PLANE:
        qa = quats(rng, K, 0.1)
        reach = _reach(tb, prm_b) * rng.uniform(0.0, 1.1, K).astype(np.float32)
        pb = pa + rotate_np(qa, np.tile([[0.0, 1.0, 0.0]], (K, 1)).astype(np.float32)) \
            * reach[:, None]
    else:
        d = rng.normal(size=(K, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        reach = (_reach(ta, prm_a) + _reach(tb, prm_b)) * rng.uniform(0.4, 1.1, K)
        pb = (pa + d * reach[:, None].astype(np.float32)).astype(np.float32)
    types = np.asarray([[ta] * K, [tb] * K], np.int32)
    sides = [np.stack(x) for x in ((pa, pb), (qa, qb), (prm_a, prm_b))]
    odd = np.arange(K) % 2 == 1
    for x in [types] + sides:
        x[:, odd] = x[::-1][:, odd]
    return types, sides[0].astype(np.float32), sides[1].astype(np.float32), sides[2], pool


def _ref_manifolds(pair, types, pos, quat, prm, pool):
    fn = jax.jit(jax.vmap(lambda ta, pa, qa, ra, tb, pb, qb, rb: jgeo.compute_manifold(
        ta, pa, qa, ra, tb, pb, qb, rb, shape_pairs=(pair,), convex_verts=jnp.asarray(pool),
        custom_shapes=(J_ELLIPSOID,))))
    return fn(types[0], pos[0], quat[0], prm[0], types[1], pos[1], quat[1], prm[1])


@pytest.mark.parametrize("pair", PAIRS, ids=[f"{a}-{b}" for a, b in PAIRS])
def test_custom_pair_manifolds_match_reference(pair):
    types, pos, quat, prm, pool = pair_inputs(pair, 700 + 10 * pair[0])
    ref = RECORDING((pair, types, pos, quat, prm, pool),
                    lambda: _ref_manifolds(pair, types, pos, quat, prm, pool))
    t = torch.from_numpy
    port, sizes = tgeo.compute_manifolds(
        t(types.reshape(-1)), t(prm.reshape(-1, 8)), t(pos.reshape(-1, 3)),
        t(quat.reshape(-1, 4)), torch.arange(K), torch.arange(K) + K,
        torch.ones(K, dtype=torch.bool), (pair,), t(pool), (T_ELLIPSOID,))
    assert sizes == {pair: K}
    port = (port.normal, port.point_a, port.point_b, port.separation, port.feature_id,
            port.count)
    assert_manifolds_equal(ref, port, TOL)
    counts = np.asarray(ref.count)
    assert (counts >= 1).all() and (np.asarray(ref.separation).min(1) < 0).sum() > 4


# ---- a world of turned ellipsoids --------------------------------------------------

def query_world(builder, shape, **kw):
    """A half-space, 8 turned ellipsoids of seeded semi-axes among a box, a
    sphere, a capsule and a cylinder, and a hull. Returns ``(world,
    ellipsoid bodies)``."""
    rng = np.random.default_rng(11)
    b = builder()
    g = b.add_body(body_type=BodyType.STATIC)
    b.half_space(g, normal=(0, 1, 0))
    ellipsoids = []
    makers = (lambda body: b.box(body, 0.4, 0.3, 0.5), lambda body: b.sphere(body, 0.45),
              lambda body: b.capsule(body, 0.3, 0.8), lambda body: b.cylinder(body, 0.35, 0.9))
    for k in range(12):
        q = rng.normal(size=4)
        body = b.add_body(body_type=BodyType.STATIC,
                          pos=((k % 4) * 1.5 - 2.25, 1.0 + (k // 4) * 1.2,
                               float(rng.uniform(-0.5, 0.5))), quat=tuple(q / np.linalg.norm(q)))
        if k % 3 == 2:
            makers[k // 3](body)
        else:
            semi = tuple(float(x) for x in rng.uniform(0.2, 0.6, 3))
            m, i = se.ellipsoid_mass_inertia(*semi)
            b.custom_collider(body, shape=shape, params=semi, mass=m, inertia=i)
            ellipsoids.append(body)
    p = rng.normal(size=(10, 3))
    b.convex_hull(b.add_body(body_type=BodyType.STATIC, pos=(0.0, 0.6, 2.0)),
                  (0.5 * p / np.linalg.norm(p, axis=1, keepdims=True)).astype(np.float32))
    return b.finalize(max_bodies=16, max_colliders=16, max_contacts=64, **kw), ellipsoids


def _worlds():
    jw, ids = query_world(JBuilder, J_ELLIPSOID)
    tw, _ = query_world(TBuilder, T_ELLIPSOID, device="cpu")
    return jw, tw, ids


def test_world_matches_the_reference_s_and_its_aabbs_are_exact():
    """The builder's world leaf for leaf, and the AABBs of Kernel E with its
    custom pass equal to the reference's ``update_aabbs`` (run live)."""
    from port_common import assert_worlds_equal

    jw, tw, _ = _worlds()
    assert_worlds_equal(_plain(jw), tw)
    assert tw.custom_shapes == (T_ELLIPSOID,)
    ref = RECORDING(_plain(jw), lambda: jax.jit(jbp.update_aabbs, static_argnums=1)(
        jw, JConfig()).colliders, live=True)
    got = tbp.update_aabbs(tw, TConfig(), tw.custom_shapes).colliders
    np.testing.assert_array_equal(as_numpy(got.aabb_min), ref.aabb_min)
    np.testing.assert_array_equal(as_numpy(got.aabb_max), ref.aabb_max)
    custom = as_numpy(tw.colliders.shape_type) == C
    assert custom.sum() == 8


def _rays(n, seed):
    """``n`` rays from a box around the world toward points in it, an
    eighth starting inside an ellipsoid's reach."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-5, 5, (n, 3)) + [0.0, 3.0, 0.0]
    target = rng.uniform(-2.5, 2.5, (n, 3)) + [0.0, 2.0, 0.0]
    o[: n // 8] = target[: n // 8] + rng.uniform(-0.1, 0.1, (n // 8, 3))
    d = target - o + [1e-3, 0.0, 0.0]
    return o.astype(np.float32), (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("solid", [True, False])
def test_rays_match_reference(solid):
    jw, tw, _ = _worlds()
    o, d = _rays(256, 5)
    jw_aabbs = jbp.update_aabbs(jw, JConfig())

    def reference():
        fn = jax.jit(jax.vmap(lambda oo, dd: jraycast._all_hits(
            jw_aabbs, oo, dd, jnp.asarray(solid), JQueryFilter())))
        return fn(jnp.asarray(o), jnp.asarray(d))

    jt, jn = RECORDING((_plain(jw), o, d, solid), reference)
    tt, tn = tq.raycast.all_hits(tw, torch.from_numpy(o), torch.from_numpy(d), solid,
                                 tq.QueryFilter())
    tt, tn = as_numpy(tt), as_numpy(tn)
    hit = jt < jraycast._BIG
    np.testing.assert_array_equal(tt < jraycast._BIG, hit)
    custom = as_numpy(tw.colliders.shape_type) == C
    assert hit[:, custom].sum() > 20
    np.testing.assert_allclose(tt[hit], jt[hit], atol=TOL, rtol=0, err_msg="distance")
    np.testing.assert_allclose(tn[hit], jn[hit], atol=TOL, rtol=0, err_msg="normal")
    if solid:
        assert (tt[:, custom] == 0.0).sum() > 0  # rays that start inside
    # cast_ray and ray_hits take Kernel AJ's hits with T's.
    first = tq.cast_ray(tw, o[3], d[3], 30.0, solid)
    near = jt[3] <= 30.0
    want = int(np.argmin(np.where(near, jt[3], jraycast._BIG))) if near.any() else -1
    assert int(first.collider) == want
    many = tq.ray_hits(tw, o[3], d[3], 4, 30.0, solid)
    assert int(many.collider[0]) == int(first.collider)


def _points(n, seed, centres):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-3.0, 3.0, (n, 3)) + [0.0, 2.0, 0.0]
    k = n // 4
    pts[:k] = centres[np.arange(k) % centres.shape[0]] + rng.uniform(-0.08, 0.08, (k, 3))
    return pts.astype(np.float32)


def _ref_points(jw, pts):
    """The reference's ``_closest_local`` of every point and collider: world
    closest points and signed distances."""
    col = jw.colliders
    pos, quat = jbp.update_collider_poses(jw)
    pool = jw.convex_verts

    def one(p):
        def per(cp, cq, st, prm):
            c, d = jpoint._closest_local(jquat.rotate_inv(cq, p - cp), st, prm, pool,
                                         jw.custom_shapes)
            return cp + jquat.rotate(cq, c), d
        return jax.vmap(per)(pos, quat, col.shape_type, col.params)

    c, d = jax.jit(jax.vmap(one))(jnp.asarray(pts))
    return {"closest": c, "dist": d}


def test_points_match_reference():
    jw, tw, ids = _worlds()
    pts = _points(256, 6, np.asarray(jw.bodies.pos)[ids])
    ref = RECORDING((_plain(jw), pts), lambda: _ref_points(jw, pts))
    dist, closest, inside = (as_numpy(x) for x in tq.point.all_point_hits(tw, pts))
    custom = as_numpy(tw.colliders.shape_type) == C
    for cols in (custom, ~custom & (as_numpy(tw.colliders.shape_type) != CONVEX)):
        np.testing.assert_allclose(dist[:, cols], ref.dist[:, cols], atol=TOL, rtol=0)
        np.testing.assert_allclose(closest[:, cols], ref.closest[:, cols], atol=TOL, rtol=0)
        np.testing.assert_array_equal(inside[:, cols], ref.dist[:, cols] < 0.0)
    assert inside[:, custom].sum() >= 32
    # The entry points: a point at an ellipsoid's centre is inside it.
    hit = tq.project_point(tw, pts[0])
    assert bool(hit["is_inside"]) and int(hit["body"]) == ids[0]
    listed = as_numpy(tq.point_intersections(tw, pts[0]))
    assert int(hit["collider"]) in listed.tolist()


# ---- the example's world -------------------------------------------------------------

def test_example_world_steps_match_reference():
    """examples/custom_collider.py's world: 40 steps on the port (the
    ellipsoids land on the half-space), then 10 by both packages from that
    state, every body within ``STEP_TOL`` after each."""
    template, ids = se.custom_collider_world(JBuilder, J_ELLIPSOID)
    tw, _ = se.custom_collider_world(TBuilder, T_ELLIPSOID, device="cpu")
    cfg = TConfig(max_colors=8)
    for _ in range(40):
        tw = physics_step(tw, cfg)
    jw = to_jax(tw, template)

    def reference():
        step = jax.jit(lambda w: j_step(w, JConfig(max_colors=8)))
        out, w = [], jw
        for _ in range(10):
            w = step(w)
            out.append(w.bodies.pos)
        return jnp.stack(out)

    ref = RECORDING(_plain(jw), reference)
    for k in range(10):
        tw, diag = physics_step(tw, cfg, return_diagnostics=True)
        np.testing.assert_allclose(as_numpy(tw.bodies.pos), ref[k], atol=STEP_TOL, rtol=0,
                                   err_msg=f"step {41 + k}")
    assert diag["manifold_pairs"].get((PLANE, C), 0) >= 6
    assert bool((tw.bodies.pos[ids, 1] > 0.15).all())


# ---- swept CCD ---------------------------------------------------------------------

def _sweep_world(builder, shape, mover, wall, **kw):
    """A swept body at x = 0 (a sphere of radius 0.1, or an ellipsoid (0.2,
    0.2, 0.2)) before a static wall at x = 3 (an ellipsoid (0.3, 2, 2), or a
    box or a hull of those half extents)."""
    b = builder()
    body = b.add_body(body_type=BodyType.STATIC, pos=(3.0, 0.0, 0.0))
    if wall == "ellipsoid":
        m, i = se.ellipsoid_mass_inertia(0.3, 2.0, 2.0)
        b.custom_collider(body, shape=shape, params=(0.3, 2.0, 2.0), mass=m, inertia=i)
    elif wall == "hull":
        b.convex_hull(body, [(x, y, z) for x in (-0.3, 0.3) for y in (-2, 2) for z in (-2, 2)])
    else:
        b.box(body, 0.3, 2.0, 2.0)
    swept = b.add_body(pos=(0.0, 0.0, 0.0), swept_ccd=True, gravity_scale=0.0)
    if mover == "ellipsoid":
        m, i = se.ellipsoid_mass_inertia(0.2, 0.2, 0.2)
        b.custom_collider(swept, shape=shape, params=(0.2, 0.2, 0.2), mass=m, inertia=i)
    else:
        b.sphere(swept, 0.1)
    return b.finalize(max_bodies=4, max_colliders=4, max_contacts=16, **kw)


@pytest.mark.parametrize("mover,wall", [("bullet", "ellipsoid"), ("bullet", "box"),
                                        ("ellipsoid", "box"), ("ellipsoid", "hull")])
def test_swept_ccd_does_not_see_custom_shapes(mover, wall):
    """The reference's sweep asks its narrowphase without the custom shapes,
    so a pair with a custom collider gets no manifold there (its lookup runs
    past the custom codes: a hull wall's pair lands on the hull/hull entry,
    with the ellipsoid's lanes, and finds no contact): only a swept sphere
    before a box is rewound, in both packages, from a sweep of 5 m."""
    jw = _sweep_world(JBuilder, J_ELLIPSOID, mover, wall)
    tw = _sweep_world(TBuilder, T_ELLIPSOID, mover, wall, device="cpu")
    cfg = dict(swept_ccd=True, max_colors=4)
    dpos = np.zeros((4, 3), np.float32)
    dpos[1] = (5.0, 0.0, 0.0)

    def reference():
        jcfg = JConfig(**cfg)
        s = jsb.prepare(jw.bodies).replace(delta_pos=jnp.asarray(dpos))
        w2 = jbp.update_aabbs(jw, jcfg)
        return jax.jit(jccd.solve_swept_ccd, static_argnums=2)(w2, s, jcfg).delta_pos

    want = RECORDING((_plain(jw), dpos, mover, wall), reference)
    tcfg = TConfig(**cfg)
    s = tsb.prepare(tw.bodies)
    s.state[:, tsb.DPOS:tsb.DPOS + 3] = torch.from_numpy(dpos)
    w2, pos, quat = tbp.update_aabbs_and_poses(tw, tcfg, tw.custom_shapes)
    got = as_numpy(tccd.solve_swept_ccd(w2, s, pos, quat, tcfg)[0].delta_pos)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert (got[1, 0] < 3.0) == (mover == "bullet" and wall == "box")


# ---- what raises ---------------------------------------------------------------------

def test_entry_points_left_for_later_raise_on_custom_worlds():
    _, tw, _ = _worlds()
    s = (int(ShapeType.SPHERE), (0.3,))
    calls = {
        "cast_shape": lambda: tq.cast_shape(tw, *s, (0, 5, 0), ID, (0, -1, 0), 10.0),
        "shape_hits": lambda: tq.shape_hits(tw, *s, (0, 5, 0), ID, (0, -1, 0), 10.0, 4),
        "shape_intersections": lambda: tq.shape_intersections(tw, *s, (0, 1, 0), ID),
        "build_query_grid": lambda: tq.build_query_grid(tw),
        "cast_ray_grid": lambda: tq.cast_ray_grid(tw, None, torch.zeros((1, 3)),
                                                  torch.ones((1, 3)), 10.0),
        "update_ray_casters": lambda: tq.update_ray_casters(tw, None),
        "update_shape_casters": lambda: tq.update_shape_casters(tw, None),
        "move_and_slide": lambda: character.move_and_slide(tw, *s, (0, 5, 0), ID, (1, 0, 0),
                                                           0.1),
        "depenetrate": lambda: character.depenetrate(tw, *s, (0, 5, 0), ID),
        "contact": lambda: contact_query.contact(C, (0, 0, 0), ID, (0.5, 0.5, 0.5), SPHERE,
                                                 (0, 1, 0), ID, (0.3,), device="cpu"),
        "time_of_impact": lambda: contact_query.time_of_impact(
            SPHERE, (0, 1, 0), ID, (0.3,), (0, -1, 0), C, (0, 0, 0), ID, (0.5, 0.5, 0.5),
            (0, 0, 0), 1.0, device="cpu"),
    }
    for name, call in calls.items():
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()


def test_index_world_without_its_shapes_raises_and_steps_with_them():
    """A ``custom_collider(index=...)`` world carries custom codes and no
    tuple: every query raises rather than miss the collider, and the step
    raises unless ``physics_step`` is given the shapes, with which it steps."""
    b = TBuilder()
    g = b.add_body(body_type=BodyType.STATIC)
    b.half_space(g, normal=(0, 1, 0))
    m, i = se.ellipsoid_mass_inertia(0.5, 0.25, 0.5)
    body = b.add_body(pos=(0.0, 0.3, 0.0))
    b.custom_collider(body, index=0, params=(0.5, 0.25, 0.5), mass=m, inertia=i)
    tw = b.finalize(max_bodies=4, max_colliders=4, max_contacts=8, device="cpu")
    assert tw.custom_shapes == ()
    down = ((0.0, 5.0, 0.0), (0.0, -1.0, 0.0))
    s = (int(ShapeType.SPHERE), (0.3,))
    queries = {
        "cast_ray": lambda: tq.cast_ray(tw, *down),
        "ray_hits": lambda: tq.ray_hits(tw, *down, 4),
        "pick": lambda: picking.pick(tw, *down),
        "pick_batch": lambda: picking.pick_batch(tw, torch.tensor([down[0]]),
                                                 torch.tensor([down[1]])),
        "project_point": lambda: tq.project_point(tw, (0.0, 0.3, 0.0)),
        "point_intersections": lambda: tq.point_intersections(tw, (0.0, 0.3, 0.0)),
        "step": lambda: physics_step(tw, TConfig()),
        "cast_shape": lambda: tq.cast_shape(tw, *s, (0, 5, 0), ID, (0, -1, 0), 10.0),
        "cast_ray_grid": lambda: tq.cast_ray_grid(tw, tq.build_query_grid(tw),
                                                  torch.tensor([down[0]]),
                                                  torch.tensor([down[1]]), 10.0),
        "depenetrate": lambda: character.depenetrate(tw, *s, (0, 5, 0), ID),
    }
    for name, call in queries.items():
        with pytest.raises(ValueError, match="custom shape code past"):
            call()
    w = tw
    for _ in range(10):
        w = physics_step(w, TConfig(), custom_shapes=(T_ELLIPSOID,))
    assert torch.isfinite(w.bodies.pos).all()
    assert abs(float(w.bodies.pos[body, 1]) - 0.25) < 0.05  # resting on its semi-axis


def test_sources_builds_and_checks_raise_naming_the_shape():
    bare = se.make_ellipsoid(cuda=False)
    with pytest.raises(NotImplementedError, match="ellipsoid"):
        custom_build.library((bare,))
    broken = CustomShape("broken_ellipsoid", bare.support, bare.aabb_half_extents,
                         cuda="this is not CUDA")
    with pytest.raises(RuntimeError, match="broken_ellipsoid"):
        custom_build.library((broken,))  # no nvcc on the CPU, a compile error on the card
    # The generated unit names every instance the world needs.
    text = custom_build.unit_source((T_ELLIPSOID,), "other")
    for inst in ("custom_pair_kernel<8, 16>", "custom_pair_kernel<16, 16>",
                 "custom_plane_kernel<16>", "ray_support_kernel<16>", "custom_point_kernel<16>",
                 "custom_aabb_kernel<16>"):
        assert inst in text, inst
    # The wrappers take the plain versions only for CPU tensors.
    meta = torch.zeros((1, 3), device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        kcs.custom_convex_manifold(((T_ELLIPSOID,), (SPHERE, C)), meta, meta, meta, meta,
                                   meta, meta, meta)
    b = TBuilder()
    with pytest.raises(ValueError, match="mass"):
        b.custom_collider(b.add_body(), shape=T_ELLIPSOID, params=(1.0,))
    jw, _, _ = _worlds()
    with pytest.raises(ValueError, match="custom shapes"):
        World.from_numpy(jax.tree.map(np.asarray, jw), device="cpu")
    assert _port(jw).custom_shapes == (T_ELLIPSOID,)
