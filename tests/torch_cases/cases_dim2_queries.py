"""The port's 2D queries and character controller (``avian_tpu_torch.dim2.
queries`` and ``.character``) against the JAX reference (``avian_tpu.dim2``)
on the CPU, where Kernels AC, AD and AE run as their plain PyTorch twins:
every public function of both modules on ``tests/test_dim2_queries.py``'s
world, its segment-and-polygon world and ``box_pyramid_2d(6)`` after a few
steps (64 seeded rays solid and hollow, 64 points, 64 casts of five query
shapes, AABBs, filters and predicates), ``move_and_slide`` over 20 frames in
``tests/test_dim2_api.py``'s ``test_move_and_slide_2d`` world, and
``depenetrate`` from a start that overlaps.

The three query worlds share one capacity (22 bodies and colliders, the
pyramid's; the spare slots are inactive), so that one compile of the
reference serves them all. The reference is compiled one IEEE operation at a
time (``port_common.ieee_reference``). Indices, hit flags and lists are
compared exactly; distances, points and normals within ``TOL`` = 1e-5 m
(PyTorch's CPU ``sqrt``, ``cos`` and ``sin`` round a few ulp off XLA's);
the controller's positions and velocities within ``TOL`` too, and
``depenetrate``'s, which sums its pushes over the colliders in another
order than XLA, within ``TOL``.
"""

from port_common import ieee_reference

ieee_reference()

import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import functools  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from avian_tpu.core.types import BodyType  # noqa: E402
from avian_tpu.dim2 import character as jchar  # noqa: E402
from avian_tpu.dim2 import queries as jq  # noqa: E402
from avian_tpu.queries.filter import QueryFilter as JFilter  # noqa: E402
from avian_tpu_torch import PhysicsConfig as TConfig  # noqa: E402
from avian_tpu_torch.dim2 import SceneBuilder2D, physics_step_2d  # noqa: E402
from avian_tpu_torch.dim2 import broadphase as tbp  # noqa: E402
from avian_tpu_torch.dim2 import character as tchar  # noqa: E402
from avian_tpu_torch.dim2 import queries as tq  # noqa: E402
from avian_tpu_torch.dim2 import scenes as tscenes  # noqa: E402
from avian_tpu_torch.kernels import point_2d as kad  # noqa: E402
from avian_tpu_torch.kernels import ray_cast_2d as kac  # noqa: E402
from avian_tpu_torch.kernels import shape_cast_2d as kae  # noqa: E402
from avian_tpu_torch.queries.filter import QueryFilter, with_predicate  # noqa: E402

from cases_dim2 import to_jax2d  # noqa: E402
from port_common import as_numpy  # noqa: E402

torch.set_num_threads(1)
TOL = 1e-5
CAP = 22  # bodies and colliders of box_pyramid_2d(6)
RAYS, POINTS, CASTS, BOXES = 64, 64, 64, 8
POINT_HITS = 4
DEPENETRATE_ITERS = 3
LAYER = 2  # the layer of every third collider; the filtered queries see layer 1 only


@pytest.fixture(autouse=True)
def _inference_mode():
    with torch.inference_mode():
        yield


def _shapes(q, **kw):
    """The five query shapes: a circle, a capsule, a rectangle, a rounded
    rectangle and a CW 6-gon (rewound)."""
    hexagon = [(0.35 * np.cos(a), 0.35 * np.sin(a)) for a in -np.arange(6) * np.pi / 3]
    return [q.shape_circle(0.3, **kw), q.shape_capsule(0.2, 0.6, axis=(1.0, 1.0), **kw),
            q.shape_rect(0.4, 0.25, **kw), q.shape_rect(0.3, 0.2, 0.1, **kw),
            q.shape_polygon(hexagon, **kw)]


def _even_bodies(w, ids):
    return w.colliders.body_idx[ids] % 2 == 0


def _not_planes(w, ids):
    return ~w.colliders.is_plane[ids]


# ---------------------------------------------------------------------------
# Worlds and inputs
# ---------------------------------------------------------------------------


def _queries_world():
    """``tests/test_dim2_queries.py``'s world: a circle, a box, a capsule, a
    rounded rectangle and a ground half-space."""
    b = SceneBuilder2D()
    ground = b.add_body(pos=(0.0, -3.0), body_type=BodyType.STATIC)
    b.half_space(ground, normal=(0.0, 1.0))
    for pos, add in (((0.0, 0.0), lambda c: b.circle(c, 1.0)),
                     ((5.0, 0.0), lambda c: b.box(c, 1.0, 1.0)),
                     ((10.0, 0.0), lambda c: b.capsule(c, 0.5, 2.0)),
                     ((-5.0, 0.0), lambda c: b.round_rectangle(c, 2.0, 2.0, 0.25))):
        add(b.add_body(pos=pos, body_type=BodyType.STATIC))
    return b.finalize(max_bodies=CAP, max_colliders=CAP, device="cpu")


def _segment_world():
    """Its sharp (radius 0) segment and triangle (``test_segment_and_polygon_rays``)."""
    b = SceneBuilder2D()
    s = b.add_body(pos=(0.0, 0.0), body_type=BodyType.STATIC)
    b.segment(s, (-1.0, 1.0), (1.0, 1.0))
    t = b.add_body(pos=(4.0, 0.0), body_type=BodyType.STATIC)
    b.triangle(t, (-1.0, 0.0), (1.0, 0.0), (0.0, 2.0))
    return b.finalize(max_bodies=CAP, max_colliders=CAP, device="cpu")


def _pyramid_world():
    """``box_pyramid_2d(6)`` after 3 steps (its boxes settling)."""
    world, _ = tscenes.box_pyramid_2d(6, device="cpu")
    for _ in range(3):
        world = physics_step_2d(world, TConfig(substeps=4, max_colors=8))
    return world


def _with_aabbs_and_layers(world):
    """The world with this step's AABBs stored and every third collider in
    ``LAYER`` alone."""
    world = tbp.update_aabbs(world, TConfig(), tbp.collider_poses(world))
    col = world.colliders
    third = torch.arange(col.capacity) % 3 == 2
    return world.replace(colliders=col.replace(
        layer_members=torch.where(third, LAYER, col.layer_members)))


def _inputs(seed, lo, hi, fixed_rays=()):
    """Seeded query inputs over the box [lo, hi]: rays (the ``fixed_rays``
    first), their max distances (a third unbounded), points, casts (origin,
    angle, unit direction, max distance, shape index), AABBs and an exclusion
    mask."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    o = rng.uniform(lo, hi, (RAYS, 2))
    a = rng.uniform(0, 2 * np.pi, RAYS)
    d = np.stack([np.cos(a), np.sin(a)], -1)
    for k, (fo, fd) in enumerate(fixed_rays):
        o[k], d[k] = fo, fd
    md = np.where(rng.random(RAYS) < 0.33, 1e30, rng.uniform(0.5, 15.0, RAYS))
    ca = rng.uniform(0, 2 * np.pi, CASTS)
    box_lo = rng.uniform(lo, hi, (BOXES, 2))
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return dict(
        ray_o=f32(o), ray_d=f32(d), ray_md=f32(md), points=f32(rng.uniform(lo, hi, (POINTS, 2))),
        cast_o=f32(rng.uniform(lo, hi, (CASTS, 2))), cast_angle=f32(rng.uniform(-1, 1, CASTS)),
        cast_d=f32(np.stack([np.cos(ca), np.sin(ca)], -1)),
        cast_md=f32(rng.uniform(0.5, 8.0, CASTS)), cast_shape=np.arange(CASTS) % 5,
        box_lo=f32(box_lo), box_hi=f32(box_lo + rng.uniform(0.1, 3.0, (BOXES, 2))),
        excluded=rng.random(CAP) < 0.2,
    )


# ---------------------------------------------------------------------------
# The reference: one compile of each function, in threads of their own
# ---------------------------------------------------------------------------


def _reference(world, o, d, md, p, lo, hi, shape, co, ca, cd, cmd, qf):
    """Every public query of the reference on ``world`` for one input of each
    kind (a ray ``o``, ``d``, ``md``; a point ``p``; an AABB ``lo``, ``hi``;
    a cast of ``shape`` from ``co`` at angle ``ca`` along ``cd`` up to
    ``cmd``) under the filter ``qf``. ``ray_hits`` and ``shape_hits`` return
    every collider, in order, so every collider's t, points and normal are
    held; ``_all_ray_hits``, ``_point_one`` over the colliders and
    ``_manifold_vs_all`` are Kernels AC's, AD's and AE's 0-round outputs."""
    out = {}
    for solid in (True, False):
        out[f"cast_ray {solid}"] = jq.cast_ray(world, o, d, md, solid, qf)
        out[f"ray_hits {solid}"] = jq.ray_hits(world, o, d, CAP, md, solid, qf)
        out[f"all_ray_hits {solid}"] = jq._all_ray_hits(world, o, jq._normalize(d), solid, qf)
        out[f"project_point {solid}"] = jq.project_point(world, p, solid, qf)
    out["cast_ray_predicate"] = jq.cast_ray_predicate(world, o, d, _even_bodies, md, qfilter=qf)
    out["project_point_predicate"] = jq.project_point_predicate(world, p, _not_planes,
                                                                qfilter=qf)
    pos, _, wv, pn = jq._world_geom(world)
    col = world.colliders
    out["all_point_hits"] = jax.vmap(
        lambda vw, cnt, r, pl, n_, pp: jq._point_one(p, vw, cnt, r, pl, n_, pp))(
        wv, col.vert_count, col.radius, col.is_plane, pn, pos)
    out["point_intersections"] = jq.point_intersections(world, p, POINT_HITS, qf)
    out["aabb_intersections"] = jq.aabb_intersections(world, lo, hi, POINT_HITS, qf)
    out["shape_intersections"] = jq.shape_intersections(world, shape, co, ca, POINT_HITS, qf)
    out["manifold_vs_all"] = jq._manifold_vs_all(world, *shape, co, ca)
    out["cast_shape"] = jq.cast_shape(world, shape, co, ca, cd, cmd, qf)
    out["shape_hits"] = jq.shape_hits(world, shape, co, ca, cd, cmd, CAP, qf)
    return out


def _slide_world():
    """``tests/test_dim2_api.py::test_move_and_slide_2d``'s world: a ground
    half-space and a wall box (half extents 0.5 x 2) at (3, 2)."""
    b = SceneBuilder2D()
    ground = b.add_body(body_type=BodyType.STATIC)
    b.half_space(ground, normal=(0.0, 1.0))
    wall = b.add_body(pos=(3.0, 2.0), body_type=BodyType.STATIC)
    b.box(wall, 0.5, 2.0)
    return b.finalize(max_bodies=CAP, max_colliders=CAP, device="cpu")


def _move(world, pos, vel):
    return jchar.move_and_slide(world, jq.shape_capsule(0.4, 1.0), pos, vel, dt=1.0 / 10)


def _depenetrate(world, shape, pos, angle, qf):
    return jchar.depenetrate(world, shape, pos, angle, qf, iters=DEPENETRATE_ITERS)


def _filter(excluded=None):
    """A reference filter whose leaves keep one shape, so that one compile
    serves every filter."""
    return JFilter(excluded=jnp.zeros((CAP,), bool) if excluded is None else excluded)


# The reference's helpers that the reference functions call more than once
# (with the positions of their static arguments): jitted while the reference
# is traced, so that one trace serves every call (the slide world has the
# query worlds' capacity, so the calls share their shapes too). The
# operations are the same; the package is not changed, and the names are
# restored after.
_CALLED_AGAIN = ((jq, "_all_ray_hits", (3,)), (jq, "_sweep_all", ()),
                 (jq, "_manifold_vs_all", ()), (jq, "_point_one", ()),
                 (jchar, "cast_shape", ()), (jchar, "depenetrate", (5, 6)))


_JITTED = {(mod, name): jax.jit(getattr(mod, name), static_argnums=static)
           for mod, name, static in _CALLED_AGAIN}


@contextlib.contextmanager
def _traced_once():
    kept = [(mod, name, getattr(mod, name)) for mod, name, _ in _CALLED_AGAIN]
    for (mod, name), fn in _JITTED.items():
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in kept:
            setattr(mod, name, fn)


@functools.cache
def _compiled():
    """The three reference functions, each traced and compiled once (for the
    shapes of the query worlds, of the slide world), one after the other in a
    thread while the port runs: {name: future of the compiled function}."""
    f32 = lambda *shape: jnp.zeros(shape, jnp.float32)  # noqa: E731
    jw = to_jax2d(_segment_world())
    slide = to_jax2d(_slide_world())
    shape = jq.shape_circle(0.3)
    jobs = {
        "queries": (_reference, (jw, f32(2), f32(2), f32(), f32(2), f32(2), f32(2), shape,
                                 f32(2), f32(), f32(2), f32(), _filter())),
        "move": (_move, (slide, f32(2), f32(2))),
        "depenetrate": (_depenetrate, (slide, shape, f32(2), f32(), _filter())),
    }

    def compile_one(fn, args):
        with _traced_once():
            return jax.jit(fn).lower(*args).compile()

    pool = ThreadPoolExecutor(1)
    return {name: pool.submit(compile_one, fn, args) for name, (fn, args) in jobs.items()}


def _ref(name):
    return _compiled()[name].result()


_compiled()  # start compiling as the module loads


def _port(world, x, shapes, qf, predicate, n_rays, n_points, n_casts):
    """The port's same queries as a user makes them, one call each, on the
    first ``n_rays`` rays, ``n_points`` points and ``n_casts`` casts (the
    functions that take many at once on all of them). With ``predicate``
    the predicate variants run in place of the plain calls: the ray's and
    the point's under ``qf`` (the shape predicate's filter), the shape cast's
    alone."""
    out = {}
    rays = list(zip(x["ray_o"], x["ray_d"], x["ray_md"].tolist()))[:n_rays]
    points = x["points"][:n_points]
    casts = list(zip(x["cast_shape"], x["cast_o"], x["cast_angle"].tolist(), x["cast_d"],
                     x["cast_md"].tolist()))[:n_casts]
    if predicate:
        out["cast_ray_predicate"] = [tq.cast_ray_predicate(world, o, d, _even_bodies, md,
                                                           qfilter=qf) for o, d, md in rays]
        out["project_point_predicate"] = [tq.project_point_predicate(world, p, _not_planes,
                                                                     qfilter=qf) for p in points]
        out["cast_shape"] = [tq.cast_shape_predicate(world, shapes[k], o, a, d, _not_planes, md)
                             for k, o, a, d, md in casts]
        return out
    for solid in (True, False):
        out[f"cast_ray {solid}"] = [tq.cast_ray(world, o, d, md, solid, qf) for o, d, md in rays]
        out[f"ray_hits {solid}"] = [tq.ray_hits(world, o, d, CAP, md, solid, qf)
                                    for o, d, md in rays]
        out[f"all_ray_hits {solid}"] = tq.all_ray_hits(
            world, x["ray_o"][:n_rays], tq.normalize(torch.from_numpy(x["ray_d"][:n_rays])),
            solid, qf)
        out[f"project_point {solid}"] = [tq.project_point(world, p, solid, qf) for p in points]
    out["all_point_hits"] = tq.all_point_hits(world, points)
    out["point_intersections"] = [tq.point_intersections(world, p, POINT_HITS, qf)
                                  for p in points]
    out["aabb_intersections"] = [tq.aabb_intersections(world, lo, hi, POINT_HITS, qf)
                                 for lo, hi in zip(x["box_lo"], x["box_hi"])]
    out["shape_intersections"] = [tq.shape_intersections(world, shapes[k], o, a, POINT_HITS, qf)
                                  for k, o, a, d, md in casts]
    out["manifold_vs_all"] = [tq.manifold_vs_all(world, shapes[k], o, a)
                              for k, o, a, d, md in casts]
    out["cast_shape"] = [tq.cast_shape(world, shapes[k], o, a, d, md, qf)
                         for k, o, a, d, md in casts]
    out["shape_hits"] = [tq.shape_hits(world, shapes[k], o, a, d, md, CAP, qf)
                         for k, o, a, d, md in casts]
    return out


def _stacked(port):
    """A list of per-call results (dataclasses, dicts or tensors) as one
    {field: numpy array} (or one array), the reference's vmapped layout."""
    first = port[0]
    if isinstance(first, torch.Tensor):
        return np.stack([as_numpy(p) for p in port])
    if isinstance(first, dict):
        return {k: np.stack([as_numpy(p[k]) for p in port]) for k in first}
    if isinstance(first, tuple):  # a Cast2D of Kernel AE
        return {"sep": np.stack([as_numpy(p.sep) for p in port]),
                "normal": np.stack([as_numpy(p.normal) for p in port]),
                "count": np.stack([as_numpy(p.count) for p in port])}
    return {f.name: np.stack([as_numpy(getattr(p, f.name)) for p in port])
            for f in dataclasses.fields(first)}


def _fields(ref, n):
    """The reference's result as {field: numpy array}, its first ``n`` rows."""
    if isinstance(ref, dict):
        return {k: np.asarray(v)[:n] for k, v in ref.items()}
    if isinstance(ref, tuple):  # a grid (t, normal) or (distance, point)
        return {str(i): np.asarray(v)[:n] for i, v in enumerate(ref)}
    if hasattr(ref, "separation"):  # a Manifold2D
        return {"sep": np.asarray(ref.separation).min(-1)[:n],
                "normal": np.asarray(ref.normal)[:n], "count": np.asarray(ref.count)[:n]}
    if dataclasses.is_dataclass(ref):
        return {f.name: np.asarray(getattr(ref, f.name))[:n] for f in dataclasses.fields(ref)}
    return {"": np.asarray(ref)[:n]}


def _hold(name, ref, port):
    """Discrete leaves exactly, floating ones within ``TOL`` (infinite
    distances of misses equal)."""
    if isinstance(port, list):
        port = _stacked(port)
    elif isinstance(port, tuple):
        port = {str(i): as_numpy(v) for i, v in enumerate(port)}
    if not isinstance(port, dict):
        port = {"": as_numpy(port)}
    n = next(iter(port.values())).shape[0]
    for key, r in _fields(ref, n).items():
        p = port[key]
        assert p.shape == r.shape, (name, key, p.shape, r.shape)
        if np.issubdtype(r.dtype, np.floating):
            np.testing.assert_allclose(p, r, atol=TOL, rtol=0, err_msg=f"{name} {key}")
        else:
            np.testing.assert_array_equal(p, r, err_msg=f"{name} {key}")


def _hold_world(world, x, n_rays, n_points, n_casts):
    """The port against the reference on ``world``: unfiltered (on the first
    ``n_rays``, ``n_points``, ``n_casts``), under a layer mask and an
    exclusion mask and as the predicate variants (on 16 rays and points and
    8 casts; the
    reference's ``cast_shape_predicate`` is its ``cast_shape`` under
    ``_with_predicate``'s filter, which is how it is defined, :621-627).
    Returns the unfiltered reference results."""
    shapes_t, shapes_j = _shapes(tq, device="cpu"), _shapes(jq)
    jw = to_jax2d(world)
    xj = {k: jnp.asarray(v) for k, v in x.items()}
    excluded = x["excluded"]
    variants = (
        (_filter(), QueryFilter(), False, (n_rays, n_points, n_casts)),
        (JFilter(mask=jnp.asarray(1, jnp.uint32), excluded=jnp.asarray(excluded)),
         QueryFilter(mask=1, excluded=torch.from_numpy(excluded)), False, (16, 16, 8)),
        (jq._with_predicate(jw, None, _not_planes), with_predicate(world, None, _not_planes),
         True, (16, 16, 8)),
    )
    ports = [_port(world, x, shapes_t, tf, predicate, *n) for _, tf, predicate, n in variants]
    run = _ref("queries")  # the port's work is done before waiting for the compile
    first = None
    for (jf, tf, predicate, n), port in zip(variants, ports):
        calls = [run(jw, xj["ray_o"][i], xj["ray_d"][i], xj["ray_md"][i], xj["points"][i],
                     xj["box_lo"][i % BOXES], xj["box_hi"][i % BOXES],
                     shapes_j[int(x["cast_shape"][i])], xj["cast_o"][i], xj["cast_angle"][i],
                     xj["cast_d"][i], xj["cast_md"][i], jf) for i in range(max(n))]
        ref = jax.tree.map(lambda *leaves: np.stack([np.asarray(x) for x in leaves]), *calls)
        for name, p in port.items():
            _hold(f"{name} {'predicate' if predicate else tf.mask}", ref[name], p)
        first = first or ref
    return first


def _count_hits(ref, name):
    return int(np.asarray(ref[name].hit).sum())


# ---------------------------------------------------------------------------
# Cases
# ---------------------------------------------------------------------------


def test_query_shapes_match_reference():
    """The four constructors leaf for leaf (a CW polygon is rewound); more
    than 8 vertices raise; the three kernels' wrappers refuse a device that
    is neither the CPU nor CUDA."""
    for t, j in zip(_shapes(tq, device="cpu"), _shapes(jq)):
        for a, b in zip(t, j):
            assert as_numpy(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(as_numpy(a), np.asarray(b))
    with pytest.raises(ValueError):
        tq.shape_polygon(np.zeros((9, 2)), device="cpu")
    meta = [x.to("meta") for x in tq.collider_tables(_segment_world())]
    with pytest.raises(RuntimeError):
        kac.ray_cast_2d(torch.zeros((1, 4), device="meta"), True, *meta)
    with pytest.raises(RuntimeError):
        kad.point_2d(torch.zeros((1, 2), device="meta"), *meta)
    with pytest.raises(RuntimeError):
        kae.shape_cast_2d(torch.zeros(8, device="meta"),
                          *(s.to("meta") for s in tq.shape_circle(0.5, device="cpu")), *meta)


def test_pyramid_world_matches_reference():
    """``box_pyramid_2d(6)`` after 3 steps: 64 seeded rays, points and casts
    around and inside it."""
    world = _with_aabbs_and_layers(_pyramid_world())
    ref = _hold_world(world, _inputs(3, (-5.0, -1.0), (5.0, 7.0)), RAYS, POINTS, CASTS)
    assert _count_hits(ref, "cast_ray True") > 30 and _count_hits(ref, "cast_shape") > 10


def test_queries_world_matches_reference():
    """``tests/test_dim2_queries.py``'s world: its own rays first (circle,
    box face, rounded corner, capsule cap, ground, from inside the circle,
    up into nothing), then seeded ones; 16 rays, points and casts."""
    world = _with_aabbs_and_layers(_queries_world())
    diag = np.array([-1.0, -1.0]) / np.sqrt(2.0)
    fixed = [((-3.0, 0.0), (1.0, 0.0)), ((5.0, 4.0), (0.0, -1.0)), ((-2.0, 3.0), diag),
             ((10.0, 5.0), (0.0, -1.0)), ((100.0, 2.0), (0.0, -1.0)), ((0.0, 0.0), (1.0, 0.0)),
             ((0.0, 5.0), (0.0, 1.0))]
    ref = _hold_world(world, _inputs(1, (-8.0, -4.0), (12.0, 4.0), fixed), 16, 16, 16)
    assert _count_hits(ref, "cast_ray True") > 5 and _count_hits(ref, "cast_shape") > 3


def test_segment_and_polygon_world_matches_reference():
    """Sharp segment and triangle: the thin-segment slab, rays beside an end;
    16 rays, points and casts."""
    world = _with_aabbs_and_layers(_segment_world())
    fixed = [((0.0, 3.0), (0.0, -1.0)), ((4.0, 3.0), (0.0, -1.0)), ((1.5, 3.0), (0.0, -1.0)),
             ((1.0, 3.0), (0.0, -1.0)), ((-3.0, 1.0), (1.0, 0.0))]
    ref = _hold_world(world, _inputs(2, (-3.0, -2.0), (6.0, 4.0), fixed), 16, 16, 16)
    assert _count_hits(ref, "cast_ray True") > 5 and _count_hits(ref, "cast_shape") > 1


def test_move_and_slide_matches_reference():
    """20 frames of ``move_and_slide`` at 10 Hz, forward and into the
    ground, into the wall: each frame's position, velocity and last normal;
    the source's own checks (above the ground, stopped at the wall after
    travelling there); ``project_velocity`` into a corner."""
    world = _slide_world()
    shape = tq.shape_capsule(0.4, 1.0, device="cpu")
    tp, vel = torch.tensor([0.0, 0.9]), (2.0, -1.0)
    frames = []
    for _ in range(20):
        tp, tv, tn = tchar.move_and_slide(world, shape, tp, vel, dt=1.0 / 10)
        frames.append((tp, tv, tn))
    jw, move = to_jax2d(world), _ref("move")
    jp = jnp.asarray([0.0, 0.9])
    for frame, got in enumerate(frames):
        jp, jv, jn = move(jw, jp, jnp.asarray(vel))
        for what, a, b in zip(("pos", "velocity", "normal"), got, (jp, jv, jn)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=0,
                                       err_msg=f"frame {frame} {what}")
    assert float(tp[1]) >= 0.9 - 0.02
    assert 1.5 < float(tp[0]) <= 2.5 - 0.4 + 0.02
    planes = torch.tensor([[0.0, 1.0], [-1.0, 0.0], [0.0, 0.0]])
    for v, n, k in (((2.0, -1.0), (-1.0, 0.0), 1), ((2.0, -1.0), (0.0, 1.0), 2),
                    ((-1.0, 3.0), (0.6, 0.8), 2)):
        got = tchar.project_velocity(torch.tensor(v), torch.tensor(n), planes, torch.tensor(k))
        want = jchar.project_velocity(jnp.asarray(v), jnp.asarray(n), jnp.asarray(planes.numpy()),
                                      jnp.asarray(k))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_depenetrate_from_an_overlapping_start():
    """A capsule started 0.3 m into the wall's corner and the ground, and a
    turned box started inside the wall: both pushed out as the reference
    pushes them, unfiltered and with the ground excluded."""
    world = _slide_world()
    jw, run = to_jax2d(world), _ref("depenetrate")
    excluded = np.arange(CAP) == 0
    for make, pos, angle in ((lambda q, **k: q.shape_capsule(0.4, 1.0, **k), (2.3, 0.6), 0.0),
                             (lambda q, **k: q.shape_rect(0.3, 0.2, **k), (2.7, 1.0), 0.3)):
        shape_t, shape_j = make(tq, device="cpu"), make(jq)
        for tf, jf in ((QueryFilter(), _filter()),
                       (QueryFilter(excluded=torch.from_numpy(excluded)),
                        JFilter(excluded=jnp.asarray(excluded)))):
            got = tchar.depenetrate(world, shape_t, pos, angle, tf, iters=DEPENETRATE_ITERS)
            want = run(jw, shape_j, jnp.asarray(pos, jnp.float32), jnp.asarray(angle, jnp.float32),
                       jf)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
            assert float((got - torch.tensor(pos)).abs().max()) > 0.05
