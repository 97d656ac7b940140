"""The port's query grid, grid ray casts and persistent casters
(``avian_tpu_torch.queries.accel``; Kernel AG and Kernel E's cell keys as
their plain twins on the CPU) against the JAX reference on the worlds of
``query_worlds.py``:

- Kernel E's packed cell key against the reference's ``_pack``, bit for bit,
  wrapped negative coordinates included, and the proof that E's clamp of
  cell coordinates to +-2e9 changes no key these worlds emit;
- ``build_query_grid``: cell size, sorted keys, their colliders and the
  global colliders exactly;
- ``cast_ray_grid`` on 64 seeded rays through every_shape, the pile and
  the terrain (``solid`` both ways, a third with a short ``max_distance``,
  half unfiltered and half under a layer mask with an excluded set), R rays
  in one call and one ray alone, against the reference's
  ``cast_ray_grid``; and against the port's brute-force ``cast_ray``
  (Kernel T's twin; 16 of the terrain's rays): where every cell run fits
  the window, the grid's hit is the brute force's nearest;
- ``update_ray_casters`` on the pile: 16 casters attached to seeded bodies
  or in world space, one disabled, under a filter, against the reference's;
  half of them hollow (``solid`` False), where the reference drops the flag
  (ROADMAP 3b): the case shows its value and asserts the reference's
  ``cast_ray`` with ``solid=False`` from the same point;
- ``update_shape_casters`` on the pile: five sphere and box casters,
  attached and in world space, under a filter, against the reference's.

The casters cross from the reference with ``from_numpy``, as worlds do.
Indices and flags are compared exactly, distances, points and normals within
``TOL``. The reference is compiled one IEEE operation at a time
(``port_common.ieee_reference``), each function once for each world, in a
thread while the port runs.
"""

from port_common import ieee_reference

ieee_reference()

import dataclasses  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from avian_tpu import ShapeType  # noqa: E402
from avian_tpu import queries as jq  # noqa: E402
from avian_tpu.queries import accel as jaccel  # noqa: E402
from avian_tpu.queries.filter import QueryFilter as JFilter  # noqa: E402
from avian_tpu_torch import queries as tq  # noqa: E402
from avian_tpu_torch.kernels import collider_aabbs as ke  # noqa: E402
from avian_tpu_torch.kernels.grid_sweep import cell_key  # noqa: E402
from avian_tpu_torch.math import vec  # noqa: E402
from avian_tpu_torch.pipeline.broadphase import sweep_cell  # noqa: E402
from avian_tpu_torch.queries import raycast as traycast  # noqa: E402

from port_common import as_numpy  # noqa: E402
from query_worlds import SMALL, world  # noqa: E402

torch.set_num_threads(1)
TOL = 1e-5
RAYS, BRUTE_RAYS, CASTERS = 64, {"terrain": 16}, 16
NAMES = SMALL + ("pile", "terrain")
# The grid casts' worlds. The reference tests every lane of its 64 cells x 32
# entries with a hull's sphere-traced march wherever the pool holds one, so
# the queries and hulls worlds (sharing every_shape's pool) would cost some
# 10 s each and meet no shape every_shape and the terrain do not.
GRID_NAMES = ("every_shape", "pile", "terrain")
HALF = RAYS // 2  # the rays of each filter
_RAY_FIELDS = ("collider", "body", "hit", "distance", "point", "normal")
_SHAPE_FIELDS = ("collider", "body", "hit", "distance", "point_a", "point_b", "normal")


def _rays(name, seed):
    """Seeded rays through world ``name`` (origins f32[R, 3], directions,
    max distances, solid flags): from above toward points inside it (on the
    terrain three in four down through the pile onto the field, the rest
    level through it), an eighth starting inside a collider's AABB."""
    rng = np.random.default_rng(seed)
    jw, _ = world(name)
    col = jw.colliders
    lo, hi = np.asarray(col.aabb_min), np.asarray(col.aabb_max)
    finite = np.asarray(col.active) & ((hi - lo).max(1) < 1e3)
    lo_w, hi_w = lo[finite].min(0), hi[finite].max(0)
    target = rng.uniform(lo_w, hi_w, (RAYS, 3))
    o = target + rng.uniform(-6, 6, (RAYS, 3)) + [0.0, 6.0, 0.0]
    if name == "terrain":
        down = RAYS * 3 // 4
        o[:down, 1] = 15.0
        target[:down] = o[:down] - [0.0, 1.0, 0.0] + rng.uniform(-0.05, 0.05, (down, 3))
        o[down:] = np.stack([np.full(RAYS - down, lo_w[0] - 1.0),
                             rng.uniform(0.3, 3.0, RAYS - down),
                             rng.uniform(lo_w[2], hi_w[2], RAYS - down)], 1)
        target[down:] = o[down:] + [1.0, 0.0, 0.0] + rng.uniform(-0.05, 0.05, (RAYS - down, 3))
    inside = np.nonzero(finite)[0][rng.integers(0, finite.sum(), RAYS // 8)]
    o[:RAYS // 8] = (lo[inside] + hi[inside]) / 2.0
    d = target - o + [1e-3, 0.0, 0.0]
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    md = np.where(rng.random(RAYS) < 0.33, rng.uniform(0.5, 3.0, RAYS), 50.0)
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return f32(o), f32(d), f32(md), rng.random(RAYS) < 0.5


def _filters(m, seed):
    """(reference mask and excluded, port filter) pairs: none, and every
    layer but layer 1 with every fifth collider excluded."""
    excluded = np.zeros(m, bool)
    excluded[seed % 5::5] = True
    return ((np.uint32(0xFFFFFFFF), np.zeros(m, bool), tq.QueryFilter()),
            (np.uint32(0xFFFFFFFD), excluded,
             tq.QueryFilter(mask=0xFFFFFFFD, excluded=torch.from_numpy(excluded))))


# ---------------------------------------------------------------------------
# The reference: one compile of each function for each world shape
# ---------------------------------------------------------------------------


def _ref_grid_rays(w, grid, o, d, md, solid, mask, excluded):
    qf = JFilter(mask=mask, excluded=excluded)
    return jax.vmap(lambda a, b, c, s: jaccel.cast_ray_grid(w, grid, a, b, c, s, qf))(
        o, d, md, solid)


def _ref_casters(w, casters, grid, o, d, md, mask, excluded):
    """The reference's ``update_ray_casters``, and its ``cast_ray`` with
    ``solid=False`` from the rays ``o``, ``d``, ``md``."""
    qf = JFilter(mask=mask, excluded=excluded)
    return (jaccel.update_ray_casters(w, casters, grid, qf),
            jax.vmap(lambda a, b, c: jq.cast_ray(w, a, b, c, False, qf))(o, d, md))


def _ray_casters(seed):
    """``CASTERS`` ray casters on the pile: even ones attached to seeded
    bodies (near their centre, so that some start inside them), odd ones in
    world space from above; every second pair hollow; the last disabled
    (``enabled`` cleared after ``create``)."""
    rng = np.random.default_rng(seed)
    jw, _ = world("pile")
    bodies = rng.integers(1, int(np.asarray(jw.bodies.active).sum()), CASTERS)
    casters = []
    for k in range(CASTERS):
        d = rng.normal(size=3)
        d[1] = -abs(d[1]) - 0.5
        c = dict(direction=tuple(d), max_distance=float(rng.choice([2.0, 40.0])),
                 solid=bool(k % 4 < 2))
        if k % 2 == 0:
            c.update(body=int(bodies[k]), origin=tuple(rng.uniform(-0.2, 0.2, 3)))
        else:
            c.update(origin=(float(rng.uniform(-3, 3)), 8.0, float(rng.uniform(-3, 3))))
        casters.append(c)
    jc = jaccel.RayCasters.create(casters)
    return dataclasses.replace(jc, enabled=jc.enabled.at[-1].set(False))


def _shape_casters():
    """Five shape casters on the pile: two spheres and a box attached to
    bodies, a sphere and a box in world space."""
    sphere, box = int(ShapeType.SPHERE), int(ShapeType.BOX)
    return jaccel.ShapeCasters.create([
        dict(shape_type=sphere, params=(0.3,), body=1, origin=(0.0, 1.5, 0.0),
             direction=(0.0, -1.0, 0.0), max_distance=20.0),
        dict(shape_type=sphere, params=(0.2,), body=20, origin=(0.2, 2.0, 0.1),
             direction=(0.1, -1.0, 0.0), max_distance=20.0),
        dict(shape_type=box, params=(0.3, 0.2, 0.25), body=40, origin=(0.0, 2.0, 0.0),
             rotation=(0.0, 0.3826834, 0.0, 0.9238795), direction=(0.0, -1.0, 0.2),
             max_distance=20.0),
        dict(shape_type=sphere, params=(0.4,), origin=(0.1, 12.0, 0.0),
             direction=(0.0, -1.0, 0.0), max_distance=50.0),
        dict(shape_type=box, params=(0.5, 0.1, 0.5), origin=(1.0, 9.0, 0.2),
             direction=(0.0, -1.0, 0.0), max_distance=4.0)])


def _excluded_every_seventh(m):
    excluded = np.zeros(m, bool)
    excluded[3::7] = True
    return excluded


def _world_rays(jw, jc):
    """The casters' world-frame rays, as the reference's
    ``update_ray_casters`` makes them."""
    b = jw.bodies
    attached = jc.body >= 0
    bidx = jnp.maximum(jc.body, 0)
    from avian_tpu.math import quat as jquat

    bq = b.quat[bidx]
    o = jnp.where(attached[:, None], b.pos[bidx] + jquat.rotate(bq, jc.origin), jc.origin)
    d = jnp.where(attached[:, None], jquat.rotate(bq, jc.direction), jc.direction)
    return np.asarray(o), np.asarray(d)


_POOL = ThreadPoolExecutor(1)
_JOBS = {}


def _submit(kind, name):
    """Compile the reference's ``kind`` function for world ``name``'s shapes
    in the thread."""
    jw, _ = world(name)
    grid = jax.eval_shape(jaccel.build_query_grid, jw)
    m = jw.colliders.capacity
    mask, excluded, _ = _filters(m, 0)[0]
    if kind == "grid":
        o, d, md, solid = (x[:HALF] for x in _rays(name, 0))
        fn, args = _ref_grid_rays, (jw, grid, o, d, md, solid, mask, excluded)
    elif kind == "shape_casters":
        jc = _shape_casters()
        fn = lambda w, e: jaccel.update_shape_casters(w, jc, JFilter(excluded=e))  # noqa: E731
        args = (jw, _excluded_every_seventh(m))
    else:
        jc = _ray_casters(0)
        o, d = _world_rays(jw, jc)
        fn, args = _ref_casters, (jw, jc, grid, o, d, np.asarray(jc.max_distance), mask,
                                  excluded)
    _JOBS[(kind, name)] = _POOL.submit(lambda: jax.jit(fn).lower(*args).compile())


_JGRID = jax.jit(jaccel.build_query_grid)


def _ref(kind, name):
    fn = _JOBS[(kind, name)].result()
    return lambda *args: jax.tree.map(np.asarray, fn(*args))


for _kind, _name in (("grid", "every_shape"), ("grid", "pile"), ("casters", "pile"),
                     ("shape_casters", "pile"), ("grid", "terrain")):
    _submit(_kind, _name)


# ---------------------------------------------------------------------------
# Cases
# ---------------------------------------------------------------------------


def _hold(what, port, ref, fields, rows=slice(None)):
    """The port's hit fields against the reference's: discrete ones
    exactly, floating ones within ``TOL`` where the reference hit."""
    hit = np.asarray(ref.hit)[rows]
    for f in fields:
        p, r = as_numpy(getattr(port, f))[rows], np.asarray(getattr(ref, f))[rows]
        if np.issubdtype(r.dtype, np.floating):
            np.testing.assert_allclose(p[hit], r[hit], atol=TOL, rtol=0, err_msg=f"{what} {f}")
        else:
            np.testing.assert_array_equal(p, r, err_msg=f"{what} {f}")


def test_cell_key_is_the_reference_s_pack():
    """E's key packs 10 bits a coordinate exactly as ``accel._pack``, wrapped
    negative and large coordinates included."""
    c = np.concatenate([np.arange(-3000, 3000), [2**20, -2**20, 2**30 - 1, -2**31, 2**31 - 1,
                                                  2_000_000_000, -2_000_000_000]])
    cc = np.stack(np.meshgrid(c[::97], c[::89], c[::83], indexing="ij"), -1).reshape(-1, 3)
    cc = np.concatenate([cc, np.stack([c, c[::-1], np.roll(c, 7)], 1)]).astype(np.int32)
    np.testing.assert_array_equal(as_numpy(cell_key(torch.from_numpy(cc))),
                                  np.asarray(jaccel._pack(jnp.asarray(cc))))


@pytest.mark.parametrize("name", NAMES)
def test_query_grid_matches_reference(name):
    """The cell size, the sorted keys and their colliders, the global
    colliders; and no in-grid collider's cell coordinate near E's clamp."""
    jw, tw = world(name)
    got, want = tq.build_query_grid(tw), _JGRID(jw)
    for f in ("cell", "skey", "scol", "global_idx", "global_valid"):
        np.testing.assert_array_equal(as_numpy(getattr(got, f)), np.asarray(getattr(want, f)),
                                      err_msg=f)
    cell, in_grid, _ = sweep_cell(tw.colliders)
    for bound in (tw.colliders.aabb_min, tw.colliders.aabb_max):
        coords = torch.floor(bound[in_grid] / cell)
        assert float(coords.abs().max()) < ke._CELL_LIMIT / 1e6
    assert int((got.skey != np.iinfo(np.int32).max).sum()) >= int(in_grid.sum())


@pytest.mark.parametrize("name", GRID_NAMES)
def test_cast_ray_grid_matches_reference(name):
    """R rays in one call against the reference's grid caster, solid and
    hollow, half of them unfiltered and half filtered; one ray alone; the
    brute force's nearest where the window holds every run."""
    jw, tw = world(name)
    grid, jgrid = tq.build_query_grid(tw), _JGRID(jw)
    rays = _rays(name, len(name))
    run = _ref("grid", name)
    for k, (mask, excluded, qf) in enumerate(_filters(tw.colliders.capacity, len(name))):
        o, d, md, solid = (x[k * HALF:(k + 1) * HALF] for x in rays)
        got = tq.cast_ray_grid(tw, grid, o, d, torch.from_numpy(md), torch.from_numpy(solid), qf)
        ref = run(jw, jgrid, o, d, md, solid, mask, excluded)
        _hold(f"cast_ray_grid {name} {k}", got, ref, _RAY_FIELDS)
        assert int(np.asarray(ref.hit).sum()) >= HALF // 4
        one = tq.cast_ray_grid(tw, grid, tuple(o[3]), tuple(d[3]), float(md[3]), bool(solid[3]),
                               qf)
        for f in _RAY_FIELDS:
            np.testing.assert_array_equal(as_numpy(getattr(one, f)),
                                          as_numpy(getattr(got, f))[3], err_msg=f)
    runs = torch.unique_consecutive(grid.skey, return_counts=True)[1][:-1]
    assert int(runs.max()) <= 32
    o, d, md, _ = rays
    n = BRUTE_RAYS.get(name, RAYS)
    dn = vec.normalize_or_rn(torch.from_numpy(d[:n]), torch.tensor([1.0, 0.0, 0.0]))
    t, _ = traycast.all_hits(tw, torch.from_numpy(o[:n]), dn, True, tq.QueryFilter())
    t = torch.where(t <= torch.from_numpy(md[:n])[:, None], t, traycast.BIG)
    grid_hit = tq.cast_ray_grid(tw, grid, o[:n], d[:n], torch.from_numpy(md[:n]), True)
    nearest = t.min(1).values
    np.testing.assert_array_equal(as_numpy(grid_hit.hit), as_numpy(nearest < traycast.BIG))
    hit = as_numpy(grid_hit.hit)
    np.testing.assert_array_equal(as_numpy(grid_hit.distance)[hit], as_numpy(nearest)[hit])
    ci = as_numpy(grid_hit.collider)[hit].astype(np.int64)
    np.testing.assert_array_equal(as_numpy(t)[np.nonzero(hit)[0], ci], as_numpy(nearest)[hit])


def test_ray_casters_match_reference_and_honour_solid():
    """``update_ray_casters`` on the pile against the reference's, under a
    filter: solid casters exactly; hollow ones, where the reference reports
    its solid result (ROADMAP 3b), the reference's ``cast_ray`` with
    ``solid=False`` from the same point (the intent); the disabled one a
    miss."""
    jw, tw = world("pile")
    jc = _ray_casters(0)
    casters = tq.RayCasters.from_numpy(jax.tree.map(np.asarray, jc), device="cpu")
    assert casters.body.dtype == torch.int32 and not bool(casters.enabled[-1])
    o, d = _world_rays(jw, jc)
    mask, excluded, qf = _filters(tw.colliders.capacity, 3)[1]
    ref, hollow_ref = _ref("casters", "pile")(jw, jc, _JGRID(jw), o, d,
                                              np.asarray(jc.max_distance), mask, excluded)
    got = tq.update_ray_casters(tw, casters, qfilter=qf)
    solid = as_numpy(casters.solid)
    _hold("solid casters", got, ref, _RAY_FIELDS, solid)
    hollow = ~solid & as_numpy(casters.enabled)
    _hold("hollow casters", got, hollow_ref, _RAY_FIELDS, hollow)
    assert int(as_numpy(got.collider)[-1]) == -1 and np.isinf(as_numpy(got.distance)[-1])
    start_inside = hollow & (np.asarray(ref.distance) == 0.0)
    print("hollow casters starting inside a body: reference distances "
          f"{np.asarray(ref.distance)[start_inside]}, the port's "
          f"{as_numpy(got.distance)[start_inside]}")
    assert start_inside.any() and (as_numpy(got.distance)[start_inside] > 0.0).all()


def test_shape_casters_match_reference():
    """``update_shape_casters`` on the pile, under a filter: two spheres and
    a box attached to bodies, a sphere and a box in world space, against the
    reference's (compiled with the casters as constants)."""
    jw, tw = world("pile")
    jc = _shape_casters()
    casters = tq.ShapeCasters.from_numpy(jax.tree.map(np.asarray, jc), device="cpu")
    excluded = _excluded_every_seventh(tw.colliders.capacity)
    ref = _ref("shape_casters", "pile")(jw, excluded)
    got = tq.update_shape_casters(tw, casters, tq.QueryFilter(excluded=torch.from_numpy(excluded)))
    _hold("shape casters", got, ref, _SHAPE_FIELDS)
    assert ref.hit.sum() >= 4
