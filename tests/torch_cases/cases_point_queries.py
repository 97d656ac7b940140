"""The port's point projections, point, AABB and shape intersections and the
point predicate (``avian_tpu_torch.queries``; Kernels AF, AH and S's overlap
mode as their plain twins on the CPU) against the JAX reference on the
worlds of ``query_worlds.py``:

- every (point, collider) distance, closest point and inside flag of 64
  seeded points a world (a quarter at body centres, a quarter near them, the
  rest anywhere around the world);
- ``project_point`` (``solid`` both ways), ``point_intersections`` and
  ``project_point_predicate`` of the first 32 of them (16 on the pile and
  the terrain), unfiltered and under a layer mask with an excluded set;
- ``aabb_intersections`` of 8 seeded boxes;
- ``closest_point_on_hull`` bit for bit against the reference's on every
  hull of every_shape and the terrain (the mean start's 32-row sum in the
  reference's order);
- ``shape_intersections`` of 16 seeded spheres on the small worlds (every
  shape pair a sphere has: the analytic, support-map and hull instances of
  S) and of 16 boxes on the pile: every collider's overlap flag, and the
  list;
- the reference's two faults on this path (ROADMAP 3b): a point inside a
  plain hull reported outside, and intersections that raise where
  ``max_hits`` exceeds the collider slots. Each case shows the reference's
  value and asserts the intended one; the other cases hold every pair the
  first fault leaves alone to the reference, and the rest to that intent.

Indices and flags are compared exactly, distances and points within ``TOL``.
The reference is compiled one IEEE operation at a time
(``port_common.ieee_reference``), each function once for the small worlds
(one capacity) and once for each large world, in a thread while the port
runs. The terrain's shape intersections are left to the card's smoke run:
its support-map pairs would compile for some 20 s more.
"""

from port_common import ieee_reference

ieee_reference()

import functools  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from avian_tpu import ShapeType  # noqa: E402
from avian_tpu import queries as jq  # noqa: E402
from avian_tpu.math import quat as jquat  # noqa: E402
from avian_tpu.pipeline.broadphase import update_collider_poses  # noqa: E402
from avian_tpu.queries import point as jpoint  # noqa: E402
from avian_tpu.queries.filter import QueryFilter as JFilter  # noqa: E402
from avian_tpu_torch import queries as tq  # noqa: E402
from avian_tpu_torch.geometry import convex  # noqa: E402
from avian_tpu_torch.math import quat as tquat  # noqa: E402
from avian_tpu_torch.pipeline.broadphase import collider_poses  # noqa: E402
from avian_tpu_torch.queries import intersect as tintersect  # noqa: E402
from avian_tpu_torch.queries.filter import collider_query_mask  # noqa: E402
from avian_tpu_torch.queries import point as tpoint  # noqa: E402

from port_common import as_numpy, quats  # noqa: E402
from query_worlds import HULL_CENTRES, SMALL, queries_world, world  # noqa: E402

torch.set_num_threads(1)
TOL = 1e-5
BIG = 1e30
POINTS, BOXES, SHAPES, HITS = 64, 8, 16, 8
CALLS = {"pile": 16, "terrain": 16}  # the points of the per-point calls (else 32)
SHAPE_QUERIES = {**dict.fromkeys(SMALL, (int(ShapeType.SPHERE), 1)),
                 "pile": (int(ShapeType.BOX), 3)}
NAMES = SMALL + ("pile", "terrain")
# The sphere's pair hint on the small worlds: its analytic pairs and the hull's
# (the support-map pairs of cylinders, cones and segments, which the shape
# casts' cases hold, would compile for some 12 s more); both packages take it.
SHAPE_PAIRS = {int(ShapeType.SPHERE): ((0, 0), (0, 1), (0, 2), (0, 3), (0, 8))}
HULL_MARGIN = 1e-4  # points this near a hull's face (of its size) are not held to qhull


def _no_box(w, ids):
    return w.colliders.shape_type[ids] != int(ShapeType.BOX)


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def _inputs(name, seed):
    """Seeded points, boxes, query shapes' params, poses and an exclusion
    mask for world ``name``."""
    rng = np.random.default_rng(seed)
    jw, _ = world(name)
    b = jw.bodies
    centres = np.asarray(b.pos)[np.asarray(b.active)]
    lo = np.asarray(jw.colliders.aabb_min)[np.asarray(jw.colliders.active)]
    hi = np.asarray(jw.colliders.aabb_max)[np.asarray(jw.colliders.active)]
    finite = (hi - lo).max(1) < 1e3
    lo, hi = lo[finite].min(0) - 1.0, hi[finite].max(0) + 1.0
    q = POINTS // 4
    pts = np.concatenate([
        centres[np.arange(q) % len(centres)],
        centres[rng.integers(0, len(centres), q)] + rng.normal(0.0, 0.3, (q, 3)),
        rng.uniform(lo, hi, (POINTS - 2 * q, 3))])
    box_lo = rng.uniform(lo, hi, (BOXES, 3))
    shape_pos = centres[rng.integers(0, len(centres), SHAPES)] + rng.normal(0.0, 0.5, (SHAPES, 3))
    _, width = SHAPE_QUERIES.get(name, (0, 1))
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return dict(points=f32(pts), box_lo=f32(box_lo),
                box_hi=f32(box_lo + rng.uniform(0.2, 3.0, (BOXES, 3))),
                shape_prm=f32(rng.uniform(0.2, 0.8, (SHAPES, width))), shape_pos=f32(shape_pos),
                shape_quat=quats(rng, SHAPES), excluded=rng.random(jw.colliders.capacity) < 0.2)


def _filters(x):
    """(reference mask and excluded, port filter) pairs: none, and every
    layer but layer 1 with ``x``'s excluded colliders."""
    m = x["excluded"].shape[0]
    return ((np.uint32(0xFFFFFFFF), np.zeros(m, bool), tq.QueryFilter()),
            (np.uint32(0xFFFFFFFD), x["excluded"],
             tq.QueryFilter(mask=0xFFFFFFFD, excluded=torch.from_numpy(x["excluded"]))))


# ---------------------------------------------------------------------------
# The reference: one compile of each function for each world shape
# ---------------------------------------------------------------------------


def _ref_points(w, pts, lo, hi, mask, excluded):
    """Every (point, collider) closest point and distance, and the point and
    AABB queries of every point and box, under the filter (mask, excluded)."""
    qf = JFilter(mask=mask, excluded=excluded)
    col = w.colliders
    pos, quat = update_collider_poses(w)
    pool = w.convex_verts if w.convex_verts.shape[0] > 1 else None

    def pair(x, p, q, st, prm):
        c, d = jpoint._closest_local(jquat.rotate_inv(q, x - p), st, prm, pool)
        return p + jquat.rotate(q, c), d

    closest, dist = jax.vmap(lambda x: jax.vmap(functools.partial(pair, x))(
        pos, quat, col.shape_type, col.params))(pts)
    out = {"closest": closest, "dist": dist}
    for solid in (True, False):
        out[f"project {solid}"] = jax.vmap(lambda x: jq.project_point(w, x, solid, qf))(pts)
    out["intersections"] = jax.vmap(lambda x: jq.point_intersections(w, x, HITS, qf))(pts)
    out["predicate"] = jax.vmap(
        lambda x: jq.project_point_predicate(w, x, _no_box, True, qf))(pts)
    out["aabb"] = jax.vmap(lambda a, b: jq.aabb_intersections(w, a, b, HITS, qf))(lo, hi)
    return out


def _ref_shapes(w, prm, spos, squat, mask, excluded, st):
    """Every query shape's full list of intersected colliders (``max_hits``
    = the slots), and its first ``HITS``."""
    qf = JFilter(mask=mask, excluded=excluded)
    m = w.colliders.capacity

    def one(r, p, q, k):
        return jq.shape_intersections(w, st, r, p, q, k, qf, SHAPE_PAIRS.get(st))

    return (jax.vmap(lambda r, p, q: one(r, p, q, m))(prm, spos, squat),
            jax.vmap(lambda r, p, q: one(r, p, q, HITS))(prm, spos, squat))


_POOL = ThreadPoolExecutor(1)
_JOBS = {}


def _submit(kind, name):
    """Compile the reference's ``kind`` function for world ``name``'s shapes
    in the thread (the small worlds share one compile)."""
    jw, _ = world(name)
    x = _inputs(name, 0)
    if kind == "points":
        fn, args = _ref_points, (jw, x["points"], x["box_lo"], x["box_hi"], np.uint32(0),
                                 x["excluded"])
    else:
        fn = functools.partial(_ref_shapes, st=SHAPE_QUERIES[name][0])
        args = (jw, x["shape_prm"], x["shape_pos"], x["shape_quat"], np.uint32(0), x["excluded"])
    _JOBS[(kind, name)] = _POOL.submit(lambda: jax.jit(fn).lower(*args).compile())


def _ref(kind, name):
    fn = _JOBS[(kind, SMALL[0] if name in SMALL else name)].result()
    return lambda *args: jax.tree.map(np.asarray, fn(*args))


# Start compiling as the module loads, the small worlds' functions first, while
# the large worlds are built.
for _kind, _name in (("points", SMALL[0]), ("shapes", SMALL[0]), ("points", "pile"),
                     ("shapes", "pile"), ("points", "terrain")):
    _submit(_kind, _name)


# ---------------------------------------------------------------------------
# The port, and the intent where the reference's first fault lies
# ---------------------------------------------------------------------------


def _inner_pairs(tw, pts):
    """bool[P, M]: the (point, collider) pairs whose point lies inside the
    collider's inner hull, by the port's exact test (``hull_contains``): the
    pairs of the reference's first fault."""
    col = tw.colliders
    pos, quat = collider_poses(tw)
    out = torch.zeros((pts.shape[0], col.capacity), dtype=torch.bool)
    hulls = torch.nonzero(tpoint.point_kinds(tw) == tpoint.kaf.CONVEX)[:, 0].tolist()
    for c in hulls:
        p = tquat.rotate_inv(quat[c].expand(pts.shape[0], 4), pts - pos[c])
        h = convex.hull_windows(col.params[c, :7].expand(pts.shape[0], 7), tw.convex_verts)
        out[:, c] = convex.hull_contains(h, p, convex.closest_point_on_hull(h, p))
    return out.numpy()


def _qhull_inside(tw, pts):
    """(inside, clear) bool[P, M]: which points lie inside each collider's
    inner hull by scipy's qhull (``ConvexHull.equations``, in float64), and
    which lie farther than ``HULL_MARGIN`` x its size from its faces; flat
    hulls hold none."""
    from scipy.spatial import ConvexHull, QhullError

    col = tw.colliders
    pos, quat = (as_numpy(v).astype(np.float64) for v in collider_poses(tw))
    pool = as_numpy(tw.convex_verts).astype(np.float64)
    inside = np.zeros((pts.shape[0], col.capacity), bool)
    clear = np.ones_like(inside)
    for c in torch.nonzero(tpoint.point_kinds(tw) == tpoint.kaf.CONVEX)[:, 0].tolist():
        off, cnt = (int(v) for v in as_numpy(col.params[c, :2]))
        prm = as_numpy(col.params[c])
        try:
            eq = ConvexHull(pool[off:off + cnt]).equations
        except QhullError:
            continue  # a flat hull (a triangle) holds no point
        u, w = quat[c, :3], quat[c, 3]
        v = pts - pos[c]
        t = 2.0 * np.cross(-u, v)
        local = v + w * t + np.cross(-u, t)
        s = (local @ eq[:, :3].T + eq[:, 3]).max(1)
        inside[:, c] = s < 0.0
        clear[:, c] = np.abs(s) > HULL_MARGIN * max(prm[2:5].max(), 1e-3)
    return inside, clear


def _expected_project(dist, closest, inside, ok, pts, solid, body_idx):
    """``project_point``'s fields from one point's per-collider results
    (the reference's rule, first index on ties)."""
    key = np.where(ok, np.where(inside & solid, 0.0, np.abs(dist)), BIG).astype(np.float32)
    i = int(np.argmin(key))
    hit = bool(key[i] < BIG)
    return {"collider": i if hit else -1, "body": int(body_idx[i]) if hit else -1,
            "point": pts if (inside[i] and solid) else closest[i],
            "is_inside": bool(inside[i] and hit), "distance": dist[i] if hit else np.inf,
            "hit": hit}


def _hold_fields(what, port, ref, rows):
    """Each field of the port's stacked results against the reference's on
    ``rows``: discrete ones exactly, floating ones within ``TOL``."""
    for key, r in ref.items():
        p, r = as_numpy(port[key])[rows], np.asarray(r)[rows]
        if np.issubdtype(r.dtype, np.floating):
            np.testing.assert_allclose(p, r, atol=TOL, rtol=0, err_msg=f"{what} {key}")
        else:
            np.testing.assert_array_equal(p, r, err_msg=f"{what} {key}")


def _stack(results):
    return {k: torch.stack([torch.as_tensor(r[k]) for r in results]) for k in results[0]}


@pytest.mark.parametrize("name", NAMES)
def test_point_queries_match_reference(name):
    """Every (point, collider) result, then the per-point queries and the
    AABB intersections, unfiltered and filtered."""
    jw, tw = world(name)
    x = _inputs(name, len(name))
    pts = x["points"]
    n_calls = CALLS.get(name, POINTS // 2)
    inner = _inner_pairs(tw, torch.from_numpy(pts))
    qhull, clear = _qhull_inside(tw, pts)
    np.testing.assert_array_equal(inner[clear], qhull[clear])
    assert clear.mean() > 0.99
    dist, closest, inside = (as_numpy(v) for v in tpoint.all_point_hits(tw, pts))
    rr = as_numpy(tw.colliders.params[:, 6])
    run = _ref("points", name)
    for mask, excluded, qf in _filters(x):
        ref = run(jw, pts, x["box_lo"], x["box_hi"], mask, excluded)
        # Every pair: the reference's, but inside an inner hull (fault 1).
        plain = ~inner
        np.testing.assert_allclose(dist[plain], ref["dist"][plain], atol=TOL, rtol=0)
        np.testing.assert_allclose(closest[plain], ref["closest"][plain], atol=TOL, rtol=0)
        np.testing.assert_array_equal(inside[plain], ref["dist"][plain] < 0.0)
        cols = np.nonzero(inner)[1]
        np.testing.assert_array_equal(dist[inner], -rr[cols])
        np.testing.assert_allclose(closest[inner], pts[np.nonzero(inner)[0]], atol=TOL, rtol=0)
        assert inside[inner].all()
        # The per-point queries: the reference's where no inner hull holds the
        # point, else the reference's rule on the port's pairs.
        ok = as_numpy(collider_query_mask(tw.colliders, qf))
        plain_pts = np.nonzero(~inner[:n_calls].any(1))[0]
        body = as_numpy(tw.colliders.body_idx)
        for solid in (True, False):
            got = _stack([tq.project_point(tw, p, solid, qf) for p in pts[:n_calls]])
            _hold_fields(f"project_point solid={solid}", got, ref[f"project {solid}"], plain_pts)
            for i in np.nonzero(inner[:n_calls].any(1))[0]:
                want = _expected_project(dist[i], closest[i], inside[i], ok, pts[i], solid, body)
                _hold_fields(f"project_point solid={solid} inside a hull",
                             {k: v[i:i + 1] for k, v in got.items()},
                             {k: np.asarray([v]) for k, v in want.items()}, slice(None))
        hits = torch.stack([tq.point_intersections(tw, p, HITS, qf) for p in pts[:n_calls]])
        np.testing.assert_array_equal(as_numpy(hits)[plain_pts],
                                      ref["intersections"][plain_pts])
        contains = ok & (inside[:n_calls] | (dist[:n_calls] <= 0.0))
        np.testing.assert_array_equal(as_numpy(hits), as_numpy(tpoint.first_true(
            torch.from_numpy(contains), HITS)))
        pred = _stack([tq.project_point_predicate(tw, p, _no_box, True, qf)
                       for p in pts[:n_calls]])
        _hold_fields("project_point_predicate", pred, ref["predicate"], plain_pts)
        boxes = torch.stack([tq.aabb_intersections(tw, a, b, HITS, qf)
                             for a, b in zip(x["box_lo"], x["box_hi"])])
        np.testing.assert_array_equal(as_numpy(boxes), ref["aabb"])
        assert (ref["aabb"] >= 0).any()
    if name != "pile":
        assert inside.any()


@pytest.mark.parametrize("name", SMALL + ("pile",))
def test_shape_intersections_match_reference(name):
    """Every collider's overlap flag of each query shape (S's overlap mode),
    and the first ``HITS``, unfiltered and filtered."""
    jw, tw = world(name)
    x = _inputs(name, 100 + len(name))
    st, _ = SHAPE_QUERIES[name]
    run = _ref("shapes", name)
    m = tw.colliders.capacity
    for mask, excluded, qf in _filters(x):
        full, first = run(jw, x["shape_prm"], x["shape_pos"], x["shape_quat"], mask, excluded)
        want = np.zeros((SHAPES, m + 1), bool)
        want[np.arange(SHAPES)[:, None], np.where(full >= 0, full, m)] = True
        got = [tintersect.shape_overlaps(tw, st, tuple(map(float, r)), tuple(map(float, p)),
                                         tuple(map(float, q)), qf, SHAPE_PAIRS.get(st))
               for r, p, q in zip(x["shape_prm"], x["shape_pos"], x["shape_quat"])]
        np.testing.assert_array_equal(as_numpy(torch.stack(got)), want[:, :m])
        lists = torch.stack([tq.shape_intersections(tw, st, tuple(map(float, r)),
                                                    tuple(map(float, p)), tuple(map(float, q)),
                                                    HITS, qf, SHAPE_PAIRS.get(st))
                             for r, p, q in zip(x["shape_prm"], x["shape_pos"],
                                                x["shape_quat"])])
        np.testing.assert_array_equal(as_numpy(lists), first)
        assert want[:, :m].any()


@pytest.mark.parametrize("name", ("every_shape", "terrain"))
def test_frank_wolfe_point_is_the_reference_s(name):
    """``closest_point_on_hull`` (16 steps from the mean of the window's 32
    rows, summed from row 0 upward) bit for bit against the reference's, on
    every hull of the world (the small worlds share one pool) at 8 seeded
    local points each, inside and outside."""
    from avian_tpu.geometry import convex as jconvex

    jw, tw = world(name)
    rng = np.random.default_rng(9)
    prm = tw.colliders.params[tpoint.point_kinds(tw) == tpoint.kaf.CONVEX].repeat(8, 1)
    prm = prm.reshape(-1, 8)
    p = torch.from_numpy(rng.normal(0.0, 0.6, (prm.shape[0], 3)).astype(np.float32))
    got = convex.closest_point_on_hull(convex.hull_windows(prm[:, :7], tw.convex_verts), p)
    want = jax.jit(jax.vmap(lambda r, x: jconvex.closest_point_on_hull(r, x, jw.convex_verts)))(
        prm.numpy(), p.numpy())
    np.testing.assert_array_equal(as_numpy(got).view(np.uint32),
                                  np.asarray(want).view(np.uint32))
    assert prm.shape[0] >= 16


def test_fault_1_points_inside_a_plain_hull():
    """ROADMAP 3b: the reference's 16 Frank-Wolfe steps only creep toward a
    point inside a hull, so it reports the point outside (``is_inside``
    False, a small positive distance) and ``point_intersections`` lists
    neither hull. The port's exact test finds all 40 inside: distance -0 (the
    radius), the point itself, listed by ``point_intersections``; its inside
    flags equal the hulls' own inequalities on every point."""
    jw, tw = world("hulls")
    rng = np.random.default_rng(5)
    pts = np.concatenate([np.asarray(c, np.float32) + rng.uniform(-0.3, 0.3, (20, 3))
                          for c in HULL_CENTRES]).astype(np.float32)
    x = _inputs("hulls", 0)
    padded = np.concatenate([pts, np.zeros((POINTS - pts.shape[0], 3), np.float32)])
    mask, excluded, _ = _filters(x)[0]
    ref = _ref("points", "hulls")(jw, padded, x["box_lo"], x["box_hi"], mask, excluded)
    ref_inside = ref["project True"]["is_inside"][:40]
    ref_dist = ref["project True"]["distance"][:40]
    ref_lists = ref["intersections"][:40]
    print(f"reference: {int(ref_inside.sum())} of 40 inside, distances {ref_dist.min():.3g} to "
          f"{ref_dist.max():.3g}, {int((ref_lists >= 0).sum())} listed")
    for k, p in enumerate(pts):
        got = tq.project_point(tw, p)
        assert int(got["collider"]) == k // 20 and bool(got["is_inside"]), (k, got)
        assert float(got["distance"]) == 0.0 and np.signbit(float(got["distance"]))
        np.testing.assert_allclose(as_numpy(got["point"]), p, atol=TOL, rtol=0)
        assert as_numpy(tq.point_intersections(tw, p)).tolist() == [k // 20] + [-1] * 7
    local = [pts[:20] - HULL_CENTRES[0], pts[20:] - HULL_CENTRES[1]]
    _, _, inside = tpoint.all_point_hits(tw, pts)
    np.testing.assert_array_equal(as_numpy(inside[:20, 0]), np.abs(local[0]).sum(1) < 1.0)
    np.testing.assert_array_equal(as_numpy(inside[20:, 1]), np.abs(local[1]).max(1) < 1.0)
    # Around the hulls, out to twice their size: the same inequalities.
    far = rng.uniform(-2.0, 2.0, (200, 3)).astype(np.float32)
    margin = np.abs(np.abs(far).sum(1) - 1.0) > 1e-3
    _, _, inside = tpoint.all_point_hits(tw, far + np.asarray(HULL_CENTRES[0], np.float32))
    np.testing.assert_array_equal(as_numpy(inside[margin, 0]), np.abs(far[margin]).sum(1) < 1.0)
    assert not ref_inside.any()


def test_fault_2_intersections_past_the_slots():
    """ROADMAP 3b: on a world of 4 collider slots the reference's
    ``aabb_intersections`` and ``shape_intersections`` raise at the default
    ``max_hits=8`` (``lax.top_k`` with k > 4); the port pads their lists with
    -1, as the reference's ``point_intersections`` does, and otherwise lists
    what the reference lists at ``max_hits=4``."""
    from avian_tpu import PhysicsConfig
    from avian_tpu.pipeline.broadphase import update_aabbs
    from port_common import to_torch

    jw = update_aabbs(queries_world(cap=4), PhysicsConfig(max_colors=4))
    tw = to_torch(jw)
    sphere = (int(ShapeType.SPHERE), (1.0,), (0.0, 2.4, 0.0), (0.0, 0.0, 0.0, 1.0))
    box = ((2.0, 0.2, -1.0), (4.0, 2.0, 1.0))
    for fn in (lambda w: jq.aabb_intersections(w, *box), lambda w: jq.shape_intersections(w, *sphere)):
        with pytest.raises(Exception, match="top_k"):
            jax.jit(fn).lower(jw)  # raises while traced
    want_box, want_shape = (np.asarray(v).tolist() + [-1] * 4 for v in jax.jit(lambda w: (
        jq.aabb_intersections(w, *box, max_hits=4),
        jq.shape_intersections(w, *sphere, max_hits=4)))(jw))
    assert as_numpy(tq.aabb_intersections(tw, *box)).tolist() == want_box == [0, 2] + [-1] * 6
    assert as_numpy(tq.shape_intersections(tw, *sphere)).tolist() == want_shape
    assert want_shape[0] == 1
