"""Shape casts against the JAX reference (Kernel S's plain version on the
CPU), through the worlds of ``cases_queries.py``: seeded casts of a sphere
through ``tests/test_queries.py``'s world, its walls and the 300-body
terrain after 20 steps (with a ``shape_pairs`` hint that leaves out its
cylinders and cones, in both packages), of a box through the walls, of a
hull (a query shape that indexes the world's vertex pool through its
params) onto ``tests/test_queries.py``'s octahedron, and
``tests/test_queries.py``'s three shape-cast checks on the port. Each cast
is ``cast_shape``, every other one ``shape_hits(max_hits=4)`` as well, with
the world's layer mask and excluded set on every third: collider indices
and hit flags exactly, distances, points and normals within
``cases_queries.TOL``. The other support-map pairs' casts (capsules, cylinders,
cones) are ``cases_support_casts.py``'s. The reference's casts are read from
``shape_casts_reference.npz`` (``port_common.Recording``, keyed by a digest
of its inputs; rerecord with ``record_references.py cases_shape_casts.py
cases_support_casts.py``), except the sphere's through the walls, which run
it live and hold it to the recording."""

from port_common import ieee_reference

ieee_reference()

from functools import partial  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from avian_tpu import ShapeType  # noqa: E402
from avian_tpu import queries as jq  # noqa: E402
from avian_tpu.queries import shapecast as jshapecast  # noqa: E402
from avian_tpu_torch import queries as tq  # noqa: E402

from cases_queries import N_CASTS, _SHAPE_FIELDS, _filters, _same_hit, _unit, world  # noqa: E402
from port_common import Recording, as_numpy  # noqa: E402

RECORDING = Recording("shape_casts")


@partial(jax.jit, static_argnums=(1, 6, 8, 9))
def _j_cast(jw, shape_type, params, origin, rotation, direction, max_distance, qf, max_hits,
            shape_pairs):
    one = jshapecast.cast_shape(jw, shape_type, params, origin, rotation, direction,
                                max_distance, qf, shape_pairs)
    many = jshapecast.shape_hits(jw, shape_type, params, origin, rotation, direction,
                                 max_distance, max_hits, qf, shape_pairs)
    return one, many


# Where casts start: x centre, half width and height above the world.
_CAST_FROM = {"hull": (0.0, 0.8, 3.0), "terrain": (0.0, 6.0, 12.0), "walls": (5.0, 3.5, 4.0),
              "queries": (0.0, 3.5, 4.0)}


def casts(name, n, seed):
    """``n`` seeded casts through world ``name``: origins above it, turned
    shapes, directions mostly down."""
    rng = np.random.default_rng(seed)
    cx, reach, height = _CAST_FROM[name]
    o = np.stack([cx + rng.uniform(-reach, reach, n), rng.uniform(height, height + 2.0, n),
                  rng.uniform(-reach, reach, n)], 1)
    d = _unit(np.stack([rng.uniform(-0.3, 0.3, n), -np.ones(n), rng.uniform(-0.3, 0.3, n)], 1))
    q = rng.normal(size=(n, 4))
    return o.astype(np.float32), _unit(q), d


def check_casts(name, shape_type, params, n, seed, shape_pairs=None, max_distance=20.0,
                live=False, recording=RECORDING):
    """``n`` casts of the shape through world ``name`` by both packages:
    ``cast_shape`` on each, ``shape_hits(max_hits=4)`` on every other one
    (the port sweeps the scene once for each), each with the world's
    filters on every third cast; the reference's from ``recording``, or run
    ``live`` and held to it. Returns how many casts hit."""
    jw, tw = world(name)
    o, q, d = casts(name, n, seed)
    prm = tuple(float(x) for x in params)
    hits = 0
    for k in range(n):
        # Without a filter the reference gets an all-False excluded set of
        # the same shape, so that one compile serves every cast.
        (mask, excl), qf = _filters(name, k) if k % 3 == 2 else (
            (jnp.asarray(0xFFFFFFFF, jnp.uint32), jnp.zeros(jw.colliders.capacity, bool)),
            tq.QueryFilter())
        args = (tuple(map(float, o[k])), tuple(map(float, q[k])), tuple(map(float, d[k])))
        ref_args = (jw, int(shape_type), jnp.asarray(prm), *args, max_distance,
                    jq.QueryFilter(mask=mask, excluded=excl), 4, shape_pairs)
        want_one, want_many = recording((ref_args[0], repr(ref_args[1:])),
                                        lambda: _j_cast(*ref_args), live=live)
        got_one = tq.cast_shape(tw, int(shape_type), prm, *args, max_distance, qfilter=qf,
                                shape_pairs=shape_pairs)
        _same_hit(got_one, want_one, _SHAPE_FIELDS)
        if k % 2 == 0:
            got_many = tq.shape_hits(tw, int(shape_type), prm, *args, max_distance, max_hits=4,
                                     qfilter=qf, shape_pairs=shape_pairs)
            _same_hit(got_many, want_many, _SHAPE_FIELDS)
        hits += int(np.asarray(want_one.hit))
    return hits


# The sphere against the terrain's triangles, spheres, boxes and capsules;
# its cylinders and cones are left out by the hint in both packages, which
# keeps the reference's compile short.
_TERRAIN_CAST_PAIRS = ((0, 0), (0, 1), (0, 2), (0, 8))


@pytest.mark.parametrize("name", ["queries", "terrain", "walls"])
def test_sphere_casts_match_reference(name):
    pairs = _TERRAIN_CAST_PAIRS if name == "terrain" else None
    n = 2 if name == "terrain" else N_CASTS
    assert check_casts(name, ShapeType.SPHERE, (0.3,), n, seed=len(name),
                       shape_pairs=pairs, live=name == "walls") >= 1


def test_box_casts_match_reference():
    assert check_casts("walls", ShapeType.BOX, (0.3, 0.2, 0.4), N_CASTS, seed=11) >= 2


def test_hull_casts_match_reference():
    """The query is the world's own octahedron (its params point at its rows
    of the pool), cast onto it from above."""
    params = as_numpy(world("hull")[1].colliders.params[0, :7])
    assert check_casts("hull", ShapeType.CONVEX, params, 4, seed=24) >= 1


def test_the_reference_s_shape_cast_checks():
    """tests/test_queries.py's three shape-cast checks on the port."""
    _, tw = world("queries")
    hit = tq.cast_shape(tw, ShapeType.SPHERE, (0.5,), (10, 5, 0), (0, 0, 0, 1), (0, -1, 0), 10.0)
    assert bool(hit.hit) and int(hit.collider) == 0
    assert abs(float(hit.distance) - 4.5) < 5e-3
    np.testing.assert_allclose(as_numpy(hit.normal), [0, 1, 0], atol=1e-3)
    _, tw = world("walls")
    hits = tq.shape_hits(tw, ShapeType.SPHERE, (0.4,), (-2.0, 0.0, 0.0), (0.0, 0.0, 0.0, 1.0),
                         (1.0, 0.0, 0.0), 20.0, max_hits=3)
    d = as_numpy(hits.distance)
    assert bool(hits.hit.all()) and as_numpy(hits.collider).tolist() == [0, 1, 2]
    assert abs(d[0] - 3.1) < 0.05 and abs(d[1] - 6.1) < 0.05 and abs(d[2] - 9.1) < 0.05
    _, tw = world("hull")
    sh = tq.cast_shape(tw, ShapeType.SPHERE, (0.25,), (5.0, 1.0, 0.0), (0.0, 0.0, 0.0, 1.0),
                       (-1.0, 0.0, 0.0), max_distance=10.0)
    assert bool(sh.hit) and abs(float(sh.distance) - 3.75) < 0.1


