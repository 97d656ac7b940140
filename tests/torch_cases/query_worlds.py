"""The worlds of the 3D point, intersection and grid-query cases
(``cases_point_queries.py``, ``cases_query_grid.py``), built by the
reference's builder and held by both packages with the same stored AABBs
(the port's ``update_aabbs``, written into the reference's world too):

- ``queries``: ``tests/test_queries.py::_world`` (a half-space, a sphere, a
  box and a capsule on layer 1 alone);
- ``every_shape``: ``cases_queries.py::_every_shape`` (every shape a query
  meets, turned, on a half-space);
- ``hulls``: a unit octahedron hull at (0, 1, 0) and a cube hull of half
  extent 1 at (5, 1, 0);
- ``pile``: ``tests/test_accel.py``'s 64-cube pile;
- ``terrain``: ``terrain_shapes(300, per_row=12, field=17)`` after 20 steps
  of the port (``cases_queries.py::_terrain``).

The three small worlds share one capacity (``CAP``), one padded vertex pool
and one shape-pair hint, so that one compile of a reference function serves
them all; the padding changes no query (the pool's extra rows are zeros no
hull reaches, the hint only lists more pairs). This module holds no tests.
"""

import functools

import jax
import numpy as np

from avian_tpu import BodyType, SceneBuilder as JBuilder
from avian_tpu.geometry.convex import MAX_HULL_VERTS
from avian_tpu.scenes import cube_pile
from avian_tpu_torch import PhysicsConfig
from avian_tpu_torch.pipeline.broadphase import update_aabbs

from cases_queries import _every_shape, _terrain
from port_common import to_torch

CAP = 12  # bodies and colliders of the small worlds (every_shape's)
SMALL = ("queries", "every_shape", "hulls")
HULL_CENTRES = ((0.0, 1.0, 0.0), (5.0, 1.0, 0.0))


def queries_world(cap=CAP):
    """``tests/test_queries.py::_world`` with ``cap`` slots."""
    b = JBuilder()
    g = b.add_body(body_type=BodyType.STATIC)
    b.half_space(g, normal=(0, 1, 0))
    s = b.add_body(body_type=BodyType.STATIC, pos=(0, 2, 0))
    b.sphere(s, 0.5)
    bx = b.add_body(body_type=BodyType.STATIC, pos=(3, 1, 0))
    b.box(bx, 1.0, 1.0, 1.0)
    cp = b.add_body(body_type=BodyType.STATIC, pos=(-3, 1, 0))
    b.capsule(cp, 0.4, 1.2, layer_members=0b10, layer_filter=0b10)
    return b.finalize(max_bodies=cap, max_colliders=cap, max_contacts=16)


def hulls_world():
    """A unit octahedron hull and a cube hull of half extent 1."""
    b = JBuilder()
    octa = b.add_body(body_type=BodyType.STATIC, pos=HULL_CENTRES[0])
    b.convex_hull(octa, [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)])
    cube = b.add_body(body_type=BodyType.STATIC, pos=HULL_CENTRES[1])
    b.convex_hull(cube, [(sx, sy, sz) for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])
    return b.finalize(max_bodies=CAP, max_colliders=CAP, max_contacts=16)


def _pile():
    world, _ = cube_pile(n_cubes=64, max_contacts=512)
    return world


_BUILD = {"queries": queries_world, "every_shape": _every_shape, "hulls": hulls_world,
          "pile": _pile, "terrain": _terrain}


@functools.cache
def _small():
    """The small worlds with one padded pool and one shape-pair hint."""
    built = {name: _BUILD[name]() for name in SMALL}
    rows = max(w.convex_verts.shape[0] for w in built.values())
    pairs = tuple(sorted({tuple(map(int, p)) for w in built.values() for p in w.shape_pairs}))
    out = {}
    for name, w in built.items():
        pool = np.zeros((rows, 3), np.float32)
        pool[:w.convex_verts.shape[0]] = np.asarray(w.convex_verts)
        out[name] = w.replace(convex_verts=jax.numpy.asarray(pool), shape_pairs=pairs)
    assert rows > MAX_HULL_VERTS
    return out


@functools.cache
def world(name):
    """(reference world, port world) of ``name``, with this step's AABBs
    stored, built once."""
    jw = _small()[name] if name in SMALL else _BUILD[name]()
    tw = update_aabbs(to_torch(jw), PhysicsConfig(max_colors=4))
    col = tw.colliders
    jw = jw.replace(colliders=jw.colliders.replace(
        aabb_min=jax.numpy.asarray(col.aabb_min.numpy()),
        aabb_max=jax.numpy.asarray(col.aabb_max.numpy())))
    return jw, tw
