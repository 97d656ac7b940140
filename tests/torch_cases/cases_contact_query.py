"""The port's standalone pair queries (``avian_tpu_torch.contact_query``:
``contact_manifolds``, ``contact``, ``closest_points``, ``distance``,
``intersection_test`` and ``time_of_impact``, Kernel AI's plain version on
the CPU) against ``avian_tpu.geometry.contact_query``, vmapped and compiled
one IEEE operation at a time (``port_common.ieee_reference``).

The batches: for every canonical shape pair the port supports and the
half-space pair that none evaluates, ``K`` seeded pairs, the first half in
canonical order and the second half swapped, at gaps from overlapping to 1.6
times their reach, moving toward each other with some drift at 0.5-4 m/s for
up to ``max_t`` 0.3-1 s; their CONVEX shapes (hulls, box hulls round or
not, octahedra) index one vertex pool a batch. Flat triangles, the
heightfield's and the mesh's, have batches of their own, where each shape
(a half-space: below) comes straight down onto the face of a level triangle
larger than itself: the
port applies the reference's flat rule only to a shape in front of the
triangle (ROADMAP 3b), so a seeded shape behind one would show that
deliberate difference and not the queries. Booleans, counts, feature-id
sets and hit flags exactly; points, normals, separations, distances,
penetrations and times of impact within ``TOL``.

The reference takes some 20 s to compile the manifold and the 16-round loop
of one support-map pair, and these batches hold 34 such pairs, so its
outputs are recorded in ``contact_query_reference.npz`` by
``record_contact_query.py`` (which also checks a recording against a fresh
run of the reference, ``--check``); each case first checks that its seeded
inputs are the recorded ones. The analytic batches are compiled here as
well and must equal the recording bit for bit. Then
``tests/test_contact_query.py``'s two cases; a pair touching at t = 0 and a
pair moving apart, against the live reference; and the batched call against
the one-pair calls."""

from port_common import ieee_reference

ieee_reference()

import functools  # noqa: E402
import hashlib  # noqa: E402
import os  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from avian_tpu.geometry import contact_query as jcq  # noqa: E402
from avian_tpu_torch import contact_query as tcq  # noqa: E402
from avian_tpu_torch.geometry.narrowphase import SUPPORTED_PAIRS  # noqa: E402

from cases_hull_manifold import CONVEX, PLANE, _Pool, _params, _reach  # noqa: E402
from port_common import as_numpy, assert_manifolds_equal, quats, rotate_np  # noqa: E402

TOL = 1e-6
K = 12  # pairs of each batch, half of them swapped
NOT_FLAT = (0, 1, 3)  # cases_hull_manifold's CONVEX kinds but the flat triangle
TRIANGLE_PAIRS = tuple(p for p in SUPPORTED_PAIRS if p[1] == CONVEX)
# (name, canonical pair, on a level triangle)
BATCHES = tuple((f"{a}-{b}", (a, b), False) for a, b in SUPPORTED_PAIRS + ((PLANE, PLANE),)) + \
    tuple((f"{a}-{b}-triangle", (a, b), True) for a, b in TRIANGLE_PAIRS)
ANALYTIC = ("0-0", "0-1", "0-2", "0-3", "1-1", "1-3", "2-2", "2-3", "3-3")
RECORDING = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "contact_query_reference.npz")
OUTPUTS = ("m_normal", "m_point_a", "m_point_b", "m_separation", "m_feature_id", "m_count",
           "c_found", "c_point_a", "c_point_b", "c_normal", "c_penetration", "cp_intersecting",
           "cp_point_a", "cp_point_b", "distance", "intersecting", "toi_hit", "toi_t")
I = (0.0, 0.0, 0.0, 1.0)
_UP = np.asarray([0.0, 1.0, 0.0], np.float32)


def _swap_half(a, b, max_t):
    """(a, b) per pair, the second half of the batch swapped."""
    half = np.arange(K) >= K // 2
    a_sw = [np.where(half.reshape((-1,) + (1,) * (x.ndim - 1)), y, x) for x, y in zip(a, b)]
    b_sw = [np.where(half.reshape((-1,) + (1,) * (x.ndim - 1)), x, y) for x, y in zip(a, b)]
    return tuple(a_sw + b_sw + [max_t])


def _motion(rng, d, drift_share=0.3):
    """Velocities closing along ``d`` (unit, from a to b) at 0.5-4 m/s, off
    it by ``drift_share`` of the speed, plus a common velocity; and
    ``max_t``."""
    speed = rng.uniform(0.5, 4.0, K).astype(np.float32)
    rel = (d + drift_share * rng.normal(size=(K, 3))).astype(np.float32) * speed[:, None]
    drift = rng.normal(size=(K, 3)).astype(np.float32)
    va, vb = (0.6 * rel + drift).astype(np.float32), (drift - 0.4 * rel).astype(np.float32)
    return va, vb, rng.uniform(0.3, 1.0, K).astype(np.float32)


def _level_triangle(rng):
    """A level triangle of circumradius 1.5-2 m about its centroid (larger
    than any seeded shape, so a shape coming down over the centroid lands on
    its face)."""
    ang = rng.uniform(0.0, 2.0 * np.pi) + np.asarray([0.0, 2.1, 4.2]) + rng.uniform(-0.2, 0.2, 3)
    r = rng.uniform(1.5, 2.0, 3)
    p = np.stack([r * np.cos(ang), np.zeros(3), r * np.sin(ang)], 1).astype(np.float32)
    return (p - p.mean(0)).astype(np.float32), 1.0, 0.0


def _triangle_batch(pair, rng):
    """Shape a over the centroid of a level flat triangle b coming straight
    down onto its face (a half-space a below it coming up)."""
    ta, tb = pair
    pool = _Pool()
    prm_b = np.zeros((K, 8), np.float32)
    for i in range(K):
        prm_b[i, :7] = pool.add(*_level_triangle(rng))
    prm_a = _params(rng, ta, K, pool, kinds=NOT_FLAT)
    pb = rng.uniform(-1.0, 1.0, (K, 3)).astype(np.float32)
    qb = quats(rng, K, 0.05)
    slide = rng.uniform(-0.05, 0.05, (K, 3)).astype(np.float32) * np.asarray([1, 0, 1], np.float32)
    if ta == PLANE:
        qa = quats(rng, K, 0.05)
        pa = (pb - slide - _UP * rng.uniform(0.05, 0.6, K)[:, None]).astype(np.float32)
        d = np.tile(_UP, (K, 1))
    else:
        qa = quats(rng, K, 0.8)
        rise = _reach(ta, prm_a) * rng.uniform(1.05, 1.8, K)
        pa = (pb + slide + _UP * rise[:, None]).astype(np.float32)
        d = np.tile(-_UP, (K, 1))
    va, vb, max_t = _motion(rng, d, 0.02)
    a = [np.full(K, ta, np.int32), pa, qa, prm_a, va]
    b = [np.full(K, tb, np.int32), pb, qb, prm_b, vb]
    return _swap_half(a, b, max_t), pool.array()


def batch(name):
    """Batch ``name`` of ``BATCHES`` as the reference takes it: (type_a,
    pos_a, quat_a, params_a, vel_a, type_b, pos_b, quat_b, params_b, vel_b,
    max_t) with a leading [K], and the vertex pool."""
    index = [b[0] for b in BATCHES].index(name)
    _, pair, on_triangle = BATCHES[index]
    rng = np.random.default_rng(100 + index)
    if on_triangle:
        return _triangle_batch(pair, rng)
    ta, tb = pair
    pool = _Pool()
    prm_a = _params(rng, ta, K, pool, kinds=NOT_FLAT)
    prm_b = _params(rng, tb, K, pool, kinds=NOT_FLAT)
    pa = rng.uniform(-1.0, 1.0, (K, 3)).astype(np.float32)
    qa, qb = quats(rng, K, 0.8), quats(rng, K, 0.8)
    if ta == PLANE:
        qa = quats(rng, K, 0.1)
        d = rotate_np(qa, np.tile(_UP, (K, 1)))
        reach = _reach(tb, prm_b) * rng.uniform(0.5, 1.6, K).astype(np.float32)
    else:
        d = rng.normal(size=(K, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        reach = (_reach(ta, prm_a) + _reach(tb, prm_b)) * rng.uniform(0.8, 1.6, K)
    pb = (pa + d * reach[:, None]).astype(np.float32)
    va, vb, max_t = _motion(rng, d)
    a = [np.full(K, ta, np.int32), pa, qa, prm_a, va]
    b = [np.full(K, tb, np.int32), pb, qb, prm_b, vb]
    return _swap_half(a, b, max_t), pool.array()


def digest(args, pool):
    """A hash of a batch's inputs."""
    h = hashlib.sha256()
    for x in tuple(args) + (pool,):
        h.update(np.ascontiguousarray(x).tobytes())
    return h.hexdigest()


def _reference(args, pool, pairs):
    ta, pa, qa, prm_a, va, tb, pb, qb, prm_b, vb, max_t = args
    kw = dict(shape_pairs=pairs, convex_verts=pool)
    shapes = (ta, pa, qa, prm_a, tb, pb, qb, prm_b)
    m = jcq.contact_manifolds(*shapes, **kw)
    return ((m.normal, m.point_a, m.point_b, m.separation, m.feature_id, m.count)
            + tuple(jcq.contact(*shapes, **kw)) + tuple(jcq.closest_points(*shapes, **kw))
            + (jcq.distance(*shapes, **kw), jcq.intersection_test(*shapes, **kw))
            + tuple(jcq.time_of_impact(ta, pa, qa, prm_a, va, tb, pb, qb, prm_b, vb, max_t,
                                       **kw)))


def reference_outputs(name):
    """``{output: array}`` of the reference on batch ``name``, compiled
    for it."""
    args, pool = batch(name)
    pair = dict((b[0], b[1]) for b in BATCHES)[name]
    fn = jax.jit(jax.vmap(lambda a, p: _reference(a, p, (pair,)), in_axes=(0, None)))
    return dict(zip(OUTPUTS, (np.asarray(x) for x in fn(args, pool))))


@functools.cache
def _recording():
    with np.load(RECORDING) as z:
        return {k: z[k] for k in z.files}


def recorded(name):
    rec = _recording()
    return rec[f"{name}/digest"].item(), {k: rec[f"{name}/{k}"] for k in OUTPUTS}


def _close(what, got, want):
    got = as_numpy(got)
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite, err_msg=what)
    np.testing.assert_array_equal(got[~finite], want[~finite], err_msg=what)
    err = float(np.abs(got[finite] - want[finite]).max()) if finite.any() else 0.0
    assert err <= TOL, f"{what}: max abs {err} > {TOL}"


@pytest.mark.parametrize("name", [b[0] for b in BATCHES])
def test_pair_queries_match_reference(name):
    args, pool = batch(name)
    want_digest, r = recorded(name)
    assert digest(args, pool) == want_digest, \
        "the seeded inputs are not the recorded ones: rerun record_contact_query.py"
    pair = dict((b[0], b[1]) for b in BATCHES)[name]
    ta, pa, qa, prm_a, va, tb, pb, qb, prm_b, vb, max_t = (torch.from_numpy(np.asarray(x))
                                                            for x in args)
    shapes = (ta, pa, qa, prm_a, tb, pb, qb, prm_b)
    kw = dict(shape_pairs=(pair,), convex_verts=torch.from_numpy(pool))
    m = tcq.contact_manifolds(*shapes, **kw)
    want = SimpleNamespace(**{k[2:]: r[k] for k in OUTPUTS[:6]})
    assert_manifolds_equal(want, (m.normal, m.point_a, m.point_b, m.separation,
                                             m.feature_id, m.count), TOL)
    found, c_pa, c_pb, c_n, pen = tcq.contact(*shapes, **kw)
    np.testing.assert_array_equal(as_numpy(found), r["c_found"], err_msg="contact found")
    for what, x in zip(("point_a", "point_b", "normal", "penetration"), (c_pa, c_pb, c_n, pen)):
        _close(f"contact {what}", x, r[f"c_{what}"])
    inter, q_a, q_b = tcq.closest_points(*shapes, **kw)
    np.testing.assert_array_equal(as_numpy(inter), r["cp_intersecting"], err_msg="closest")
    _close("closest point_a", q_a, r["cp_point_a"])
    _close("closest point_b", q_b, r["cp_point_b"])
    _close("distance", tcq.distance(*shapes, **kw), r["distance"])
    np.testing.assert_array_equal(as_numpy(tcq.intersection_test(*shapes, **kw)),
                                  r["intersecting"], err_msg="intersection_test")
    hit, t = tcq.time_of_impact(ta, pa, qa, prm_a, va, tb, pb, qb, prm_b, vb, max_t, **kw)
    np.testing.assert_array_equal(as_numpy(hit), r["toi_hit"], err_msg="toi hit")
    _close("toi t", t, r["toi_t"])
    if pair != (PLANE, PLANE):
        assert r["toi_hit"].any(), "the batch should hold hits"


def test_recording_is_the_live_reference():
    """The analytic batches, compiled here, equal the recording bit for
    bit."""
    with ThreadPoolExecutor(len(ANALYTIC)) as ex:
        live = dict(zip(ANALYTIC, ex.map(reference_outputs, ANALYTIC)))
    for name, outs in live.items():
        _, r = recorded(name)
        for k in OUTPUTS:
            np.testing.assert_array_equal(outs[k], r[k], err_msg=f"{name} {k}")


def test_the_reference_s_contact_query_cases():
    """``tests/test_contact_query.py``'s two cases on the port."""
    pairs = ((0, 0), (0, 2))
    a = (0, (0.0, 0.0, 0.0), I, (0.5,))
    far, near = (0, (2.0, 0.0, 0.0), I, (0.5,)), (0, (0.8, 0.0, 0.0), I, (0.5,))
    kw = dict(shape_pairs=pairs, device="cpu")
    assert abs(float(tcq.distance(*a, *far, **kw)) - 1.0) < 1e-5
    assert not bool(tcq.intersection_test(*a, *far, **kw))
    assert bool(tcq.intersection_test(*a, *near, **kw))
    found, _, _, _, pen = tcq.contact(*a, *near, **kw)
    assert bool(found) and abs(float(pen) - 0.2) < 1e-5
    hit, t = tcq.time_of_impact(0, (0.0, 0.0, 0.0), I, (0.5,), (10.0, 0.0, 0.0),
                                0, (5.0, 0.0, 0.0), I, (0.5,), (0.0, 0.0, 0.0), 1.0, **kw)
    assert bool(hit) and abs(float(t) - 0.4) < 5e-3


def _toi_both(a, va, b, vb, max_t, pairs):
    ref = jax.jit(functools.partial(jcq.time_of_impact, shape_pairs=pairs))(
        jnp.asarray(a[0]), jnp.asarray(a[1], jnp.float32), jnp.asarray(a[2], jnp.float32),
        jnp.asarray(a[3], jnp.float32), jnp.asarray(va, jnp.float32), jnp.asarray(b[0]),
        jnp.asarray(b[1], jnp.float32), jnp.asarray(b[2], jnp.float32),
        jnp.asarray(b[3], jnp.float32), jnp.asarray(vb, jnp.float32),
        jnp.asarray(max_t, jnp.float32))
    got = tcq.time_of_impact(*a, va, *b, vb, np.float32(max_t), shape_pairs=pairs, device="cpu")
    assert bool(got[0]) == bool(ref[0])
    assert float(got[1]) == float(ref[1])
    return got


def test_touching_and_moving_apart():
    """A sphere resting on a box hits at t = 0; two spheres moving apart
    never hit and end at the clamp, max_t * 1.01. Both as the reference."""
    prm = (0.5, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
    box = (2, (0.0, 0.0, 0.0), I, (1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0))
    hit, t = _toi_both((0, (0.3, 1.5, 0.0), I, prm), (0.0, -1.0, 0.0), box, (0.0, 0.0, 0.0),
                       0.5, ((0, 2),))
    assert bool(hit) and float(t) == 0.0
    hit, t = _toi_both((0, (0.0, 0.0, 0.0), I, prm), (-1.0, 0.0, 0.0),
                       (0, (2.0, 0.0, 0.0), I, prm), (1.0, 0.0, 0.0), 0.5, ((0, 0),))
    assert not bool(hit) and float(t) == float(np.float32(0.5) * np.float32(1.01))


def test_batched_equals_one_pair_calls():
    """A batched call gives each pair what its own call gives."""
    args, pool = batch("1-8")
    kw = dict(shape_pairs=((1, 8),), convex_verts=torch.from_numpy(pool))
    tens = [torch.from_numpy(np.asarray(x)) for x in args]
    hit, t = tcq.time_of_impact(*tens, **kw)
    dist = tcq.distance(*tens[:4], *tens[5:9], **kw)
    for i in (0, K - 1):
        one = [x[i] for x in tens]
        h1, t1 = tcq.time_of_impact(*one, **kw)
        assert bool(h1) == bool(hit[i]) and float(t1) == float(t[i])
        assert float(tcq.distance(*one[:4], *one[5:9], **kw)) == float(dist[i])
