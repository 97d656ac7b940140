"""The plain versions of Kernels P and Q (``geometry/convex.py`` on the vertex
pool) and of the segment instances of Kernels M and O against the JAX
reference's pair functions (``generic_convex_pair_aux``,
``support_patch_plane_pair_aux`` behind ``_swapped_aux``,
``generic_convex_pair`` and ``_swapped(support_patch_plane_pair)`` for the
segment), jitted on the CPU, for the 15 canonical pairs that segments and
pool-backed convex shapes add: a segment with a sphere, capsule, box,
half-space, cylinder, cone or segment, and a CONVEX shape with each of
those and with a CONVEX shape.

The CONVEX shapes are seeded: hulls of 4-32 points on an ellipsoid,
box-like hulls of 8 corners (four vertices tie on every face: the top 8's
and the angle order's tie rules decide), round box hulls (radius 0.05),
octahedra, and flat triangles (params lane 5), on one shared vertex pool
with 32 zero rows at its end, as the builder lays it out. Per pair: 64
random poses, the same 64 moved to touching, overlapping and speculative
distances along the reference's normal, and 64 resting configurations
(one shape lying on a horizontal triangle or on a box hull's face, a box
hull on a half-space) in which the normal snap and the flat rule decide.
Counts and feature-id sets exactly; normals, witnesses and separations
within 1e-5. The reference is compiled one IEEE operation at a time
(``port_common.ieee_reference``).

One deliberate difference (ROADMAP 3b): the reference's flat rule snaps the
normal to a triangle's face even when the other shape's centre lies behind
that face, which at a concave fold of a mesh pushes a body resting on the
next triangle through the mesh; the port applies the rule only where the
centre lies in front. A pair where the two differ must show the fault in
the reference (its snapped normal has the other centre behind the face)
and must equal the reference with that triangle's flat flag cleared.

The reference's manifolds are read from ``hull_manifold_reference.npz``
(``port_common.Recording``, keyed by a digest of its inputs; rerecord with
``record_references.py cases_hull_manifold.py``, which compiles the 15
references in threads), except the sphere/segment pair's, which runs live
and is held to the recording."""

from port_common import ieee_reference

ieee_reference()

import functools  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from scipy.spatial import ConvexHull  # noqa: E402

from avian_tpu.geometry import narrowphase as jgeo  # noqa: E402
from avian_tpu_torch.geometry import narrowphase as tgeo  # noqa: E402
from avian_tpu_torch.kernels import hull_manifold as kpq  # noqa: E402

from port_common import Recording, assert_manifolds_equal, quats, rotate_np  # noqa: E402

TOL = 1e-5
K = 64  # pairs in every batch, so that each reference compiles once
POOL_ROWS = 2 * K * 32 + 32  # every batch's pool, zero-padded to one size
SPHERE, CAPSULE, BOX, PLANE, CYLINDER, CONE, SEGMENT, CONVEX = 0, 1, 2, 3, 4, 5, 6, 8
PAIRS = tuple((a, SEGMENT) for a in (SPHERE, CAPSULE, BOX, PLANE, CYLINDER, CONE, SEGMENT)) + \
    tuple((a, CONVEX) for a in (SPHERE, CAPSULE, BOX, PLANE, CYLINDER, CONE, SEGMENT, CONVEX))
_TABLE = {(int(a), int(b)): fn for a, b, fn in jgeo._CANONICAL}
# Pairs whose manifold has at most 2 points (no face meets a face).
RECORDING = Recording("hull_manifold")
LIVE_PAIR = (SPHERE, SEGMENT)  # the one pair whose reference runs live
_NO_FACE = {(CAPSULE, SEGMENT), (PLANE, SEGMENT), (SEGMENT, SEGMENT)}
_UP = np.asarray([0.0, 0.0, 0.0, 1.0], np.float32)
_LYING = np.asarray([0.0, 0.0, np.sin(np.pi / 4), np.cos(np.pi / 4)], np.float32)  # Y -> -X


def _hull_block(rng, kind, level=False):
    """One CONVEX shape's vertices about their centroid, its flat flag and
    radius: 0 an ellipsoid hull of 4-32 points, 1 a box hull (round in
    half the cases), 2 a flat triangle (horizontal with ``level``), 3 an
    octahedron."""
    flat, r = 0.0, 0.0
    if kind == 0:
        p = rng.normal(size=(int(rng.integers(4, 33)), 3))
        p = (p / np.linalg.norm(p, axis=1, keepdims=True) * rng.uniform(0.3, 0.7, 3)).astype(np.float32)
        p = p[ConvexHull(p).vertices]
    elif kind == 1:
        e = rng.uniform(0.25, 0.6, 3)
        p = np.asarray([(sx * e[0], sy * e[1], sz * e[2])
                        for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)], np.float32)
        r = float(rng.choice([0.0, 0.05]))
    elif kind == 2:
        p = rng.uniform(-0.8, 0.8, (3, 3)).astype(np.float32)
        p[:, 1] *= 0.0 if level else 0.2
        flat = 1.0
    else:
        s = rng.uniform(0.35, 0.6)
        p = np.asarray([(s, 0, 0), (-s, 0, 0), (0, s, 0), (0, -s, 0), (0, 0, s), (0, 0, -s)],
                       np.float32)
    return (p - p.mean(0)).astype(np.float32), flat, r


class _Pool:
    """Vertex blocks appended in order; ``array()`` is the pool with its 32
    zero rows, as ``SceneBuilder.finalize`` lays it out."""

    def __init__(self):
        self.blocks, self.rows = [], 0

    def add(self, p, flat, r):
        h = np.abs(p).max(0) + r
        prm = (float(self.rows), float(len(p)), h[0], h[1], h[2], flat, r)
        self.blocks.append(p)
        self.rows += len(p)
        return prm

    def array(self):
        pad = np.zeros((POOL_ROWS - self.rows, 3), np.float32)
        return np.concatenate(self.blocks + [pad]).astype(np.float32)


def _params(rng, shape, k, pool, kinds=(0, 1, 2, 3)):
    """Params [k, 8] of ``k`` shapes; CONVEX ones go into ``pool``."""
    out = np.zeros((k, 8), np.float32)
    u = lambda lo, hi: rng.uniform(lo, hi, k).astype(np.float32)  # noqa: E731
    if shape == CONVEX:
        for i in range(k):
            out[i, :7] = pool.add(*_hull_block(rng, kinds[int(rng.integers(0, len(kinds)))]))
    elif shape == SPHERE:
        out[:, 0] = u(0.3, 0.5)
    elif shape == CAPSULE:
        out[:, 0], out[:, 1] = u(0.2, 0.5), u(0.2, 0.4)
    elif shape == BOX:
        out[:, :3] = np.stack([u(0.3, 0.7), u(0.3, 0.7), u(0.3, 0.7)], 1)
    elif shape == PLANE:
        out[:, 1] = 1.0
    elif shape == SEGMENT:
        out[:, 0] = u(0.3, 0.8)
    else:  # cylinder, cone: (h, r)
        out[:, 0], out[:, 1] = u(0.2, 0.6), u(0.3, 0.6)
    return out


def _reach(shape, prm):
    """A radius that bounds each shape."""
    if shape == CONVEX:
        return np.linalg.norm(prm[:, 2:5], axis=1)
    if shape == BOX:
        return np.linalg.norm(prm[:, :3], axis=1)
    if shape in (SPHERE, SEGMENT):
        return prm[:, 0]
    if shape == CAPSULE:
        return prm[:, 0] + prm[:, 1]
    return np.hypot(prm[:, 0], prm[:, 1])


def _random_pairs(pair, rng):
    ta, tb = pair
    pool = _Pool()
    prm_a, prm_b = _params(rng, ta, K, pool), _params(rng, tb, K, pool)
    pa = rng.uniform(-1.0, 1.0, (K, 3)).astype(np.float32)
    qa, qb = quats(rng, K, 0.8), quats(rng, K, 0.8)
    d = rng.normal(size=(K, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if ta == PLANE:
        qa = quats(rng, K, 0.1)
        reach = _reach(tb, prm_b) * rng.uniform(0.0, 1.1, K).astype(np.float32)
        up = np.tile([[0.0, 1.0, 0.0]], (K, 1)).astype(np.float32)
        pb = pa + rotate_np(qa, up) * reach[:, None]
    else:
        reach = (_reach(ta, prm_a) + _reach(tb, prm_b)) * rng.uniform(0.3, 1.1, K).astype(np.float32)
        pb = pa + d * reach[:, None]
    return [pa, qa, prm_a, pb.astype(np.float32), qb, prm_b], pool.array()


def _moved(inputs, ref, rng):
    """The same pairs with B moved along the reference's normal to a gap of
    0 (a third), -0.05..0 (a third) or 0..0.04 (a third)."""
    pa, qa, prm_a, pb, qb, prm_b = inputs
    n = np.asarray(ref.normal)
    sep = np.asarray(ref.separation).min(1)
    sep = np.where(sep < 1e8, sep, 0.0)
    cat = np.arange(K) % 3
    target = np.where(cat == 1, -rng.uniform(0.0, 0.05, K),
                      np.where(cat == 2, rng.uniform(0.0, 0.04, K), 0.0))
    return [pa, qa, prm_a, (pb - n * (sep - target)[:, None]).astype(np.float32), qb, prm_b]


def _half_y(shape, prm, lying):
    """Half extent along world y of a shape, upright or lying on its side."""
    if shape == CONVEX:
        return prm[:, 3]
    if shape == SPHERE:
        return prm[:, 0]
    if shape == BOX:
        return prm[:, 1]
    if shape == SEGMENT:
        return np.zeros(prm.shape[0], np.float32)
    if shape == CAPSULE:
        return np.where(lying, prm[:, 1], prm[:, 0] + prm[:, 1])
    return np.where(lying, prm[:, 1], prm[:, 0])  # cylinder, cone


def _resting_pairs(pair, rng):
    """Shape A lying on B, B a horizontal flat triangle (half the batch) or
    a box hull on its face (the other half), within +-1 cm; for a
    half-space A, box and round box hulls and triangles resting on it."""
    ta, tb = pair
    pool = _Pool()
    kinds_b = np.where(np.arange(K) % 2 == 0, 2, 1)
    prm_b = np.zeros((K, 8), np.float32)
    for i in range(K):
        kind = int(kinds_b[i]) if ta != PLANE else int(rng.choice([1, 2]))
        p, flat, r = _hull_block(rng, kind, level=True)
        prm_b[i, :7] = pool.add(p, flat, r)
    prm_a = _params(rng, ta, K, pool, kinds=(1, 2, 0))
    lying = (np.arange(K) // 2) % 2 == 1
    tilt = quats(rng, K, 0.005)
    qa = np.where(lying[:, None] & (ta in (CAPSULE, CYLINDER, CONE)), _LYING, _UP).astype(np.float32)
    qa = _compose(tilt, qa)
    qb = _compose(quats(rng, K, 0.005), np.tile(_UP, (K, 1)))
    pb = rng.uniform(-1.0, 1.0, (K, 3)).astype(np.float32)
    gap = rng.uniform(-0.01, 0.01, K).astype(np.float32)
    if ta == PLANE:
        prm_a = _params(rng, PLANE, K, pool)
        pa = pb.copy()
        pb = (pa + np.stack([np.zeros(K), prm_b[:, 3] + gap, np.zeros(K)], 1)).astype(np.float32)
        return [pa, np.tile(_UP, (K, 1)), prm_a, pb, qb, prm_b], pool.array()
    rise = _half_y(tb, prm_b, False) + _half_y(ta, prm_a, lying) + gap
    slide = rng.uniform(-0.1, 0.1, (K, 3)).astype(np.float32) * np.asarray([1, 0, 1], np.float32)
    pa = (pb + slide + np.stack([np.zeros(K), rise, np.zeros(K)], 1)).astype(np.float32)
    return [pa, qa, prm_a, pb, qb, prm_b], pool.array()


def _compose(a, b):
    x1, y1, z1, w1 = a.T
    x2, y2, z2, w2 = b.T
    out = np.stack([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2, w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                    w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2, w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], -1)
    return (out / np.linalg.norm(out, axis=1, keepdims=True)).astype(np.float32)


def _compile(pair):
    """The reference's pair function, vmapped over K pairs and compiled for
    this file's shapes (params [K, 8], the pool [POOL_ROWS + 32, 3])."""
    fn = _TABLE[pair]
    f32 = jnp.float32
    args = [jax.ShapeDtypeStruct((K, w), f32) for w in (3, 4, 8, 3, 4, 8)]
    if getattr(fn, "needs_pool", False):
        jf = jax.jit(jax.vmap(fn, in_axes=(0, 0, 0, 0, 0, 0, None)))
        return jf.lower(*args, jax.ShapeDtypeStruct((POOL_ROWS + 32, 3), f32)).compile()
    return jax.jit(jax.vmap(fn)).lower(*args).compile()


@functools.cache
def _compiled():
    """Every pair's reference, compiled at once in threads (XLA's compiles
    overlap; one after the other they take most of a recording's time)."""
    with ThreadPoolExecutor(8) as ex:
        return dict(zip(PAIRS, ex.map(_compile, PAIRS)))


@functools.cache
def _compiled_one(pair):
    return _compiled()[pair] if RECORDING.mode == "record" else _compile(pair)


def _reference(pair):
    """The reference's manifolds of K pairs ``(inputs, pool)``, from the
    recording, or run live for ``LIVE_PAIR`` and held to it."""

    def run(inputs, pool):
        fn = _compiled_one(pair)
        if getattr(_TABLE[pair], "needs_pool", False):
            # compute_manifold pads the pool with 32 more zero rows.
            return fn(*inputs, np.concatenate([pool, np.zeros((32, 3), np.float32)]))
        return fn(*inputs)

    return lambda inputs, pool: RECORDING((pair, list(inputs), pool),
                                          lambda: run(inputs, pool), live=pair == LIVE_PAIR)


def _port(pair, inputs, pool):
    module, name, kind = tgeo.PAIR_KERNELS[pair]
    lanes = kpq.PARAM_LANES if name in tgeo.POOL_KERNELS else 3
    t = [torch.from_numpy(np.ascontiguousarray(x, np.float32)) for x in inputs]
    t[2], t[5] = t[2][:, :lanes].contiguous(), t[5][:, :lanes].contiguous()
    if name in tgeo.POOL_KERNELS:
        t.append(torch.from_numpy(pool))
    return getattr(module, name)(kind, *t)


def _rows(m, i):
    """Pair ``i`` of K manifolds (a recorded reference ``Manifold`` or the
    port's tuple), as a batch of one."""
    if isinstance(m, tuple):
        return tuple(x[i:i + 1] for x in m)
    return type(m)({k: np.asarray(x)[i:i + 1] for k, x in m.items()})


def _agrees(ref, port, i):
    try:
        assert_manifolds_equal(_rows(ref, i), _rows(port, i), TOL)
    except AssertionError:
        return False
    return True


def _flat_fault(pair, inputs, ref, i, side):
    """Whether the reference's normal of pair ``i`` is the flat rule's snap
    onto the back of the ``side`` shape's triangle: flat, and the other
    shape's centre behind the face the normal was taken from."""
    pa, _, prm_a, pb, _, prm_b = inputs
    n = np.asarray(ref.normal)[i]
    if side == "b":
        return prm_b[i, 5] > 0.5 and float(np.dot(-n, pa[i] - pb[i])) <= 0.0
    return prm_a[i, 5] > 0.5 and float(np.dot(n, pb[i] - pa[i])) <= 0.0


def _assert_port_matches(pair, ref_fn, inputs, pool):
    """The port against the reference on K pairs; where they differ, the
    reference must show the flat-rule fault and the port must equal the
    reference with the faulty triangle's flat flag cleared. Returns (the
    reference's manifolds, the number of such pairs)."""
    ref = ref_fn(inputs, pool)
    port = _port(pair, inputs, pool)
    differ = [i for i in range(K) if not _agrees(ref, port, i)]
    sides = {"b": (5,), "a": (2,), "ab": (2, 5)} if pair == (CONVEX, CONVEX) else {"b": (5,)}
    for i in differ:
        for side, cols in sides.items():
            if not all(_flat_fault(pair, inputs, ref, i, c) for c in side):
                continue
            cleared = [x.copy() for x in inputs]
            for col in cols:
                cleared[col][i, 5] = 0.0
            if _agrees(ref_fn(cleared, pool), port, i):
                break
        else:
            assert_manifolds_equal(_rows(ref, i), _rows(port, i), TOL)  # raises with the diff
    return ref, len(differ)


@pytest.mark.parametrize("pair", PAIRS, ids=[f"{a}-{b}" for a, b in PAIRS])
def test_hull_and_segment_manifolds_match_reference(pair):
    rng = np.random.default_rng(500 + 10 * pair[0] + pair[1])
    ref_fn = _reference(pair)
    rand, pool = _random_pairs(pair, rng)
    batches = {"random": (rand, pool), "moved": (_moved(rand, ref_fn(rand, pool), rng), pool)}
    if pair[1] == CONVEX:
        batches["resting"] = _resting_pairs(pair, rng)
    counts, faults = [], 0
    for name, (inputs, pl) in batches.items():
        inputs = [np.asarray(x, np.float32) for x in inputs]
        try:
            ref, n = _assert_port_matches(pair, ref_fn, inputs, pl)
        except AssertionError as err:
            raise AssertionError(f"{pair} {name}: {err}") from None
        faults += n
        counts.append(np.asarray(ref.count))
    # The fault needs a flat triangle, which only a CONVEX shape can be.
    assert faults == 0 or CONVEX in pair
    assert faults <= 0.1 * K * len(batches), faults
    counts = np.concatenate(counts)
    # Both manifold kinds ran where both can: clipped patches (3-4 points)
    # and support witnesses (1-2 points).
    assert (counts <= 2).sum() > 0, np.bincount(counts)
    if SPHERE not in pair and pair not in _NO_FACE:
        assert (counts >= 3).sum() > 0, np.bincount(counts)


def test_pool_wrappers_refuse_unknown_kinds_devices_and_pools():
    one = torch.zeros((1, 3))
    seven = torch.zeros((1, 7))
    q = torch.tensor([[0.0, 0.0, 0.0, 1.0]])
    pool = torch.zeros((33, 3))
    with pytest.raises(ValueError):
        kpq.hull_manifold(len(kpq.HULL_PAIRS), one, q, seven, one, q, seven, pool)
    with pytest.raises(ValueError):
        kpq.plane_hull_manifold(1, one, q, seven, one, q, seven, pool)
    meta = [x.to("meta") for x in (one, q, seven, one, q, seven, pool)]
    with pytest.raises(RuntimeError):
        kpq.hull_manifold(0, *meta)
    with pytest.raises(RuntimeError):
        kpq.plane_hull_manifold(0, *meta)


def test_flat_rule_keeps_a_cone_above_a_concave_fold():
    """A cone resting on a heightfield's triangle, at the shared edge with
    its neighbour, from ``terrain_shapes(10_000, per_row=48)`` (step 36, a
    rock landing on the cone): the neighbour's plane rises past the cone's
    base, the contact direction points from the cone up-sideways to that
    triangle, and the reference snaps it to the triangle's back face and
    pushes the cone 0.71 m down through the field (ROADMAP 3b). The port
    keeps the support-map normal: a touching contact, 1 cm apart, and the
    reference with that triangle's flat flag cleared."""
    tri = np.asarray([[17.0, 1.2390767, -3.0], [18.0, 1.3770664, -3.0],
                      [17.0, 1.2087471, -2.0]], np.float32)
    centre = tri.mean(0)
    pool = _Pool()
    prm_b = np.zeros((K, 8), np.float32)
    prm_b[:, :7] = pool.add((tri - centre).astype(np.float32), 1.0, 0.0)
    q = np.asarray([0.0042416, 0.01516697, 0.08491284, 0.99626386], np.float32)
    inputs = [np.tile(np.asarray([17.552637, 1.6495332, -2.1034927], np.float32), (K, 1)),
              np.tile(q / np.linalg.norm(q), (K, 1)).astype(np.float32),
              np.tile(np.asarray([0.35, 0.35, 0, 0, 0, 0, 0, 0], np.float32), (K, 1)),
              np.tile(centre, (K, 1)).astype(np.float32), np.tile(_UP, (K, 1)), prm_b]
    ref_fn = _reference((CONE, CONVEX))
    ref = ref_fn(inputs, pool.array())
    assert float(np.asarray(ref.separation)[0, 0]) < -0.7
    assert _flat_fault((CONE, CONVEX), inputs, ref, 0, "b")
    port = _port((CONE, CONVEX), inputs, pool.array())
    assert 0.0 < float(port[3][0].min()) < 0.02 and int(port[5][0]) == 2
    assert float(port[0][0, 1]) > 0.3  # from the cone up-sideways to the triangle's edge
    cleared = [x.copy() for x in inputs]
    cleared[5][:, 5] = 0.0
    assert_manifolds_equal(ref_fn(cleared, pool.array()), port, TOL)
