"""Kernels M and O's plain versions (``geometry/convex.py``) against the
JAX reference's support-map pair functions (``generic_convex_pair`` and, for
a half-space against a cylinder or a cone, ``_swapped`` of
``support_patch_plane_pair``), jitted on the CPU, for the ten generic and the
two half-space pairs of the mixed-shape path. Per pair: 64 random poses, the
same 64 moved to touching, overlapping and speculative distances along the
reference's normal, 64 resting configurations in which the normal snap
decides (a cylinder cap on a box face, cylinder on cylinder, a cone base on
a half-space or a box, lying cylinders and capsules), and for capsule/box
the reference's own capsule-vs-box-corner case
(``tests/test_shapes_convex.py:84``). Counts and feature-id sets exactly;
normals, witnesses and separations within 1e-5.

The reference is compiled one IEEE operation at a time
(``port_common.ieee_reference``): with fused multiply-adds and XLA:CPU's
approximate ``1 / sqrt`` its Frank-Wolfe iteration decides the degenerate
first triangle by the sign of a rounding residual, and its results move by
up to 1e-3 with what a program fuses. With IEEE operations the plain
versions agree with it to the last bit on every pair here, so no pair is
exempt."""

from port_common import ieee_reference

ieee_reference()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from avian_tpu.geometry import narrowphase as jgeo  # noqa: E402
from avian_tpu_torch.geometry import narrowphase as tgeo  # noqa: E402
from avian_tpu_torch.kernels import convex_manifold as km  # noqa: E402

from port_common import assert_manifolds_equal, pad8, quats, rotate_np  # noqa: E402

TOL = 1e-5
K = 64  # pairs in every batch, so that each reference compiles once
SPHERE, CAPSULE, BOX, PLANE, CYLINDER, CONE = range(6)
SEGMENT = 6
# The ten generic pairs of the mixed-shape path (the segment's six are held
# in cases_hull_manifold.py) and the two half-space pairs.
PAIRS = tuple(p for p in km.GENERIC_PAIRS if SEGMENT not in p) + ((PLANE, CYLINDER), (PLANE, CONE))
_TABLE = {(int(a), int(b)): fn for a, b, fn in jgeo._CANONICAL}
_UP = np.asarray([0.0, 0.0, 0.0, 1.0], np.float32)
_LYING = np.asarray([0.0, 0.0, np.sin(np.pi / 4), np.cos(np.pi / 4)], np.float32)  # Y -> -X
_FLIPPED = np.asarray([1.0, 0.0, 0.0, 0.0], np.float32)  # 180 degrees about X


def _params(rng, shape, k):
    u = lambda lo, hi: rng.uniform(lo, hi, k).astype(np.float32)  # noqa: E731
    zero = np.zeros(k, np.float32)
    if shape == SPHERE:
        return np.stack([u(0.3, 0.5), zero, zero], 1)
    if shape == CAPSULE:
        return np.stack([u(0.2, 0.5), u(0.2, 0.4), zero], 1)
    if shape == BOX:
        return np.stack([u(0.3, 0.7), u(0.3, 0.7), u(0.3, 0.7)], 1)
    if shape == PLANE:
        return np.tile(np.asarray([[0.0, 1.0, 0.0]], np.float32), (k, 1))
    return np.stack([u(0.2, 0.6), u(0.3, 0.6), zero], 1)  # cylinder, cone: (h, r)


def _reach(shape, prm):
    """A radius that bounds the shape."""
    if shape == BOX:
        return np.linalg.norm(prm, axis=1)
    if shape == SPHERE:
        return prm[:, 0]
    if shape == CAPSULE:
        return prm[:, 0] + prm[:, 1]
    return np.hypot(prm[:, 0], prm[:, 1])


def _half_y(shape, prm, orient):
    """Half extent along world y of a shape lying ``orient``."""
    if shape == SPHERE:
        return prm[:, 0]
    if shape == BOX:
        return prm[:, 1]
    if shape == CAPSULE:
        return prm[:, 1] if orient == "lying" else prm[:, 0] + prm[:, 1]
    if shape == PLANE:
        return np.zeros(prm.shape[0], np.float32)
    return prm[:, 1] if orient == "lying" else prm[:, 0]


# Resting layouts per pair: (lower shape, its orientation, upper shape, its
# orientation), half of the batch each.
_RESTING = {
    (SPHERE, CYLINDER): [(CYLINDER, "up", SPHERE, "up"), (SPHERE, "up", CYLINDER, "up")],
    (SPHERE, CONE): [(CONE, "flipped", SPHERE, "up"), (SPHERE, "up", CONE, "up")],
    (CAPSULE, BOX): [(BOX, "up", CAPSULE, "lying"), (BOX, "up", CAPSULE, "up")],
    (CAPSULE, CYLINDER): [(CYLINDER, "up", CAPSULE, "lying"), (CYLINDER, "lying", CAPSULE, "lying")],
    (CAPSULE, CONE): [(CAPSULE, "lying", CONE, "up"), (CONE, "flipped", CAPSULE, "lying")],
    (BOX, CYLINDER): [(BOX, "up", CYLINDER, "up"), (BOX, "up", CYLINDER, "lying")],
    (BOX, CONE): [(BOX, "up", CONE, "up"), (CONE, "flipped", BOX, "up")],
    (CYLINDER, CYLINDER): [(CYLINDER, "up", CYLINDER, "up"), (CYLINDER, "up", CYLINDER, "lying")],
    (CYLINDER, CONE): [(CYLINDER, "up", CONE, "up"), (CONE, "flipped", CYLINDER, "up")],
    (CONE, CONE): [(CONE, "flipped", CONE, "up"), (CONE, "up", CONE, "flipped")],
    (PLANE, CYLINDER): [(PLANE, "up", CYLINDER, "up"), (PLANE, "up", CYLINDER, "lying")],
    (PLANE, CONE): [(PLANE, "up", CONE, "up"), (PLANE, "up", CONE, "flipped")],
}
_ORIENT = {"up": _UP, "lying": _LYING, "flipped": _FLIPPED}


def _random_pairs(pair, rng, k=None):
    k = k or K
    ta, tb = pair
    prm_a, prm_b = _params(rng, ta, k), _params(rng, tb, k)
    pa = rng.uniform(-1.0, 1.0, (k, 3)).astype(np.float32)
    qa, qb = quats(rng, k, 0.8), quats(rng, k, 0.8)
    d = rng.normal(size=(k, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if ta == PLANE:
        qa = quats(rng, k, 0.1)
        reach = _reach(tb, prm_b) * rng.uniform(0.0, 1.1, k).astype(np.float32)
        pb = pa + rotate_np(qa, np.tile([[0.0, 1.0, 0.0]], (k, 1)).astype(np.float32)) * reach[:, None]
    else:
        reach = (_reach(ta, prm_a) + _reach(tb, prm_b)) * rng.uniform(0.4, 1.1, k).astype(np.float32)
        pb = pa + d * reach[:, None]
    return [pa, qa, prm_a, pb.astype(np.float32), qb, prm_b]


def _moved(pairs, ref, rng):
    """The same pairs with B moved along the reference's normal to a gap of
    0 (a third), -0.05..0 (a third) or 0..0.04 (a third)."""
    pa, qa, prm_a, pb, qb, prm_b = pairs
    k = pa.shape[0]
    n = np.asarray(ref.normal)
    sep = np.asarray(ref.separation).min(1)
    sep = np.where(sep < 1e8, sep, 0.0)
    cat = np.arange(k) % 3
    target = np.where(cat == 1, -rng.uniform(0.0, 0.05, k),
                      np.where(cat == 2, rng.uniform(0.0, 0.04, k), 0.0))
    pb = (pb - n * (sep - target)[:, None]).astype(np.float32)
    return [pa, qa, prm_a, pb, qb, prm_b]


def _resting_pairs(pair, rng, k=64):
    out = [np.zeros((k, w), np.float32) for w in (3, 4, 3, 3, 4, 3)]
    for j, (lo_t, lo_o, up_t, up_o) in enumerate(_RESTING[pair]):
        rows = np.arange(k)[j::2]
        m = rows.shape[0]
        prm_lo, prm_up = _params(rng, lo_t, m), _params(rng, up_t, m)
        p_lo = rng.uniform(-1.0, 1.0, (m, 3)).astype(np.float32)
        if lo_t == PLANE:
            q_lo = np.tile(_UP, (m, 1))
        else:
            q_lo = _tilt(rng, np.tile(_ORIENT[lo_o], (m, 1)))
        q_up = _tilt(rng, np.tile(_ORIENT[up_o], (m, 1)))
        gap = rng.uniform(-0.01, 0.01, m).astype(np.float32)
        rise = _half_y(lo_t, prm_lo, lo_o) + _half_y(up_t, prm_up, up_o) + gap
        slide = rng.uniform(-0.1, 0.1, (m, 3)).astype(np.float32) * np.asarray([1, 0, 1], np.float32)
        p_up = p_lo + slide + np.stack([np.zeros(m), rise, np.zeros(m)], 1).astype(np.float32)
        lower_is_a = pair[0] == lo_t and (pair[0] != pair[1] or j % 2 == 0)
        first = (p_lo, q_lo, prm_lo, p_up, q_up, prm_up)
        second = (p_up, q_up, prm_up, p_lo, q_lo, prm_lo)
        for col, x in zip(out, first if lower_is_a else second):
            col[rows] = x
    return out


def _tilt(rng, q, scale=0.01):
    """``q`` turned by a small random rotation."""
    d = quats(rng, q.shape[0], scale)
    x1, y1, z1, w1 = d.T
    x2, y2, z2, w2 = q.T
    out = np.stack([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2, w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                    w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2, w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], -1)
    return (out / np.linalg.norm(out, axis=1, keepdims=True)).astype(np.float32)


def _corner_case():
    """``tests/test_shapes_convex.py:84``: a capsule (half length 0.5,
    radius 0.4) passing the corner of a flat box (0.8, 0.1, 1.0)."""
    xs = np.resize(np.asarray([1.20, 1.25, 1.30, 1.34, 1.3641, 1.40, 1.45], np.float32), K)
    k = K
    ident = np.tile(_UP, (k, 1))
    pa = np.stack([xs, np.full(k, 0.91), np.zeros(k)], 1).astype(np.float32)
    pb = np.tile(np.asarray([[2.5, 0.1, 0.0]], np.float32), (k, 1))
    prm_a = np.tile(np.asarray([[0.5, 0.4, 0.0]], np.float32), (k, 1))
    prm_b = np.tile(np.asarray([[0.8, 0.1, 1.0]], np.float32), (k, 1))
    return [pa, ident, prm_a, pb, ident, prm_b]


def _reference(pair):
    fn = jax.jit(jax.vmap(_TABLE[pair]))
    return lambda pa, qa, prm_a, pb, qb, prm_b: fn(pa, qa, pad8(prm_a), pb, qb, pad8(prm_b))


def _port(pair, inputs):
    module, name, kind = tgeo.PAIR_KERNELS[pair]
    t = [torch.from_numpy(np.ascontiguousarray(x, np.float32)) for x in inputs]
    return getattr(module, name)(kind, *t)


@pytest.mark.parametrize("pair", PAIRS, ids=[f"{a}-{b}" for a, b in PAIRS])
def test_convex_manifolds_match_reference(pair):
    rng = np.random.default_rng(200 + 10 * pair[0] + pair[1])
    ref_fn = _reference(pair)
    rand = _random_pairs(pair, rng)
    batches = {"random": rand, "moved": _moved(rand, ref_fn(*rand), rng),
               "resting": _resting_pairs(pair, rng)}
    if pair == (CAPSULE, BOX):
        batches["corner"] = _corner_case()
    counts = []
    for name, inputs in batches.items():
        ref = ref_fn(*inputs)
        try:
            assert_manifolds_equal(ref, _port(pair, inputs), TOL)
        except AssertionError as err:
            raise AssertionError(f"{pair} {name}: {err}") from None
        counts.append(np.asarray(ref.count))
    counts = np.concatenate(counts)
    # Both manifold kinds ran: clipped patches (3-4 points; a sphere's patch
    # is a point) and support witnesses (1-2 points).
    assert (counts <= 2).sum() > 0, np.bincount(counts)
    assert SPHERE in pair or (counts >= 3).sum() > 0, np.bincount(counts)


def test_kernel_o_normal_points_from_the_plane_to_the_shape():
    """A cone standing on its base 1 cm into the ground: 4 points on the
    base rim, separations -0.01, normal +y (plane first)."""
    one = lambda *v: torch.tensor([v], dtype=torch.float32)  # noqa: E731
    out = km.plane_patch_manifold(
        km.PLANE_CONE, one(0.0, 0.0, 0.0), one(0.0, 0.0, 0.0, 1.0), one(0.0, 1.0, 0.0),
        one(0.0, 0.49, 0.0), one(0.0, 0.0, 0.0, 1.0), one(0.5, 0.5, 0.0))
    normal, point_a, point_b, sep, fid, count = out
    assert int(count[0]) == 4
    np.testing.assert_allclose(normal[0].numpy(), [0.0, 1.0, 0.0])
    np.testing.assert_allclose(sep[0].numpy(), [-0.01] * 4, atol=1e-6)
    np.testing.assert_allclose(point_b[0, :, 1].numpy(), [-0.01] * 4, atol=1e-6)  # on the cone
    np.testing.assert_allclose(point_a[0, :, 1].numpy(), [0.0] * 4, atol=1e-6)    # on the plane
    assert len(set(fid[0].tolist())) == 4


def test_convex_wrappers_refuse_unknown_kinds_and_devices():
    one = torch.zeros((1, 3))
    q = torch.tensor([[0.0, 0.0, 0.0, 1.0]])
    with pytest.raises(ValueError):
        km.convex_manifold(len(km.GENERIC_PAIRS), one, q, one, one, q, one)
    with pytest.raises(ValueError):
        km.plane_patch_manifold(len(km.PLANE_SHAPES), one, q, one, one, q, one)
    meta = [x.to("meta") for x in (one, q, one, one, q, one)]
    with pytest.raises(RuntimeError):
        km.convex_manifold(0, *meta)
    with pytest.raises(RuntimeError):
        km.plane_patch_manifold(0, *meta)
