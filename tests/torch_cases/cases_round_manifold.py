"""Kernel N's plain version (``geometry/narrowphase.py``: sphere/sphere,
sphere/capsule, sphere/box, sphere/plane, capsule/capsule, capsule/plane)
against the JAX reference's pair functions, jitted on the CPU: 128 pairs of
each, a quarter touching, a quarter overlapping, a quarter separated within
a speculative margin and a quarter degenerate (coincident centres, a centre
on the axis or inside the box, parallel capsules, a capsule lying on the
plane). Counts and feature ids exactly, normals, witnesses and separations
within 1e-5. The reference is compiled one IEEE operation at a time
(``port_common.ieee_reference``)."""

from port_common import ieee_reference

ieee_reference()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from avian_tpu.geometry import narrowphase as jgeo  # noqa: E402
from avian_tpu_torch.kernels import round_manifold as kn  # noqa: E402

from port_common import assert_manifolds_equal, pad8, quats, rotate_np  # noqa: E402

TOL = 1e-5
K = 128
_Y = np.asarray([0.0, 1.0, 0.0], np.float32)


def _unit(rng, k):
    d = rng.normal(size=(k, 3)).astype(np.float32)
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _perp(d, axis):
    """``d`` made orthogonal to the unit ``axis`` and normalized."""
    d = d - axis * np.sum(d * axis, axis=1, keepdims=True)
    return (d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-6)).astype(np.float32)


def _gaps(rng, k):
    """Surface gap per pair and its category (0 touching, 1 overlapping,
    2 separated within the margin, 3 degenerate)."""
    cat = np.arange(k) % 4
    gap = np.where(cat == 1, -rng.uniform(0.0, 0.2, k),
                   np.where(cat == 2, rng.uniform(0.0, 0.05, k), 0.0)).astype(np.float32)
    return gap, cat


def _pairs(kind, seed):
    """(pa, qa, prm_a [K, 3], pb, qb, prm_b [K, 3]) for ``kind``, from numpy."""
    rng = np.random.default_rng(seed)
    gap, cat = _gaps(rng, K)
    deg = cat == 3
    pa = rng.uniform(-1.0, 1.0, (K, 3)).astype(np.float32)
    qa, qb = quats(rng, K, 0.8), quats(rng, K, 0.8)
    r_a = rng.uniform(0.2, 0.6, K).astype(np.float32)
    r_b = rng.uniform(0.2, 0.6, K).astype(np.float32)
    h_a = rng.uniform(0.2, 0.7, K).astype(np.float32)
    h_b = rng.uniform(0.2, 0.7, K).astype(np.float32)
    d = _unit(rng, K)
    zero = np.zeros(K, np.float32)
    if kind == kn.SPHERE_SPHERE:
        pb = pa + d * (r_a + r_b + gap)[:, None]
        pb[deg] = pa[deg]
        return pa, qa, np.stack([r_a, zero, zero], 1), pb, qb, np.stack([r_b, zero, zero], 1)
    if kind == kn.SPHERE_CAPSULE:
        pb = rng.uniform(-1.0, 1.0, (K, 3)).astype(np.float32)
        axis = rotate_np(qb, np.tile(_Y, (K, 1)))
        c = pb + axis * rng.uniform(-0.9, 0.9, (K, 1)).astype(np.float32) * h_b[:, None]
        d = _perp(d, axis)
        pa = c + d * (r_a + r_b + gap)[:, None]
        pa[deg] = c[deg]
        return pa, qa, np.stack([r_a, zero, zero], 1), pb, qb, np.stack([h_b, r_b, zero], 1)
    if kind == kn.CAPSULE_CAPSULE:
        ax_a = rotate_np(qa, np.tile(_Y, (K, 1)))
        ax_b = rotate_np(qb, np.tile(_Y, (K, 1)))
        ca = pa + ax_a * rng.uniform(-0.9, 0.9, (K, 1)).astype(np.float32) * h_a[:, None]
        # Along the common perpendicular from an inner point of each axis.
        cb = ca + _perp(_perp(np.cross(ax_a, ax_b), ax_a), ax_b) * (r_a + r_b + gap)[:, None]
        pb = cb - ax_b * rng.uniform(-0.9, 0.9, (K, 1)).astype(np.float32) * h_b[:, None]
        # Degenerate: parallel (a third flipped end for end), side by side
        # with overlapping extents, or coincident.
        qb[deg] = qa[deg]
        flip = deg & (np.arange(K) % 12 == 3)
        qb[flip] = -qb[flip]
        perp = np.cross(ax_a, d)
        perp /= np.maximum(np.linalg.norm(perp, axis=1, keepdims=True), 1e-6)
        side = pa + perp * (r_a + r_b - 0.01)[:, None] + ax_a * 0.3 * h_a[:, None]
        pb[deg] = side[deg]
        same = deg & (np.arange(K) % 12 == 7)
        pb[same] = pa[same]
        return pa, qa, np.stack([h_a, r_a, zero], 1), pb, qb, np.stack([h_b, r_b, zero], 1)
    if kind == kn.SPHERE_BOX:
        pb = rng.uniform(-1.0, 1.0, (K, 3)).astype(np.float32)
        hb = rng.uniform(0.2, 0.7, (K, 3)).astype(np.float32)
        # A point on the box surface in its frame, pushed out along the face.
        local = rng.uniform(-1.0, 1.0, (K, 3)).astype(np.float32) * hb
        ax = rng.integers(0, 3, K)
        sgn = np.where(rng.uniform(size=K) < 0.5, -1.0, 1.0).astype(np.float32)
        local[np.arange(K), ax] = sgn * hb[np.arange(K), ax]
        out = np.zeros((K, 3), np.float32)
        out[np.arange(K), ax] = sgn * (r_a + gap)
        pa = pb + rotate_np(qb, local + out)
        # Degenerate: the centre inside the box, a sixth exactly at its centre.
        inside = pb + rotate_np(qb, rng.uniform(-0.5, 0.5, (K, 3)).astype(np.float32) * hb)
        pa[deg] = inside[deg]
        centre = deg & (np.arange(K) % 24 == 3)
        pa[centre] = pb[centre]
        return pa, qa, np.stack([r_a, zero, zero], 1), pb, qb, hb
    n_b = np.tile(_Y, (K, 1))
    pb = rng.uniform(-0.5, 0.5, (K, 3)).astype(np.float32)
    qb = quats(rng, K, 0.1)
    n_w = rotate_np(qb, n_b)
    slide = rng.uniform(-1.0, 1.0, (K, 3)).astype(np.float32)
    slide -= n_w * np.sum(slide * n_w, axis=1, keepdims=True)
    if kind == kn.SPHERE_PLANE:
        pa = pb + slide + n_w * (r_a + np.where(deg, -r_a, gap))[:, None]
        return pa, qa, np.stack([r_a, zero, zero], 1), pb, qb, n_b
    assert kind == kn.CAPSULE_PLANE
    # Degenerate: lying flat, both ends at the same depth.
    lying = np.tile(np.asarray([[0.0, 0.0, np.sin(np.pi / 4), np.cos(np.pi / 4)]], np.float32),
                    (K, 1))
    qa[deg] = lying[deg]
    axis = rotate_np(qa, np.tile(_Y, (K, 1)))
    reach = np.abs(np.sum(axis * n_w, axis=1)) * h_a + r_a
    pa = pb + slide + n_w * (reach + gap)[:, None]
    return pa, qa, np.stack([h_a, r_a, zero], 1), pb, qb, n_b


_REFERENCE = {
    kind: jax.jit(jax.vmap(getattr(jgeo, name))) for kind, name in enumerate(kn.KINDS)
}


@pytest.mark.parametrize("kind", range(len(kn.KINDS)), ids=kn.KINDS)
def test_round_manifolds_match_reference(kind):
    pa, qa, prm_a, pb, qb, prm_b = _pairs(kind, seed=100 + kind)
    ref = _REFERENCE[kind](pa, qa, pad8(prm_a), pb, qb, pad8(prm_b))
    t = [torch.from_numpy(np.ascontiguousarray(x, np.float32))
         for x in (pa, qa, prm_a, pb, qb, prm_b)]
    port = kn.round_manifold(kind, *t)
    assert_manifolds_equal(ref, port, TOL)
    seps = np.asarray(ref.separation)[:, 0]
    assert (seps < -0.01).sum() > K // 8 and (seps > 0.0).sum() > K // 8  # both sides
    if kind in (kn.CAPSULE_CAPSULE, kn.CAPSULE_PLANE):
        assert (np.asarray(ref.count) == 2).sum() >= K // 8  # the 2-point cases ran


def test_round_manifold_refuses_unknown_kinds_and_devices():
    one = torch.zeros((1, 3))
    q = torch.tensor([[0.0, 0.0, 0.0, 1.0]])
    with pytest.raises(ValueError):
        kn.round_manifold(len(kn.KINDS), one, q, one, one, q, one)
    with pytest.raises(RuntimeError):
        kn.round_manifold(0, *(x.to("meta") for x in (one, q, one, one, q, one)))
