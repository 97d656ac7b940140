"""Box/box and box/plane manifolds (Kernel A's twin on CPU) and the
narrowphase stage against the JAX reference. Counts and per-pair feature-id
sets must match exactly; geometry within 1e-5, compared point by point
through the feature id (rounding may reorder near-tied box/plane corners)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avian_tpu.geometry import box_box as jbb
from avian_tpu.geometry import narrowphase as jnp_geo
from avian_tpu.pipeline import broadphase as jbp
from avian_tpu.pipeline import contacts as jcontacts
from avian_tpu_torch.geometry.narrowphase import compute_manifolds
from avian_tpu_torch.kernels import box_manifold as ka
from avian_tpu_torch.pipeline import broadphase as tbp
from avian_tpu_torch.pipeline import contacts as tcontacts

from port_common import assert_columns, pile_configs, settled_pile, to_jax, to_torch

TOL = 1e-5
_J_BOX_BOX = jax.jit(jax.vmap(jbb.box_box))
_J_BOX_PLANE = jax.jit(jax.vmap(jnp_geo.box_plane))


def _quats(rng, k, scale):
    q = rng.normal(size=(k, 4)).astype(np.float32) * np.float32(scale)
    q[:, 3] += 1.0
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _box_pairs(seed, k=192):
    """Random box pairs, about half resting face to face, all from numpy."""
    rng = np.random.default_rng(seed)
    ha = rng.uniform(0.2, 0.8, size=(k, 3)).astype(np.float32)
    hb = rng.uniform(0.2, 0.8, size=(k, 3)).astype(np.float32)
    pa = rng.uniform(-2, 2, size=(k, 3)).astype(np.float32)
    qa = _quats(rng, k, 0.6)
    qb = _quats(rng, k, 0.6)
    direction = rng.normal(size=(k, 3)).astype(np.float32)
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    reach = (np.linalg.norm(ha, axis=1) + np.linalg.norm(hb, axis=1)) * 0.6
    pb = pa + direction * reach[:, None] * rng.uniform(0.5, 1.1, size=(k, 1)).astype(np.float32)
    # Resting stacks: B on A along A's local y, nearly aligned.
    rest = np.arange(k) % 2 == 0
    qb[rest] = qa[rest]
    qb[rest] = _perturb(qb[rest], rng)
    up = np.stack([np.zeros(rest.sum()), ha[rest, 1] + hb[rest, 1] - 0.01, np.zeros(rest.sum())], -1)
    up = _rotate_np(qa[rest], up.astype(np.float32))
    pb[rest] = pa[rest] + up + rng.uniform(-0.2, 0.2, size=(rest.sum(), 3)).astype(np.float32) * np.asarray([1, 0, 1], np.float32)
    return pa, qa, ha, pb.astype(np.float32), qb, hb


def _perturb(q, rng):
    d = _quats(rng, q.shape[0], 0.02)
    x1, y1, z1, w1 = d.T
    x2, y2, z2, w2 = q.T
    out = np.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], -1)
    return (out / np.linalg.norm(out, axis=1, keepdims=True)).astype(np.float32)


def _rotate_np(q, v):
    u, w = q[:, :3], q[:, 3:4]
    t = 2.0 * np.cross(u, v)
    return (v + w * t + np.cross(u, t)).astype(np.float32)


def _pad8(h):
    return np.concatenate([h, np.zeros((h.shape[0], 5), np.float32)], 1)


def _distance_to_line(p0, p1, q):
    e = p1 - p0
    return np.linalg.norm(np.cross(e, q - p0)) / max(np.linalg.norm(e), 1e-12)


def assert_manifolds_match(ref, port):
    """ref/port: (normal, point_a, point_b, separation, feature_id, count).

    The reference reduces a clipped polygon to 4 points by (1) the deepest,
    (2) the farthest from it, (3, 4) the largest signed distances from that
    first edge. Where two polygon vertices are equally far from the edge
    (parallel clipped edges), rounding decides which one is kept; such a
    pair may keep different vertices, and is accepted only if the two picks
    are equally far from the shared first edge. Returns the number of such
    ties."""
    r = [np.asarray(x) for x in ref]
    p = [x.numpy() for x in port]
    np.testing.assert_array_equal(p[5], r[5], err_msg="count")
    ties = 0
    for i in range(r[5].shape[0]):
        c = int(r[5][i])
        if c == 0:
            continue
        # A dropped duplicate may sit before a kept point: valid points are
        # the slots with a finite separation, ``count`` of them.
        rk = [k for k in range(4) if r[3][i, k] < 1e8]
        pk = [k for k in range(4) if p[3][i, k] < 1e8]
        assert len(rk) == c and len(pk) == c, (i, rk, pk)
        rf = {int(r[4][i, k]): k for k in rk}
        pf = {int(p[4][i, k]): k for k in pk}
        np.testing.assert_allclose(p[0][i], r[0][i], atol=TOL, rtol=0)
        common = sorted(set(rf) & set(pf))
        if len(common) != c:
            ties += 1
            assert len(common) == c - 1 and c >= 3, (i, rf, pf)
            assert r[4][i, 0] == p[4][i, 0] and r[4][i, 1] == p[4][i, 1], (i, rf, pf)
            q_ref = r[1][i, [k for f, k in rf.items() if f not in common][0]]
            q_port = p[1][i, [k for f, k in pf.items() if f not in common][0]]
            d_ref = _distance_to_line(r[1][i, 0], r[1][i, 1], q_ref)
            d_port = _distance_to_line(p[1][i, 0], p[1][i, 1], q_port)
            assert abs(d_ref - d_port) <= TOL, (i, d_ref, d_port)
        for k in (1, 2, 3):
            rv = np.stack([r[k][i, rf[f]] for f in common])
            pv = np.stack([p[k][i, pf[f]] for f in common])
            np.testing.assert_allclose(pv, rv, atol=TOL, rtol=0)
    return ties


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_box_box_matches_reference(seed):
    pa, qa, ha, pb, qb, hb = _box_pairs(seed)
    m = _J_BOX_BOX(pa, qa, _pad8(ha), pb, qb, _pad8(hb))
    ref = (m.normal, m.point_a, m.point_b, m.separation, m.feature_id, m.count)
    t = [torch.from_numpy(x) for x in (pa, qa, ha, pb, qb, hb)]
    port = ka.box_manifold(ka.BOX_BOX, *t)
    ties = assert_manifolds_match(ref, port)
    assert ties <= 20  # each one checked as a tie above
    counts = np.asarray(m.count)
    assert (counts == 4).sum() > 20 and (counts == 1).sum() > 0  # faces and edges


@pytest.mark.parametrize("seed", [0, 1])
def test_box_plane_matches_reference(seed):
    rng = np.random.default_rng(seed)
    k = 128
    ha = rng.uniform(0.2, 0.8, size=(k, 3)).astype(np.float32)
    pa = rng.uniform(-1, 1, size=(k, 3)).astype(np.float32)
    qa = _quats(rng, k, 0.5)
    qa[: k // 2] = _perturb(np.tile([[0, 0, 0, 1]], (k // 2, 1)).astype(np.float32), rng)
    pb = rng.uniform(-0.5, 0.5, size=(k, 3)).astype(np.float32)
    qb = _quats(rng, k, 0.1)
    nb = np.tile(np.asarray([[0.0, 1.0, 0.0]], np.float32), (k, 1))
    m = _J_BOX_PLANE(pa, qa, _pad8(ha), pb, qb, _pad8(nb))
    ref = (m.normal, m.point_a, m.point_b, m.separation, m.feature_id, m.count)
    t = [torch.from_numpy(x) for x in (pa, qa, ha, pb, qb, nb)]
    assert assert_manifolds_match(ref, ka.box_manifold(ka.BOX_PLANE, *t)) == 0


def test_flat_box_on_plane_breaks_ties_toward_lower_corner():
    one = lambda *v: torch.tensor([v], dtype=torch.float32)  # noqa: E731
    out = ka.box_manifold(
        ka.BOX_PLANE, one(0.0, 0.5, 0.0), one(0.0, 0.0, 0.0, 1.0),
        one(0.5, 0.5, 0.5), one(0.0, 0.0, 0.0), one(0.0, 0.0, 0.0, 1.0),
        one(0.0, 1.0, 0.0),
    )
    assert out[4].tolist() == [[0, 1, 4, 5]]  # the four y = -h corners, in order
    assert out[5].tolist() == [4]


def test_dispatch_swaps_plane_first_pairs():
    """A plane given as collider A: swapped in, solved, swapped back."""
    from avian_tpu_torch import scenes

    world, _ = scenes.cube_pile(8, max_contacts=64)
    col = world.colliders
    ca = torch.tensor([0, 3, 1], dtype=torch.int32)
    cb = torch.tensor([2, 0, 0], dtype=torch.int32)
    valid = torch.tensor([True, True, False])
    from avian_tpu_torch.pipeline.broadphase import update_collider_poses

    pos, quat = update_collider_poses(world)
    man, sizes = compute_manifolds(col.shape_type, col.params, pos, quat, ca, cb, valid)
    direct, _ = compute_manifolds(col.shape_type, col.params, pos, quat,
                                  cb[:1], ca[:1], valid[:1])
    assert torch.allclose(man.normal[0], -direct.normal[0])
    assert torch.equal(man.point_a[0], direct.point_b[0])
    assert torch.equal(man.feature_id[0], direct.feature_id[0])
    assert int(man.count[2]) == 0 and float(man.separation[2, 0]) == 1e9
    assert sizes == {ka.BOX_PLANE: 2}


def _contact_points_match(ref, port, body_quat):
    """Per-point contact columns, matched through the feature id.

    An edge/edge point (feature id 128 + 3 i + j) between parallel edges is
    the closest pair of two parallel segments: its place along the edge is
    ill-conditioned, and rounding may slide it there. Its anchors are held
    to the tolerance across the edge only; everything else, penetration
    included, to the full tolerance."""
    n = np.asarray(ref.num_points)
    np.testing.assert_array_equal(port.num_points.numpy(), n)
    rf, pf = np.asarray(ref.feature_id), port.feature_id.numpy()
    cols = ("anchor_a", "anchor_b", "penetration", "normal_impulse", "tangent_impulse")
    r = {c: np.asarray(getattr(ref, c)) for c in cols}
    p = {c: getattr(port, c).numpy() for c in cols}
    body_a = np.asarray(ref.body_a)
    slid = 0
    for i in np.nonzero(n)[0]:
        c = n[i]
        ro = np.argsort(rf[i, :c], kind="stable")
        po = np.argsort(pf[i, :c], kind="stable")
        fids = rf[i, :c][ro]
        np.testing.assert_array_equal(pf[i, :c][po], fids)
        for col in cols:
            rv, pv = r[col][i, :c][ro], p[col][i, :c][po]
            if col.startswith("anchor") and c == 1 and fids[0] >= 128:
                axis = np.eye(3, dtype=np.float32)[(fids[0] - 128) // 3]
                q = body_quat[body_a[i]]
                u, w = q[:3], q[3]
                t = 2.0 * np.cross(u, axis)
                edge = axis + w * t + np.cross(u, t)
                diff = pv[0] - rv[0]
                across = diff - np.dot(diff, edge) * edge
                slid += int(np.abs(diff).max() > TOL)
                assert np.abs(across).max() <= TOL, (i, col, diff, edge)
                continue
            np.testing.assert_allclose(pv, rv, atol=TOL, rtol=0)
    return slid


def test_narrow_phase_stage_matches_reference():
    """Manifolds, persistence join, warm-start carry, contact ids, colors
    and materials on a settled pile with a populated contact buffer."""
    tw, template = settled_pile()
    jw = to_jax(tw, template)
    jcfg, tcfg = pile_configs()
    jw2 = jax.jit(jbp.update_aabbs, static_argnums=1)(jw, jcfg)
    jbpr = jax.jit(jbp.broad_phase, static_argnums=1)(jw2, jcfg)
    ref = jax.jit(jcontacts.narrow_phase, static_argnums=2)(jw2, jbpr, jcfg)
    tw2 = to_torch(jw2)
    port, sizes = tcontacts.narrow_phase(tw2, tbp.broad_phase(tw2, tcfg), tcfg)
    assert_columns(ref, port, atol=TOL, skip=(
        "anchor_a", "anchor_b", "penetration", "feature_id", "normal_impulse",
        "tangent_impulse", "max_normal_impulse",
    ))
    assert _contact_points_match(ref, port, np.asarray(jw2.bodies.quat)) <= 4
    assert int(np.asarray(ref.touching).sum()) > 64
    assert np.asarray(ref.was_touching).sum() > 0  # the join carried pairs
    assert sizes[ka.BOX_BOX] > 0 and sizes[ka.BOX_PLANE] > 0
