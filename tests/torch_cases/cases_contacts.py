"""Kernel F's plain version (the narrowphase stage after the manifolds:
pair-key join, keep predicate, point compaction, anchors, contact ids,
warm-start matching, materials, eviction) against the JAX reference's
``narrow_phase``, on a settled pile and a settled base-6 pyramid over two
consecutive steps. Between the steps one box is moved, so that its pairs are
evicted and new pairs are minted among carried ones. Integer and boolean
columns exactly; floats within 1e-5, per point through the feature id. The
two rounding ties of the reference's manifold reduction are accepted as in
``cases_box_manifold.py``: an edge/edge point between parallel edges may
slide along the edge."""

import jax
import numpy as np
import pytest
import torch

from avian_tpu.pipeline import broadphase as jbp
from avian_tpu.pipeline import contacts as jcontacts
from avian_tpu_torch.kernels import box_manifold as ka
from avian_tpu_torch.kernels import contact_rows as kf
from avian_tpu_torch.pipeline import broadphase as tbp
from avian_tpu_torch.pipeline import contacts as tcontacts

from port_common import (assert_columns, pile_configs, settled_pile, settled_pyramid,
                         t_step, to_jax, to_torch)

TOL = 1e-5
POINT_COLUMNS = ("anchor_a", "anchor_b", "penetration", "feature_id", "normal_impulse",
                 "tangent_impulse", "max_normal_impulse")


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


_J_AABBS = jax.jit(jbp.update_aabbs, static_argnums=1)
_J_BROAD = jax.jit(jbp.broad_phase, static_argnums=1)
_J_NARROW = jax.jit(jcontacts.narrow_phase, static_argnums=2)


def _both_narrow_phases(tw, template):
    """(reference contacts, port contacts, bucket sizes by shape pair, the JAX
    world with this step's AABBs) for the next step of ``tw``."""
    jcfg, tcfg = pile_configs()
    jw2 = _J_AABBS(to_jax(tw, template), jcfg)
    ref = _J_NARROW(jw2, _J_BROAD(jw2, jcfg), jcfg)
    tw2 = to_torch(jw2)
    poses = tbp.update_aabbs_and_poses(tw2, tcfg)[1:]
    port, sizes = tcontacts.narrow_phase(tw2, tbp.broad_phase(tw2, tcfg), tcfg, poses)
    return ref, port, sizes, jw2


def _move_last_box_beside_the_bottom_row(tw):
    """Teleport the last box to the ground beside the rightmost box of the
    bottom row: its old pairs end, new ones start."""
    pos = tw.bodies.pos.clone()
    bottom = pos[1:, 1] < 0.75
    x_max = float(pos[1:, 0][bottom].max())
    z_at = float(pos[1:, 2][bottom][torch.argmax(pos[1:, 0][bottom])])
    pos[-1] = torch.tensor([x_max + 1.0005, 0.5005, z_at])
    quat = tw.bodies.quat.clone()
    quat[-1] = torch.tensor([0.0, 0.0, 0.0, 1.0])
    zero = torch.zeros(3)
    lin, ang = tw.bodies.lin_vel.clone(), tw.bodies.ang_vel.clone()
    lin[-1], ang[-1] = zero, zero
    return tw.replace(bodies=tw.bodies.replace(pos=pos, quat=quat, lin_vel=lin, ang_vel=ang))


@pytest.mark.parametrize("scene", ["pile", "pyramid"])
def test_narrow_phase_matches_reference_over_two_steps(scene):
    tw, template = settled_pile() if scene == "pile" else settled_pyramid()
    _, tcfg = pile_configs()
    ref, port, sizes, jw2 = _both_narrow_phases(tw, template)
    assert_columns(ref, port, atol=TOL, skip=POINT_COLUMNS)
    assert _contact_points_match(ref, port, np.asarray(jw2.bodies.quat)) <= 4
    n_boxes = tw.bodies.capacity - 1
    assert int(np.asarray(ref.touching).sum()) > n_boxes
    assert np.asarray(ref.was_touching).sum() > 0  # the join carried pairs
    assert not np.asarray(ref.evicted).any()
    assert sizes[(2, 2)] > 0 and sizes[(2, 3)] > 0  # box/box and box/plane (Kernel A)

    # The next step, with one box moved between the two.
    tw = _move_last_box_beside_the_bottom_row(t_step(tw, tcfg))
    ref2, port2, _, jw2 = _both_narrow_phases(tw, template)
    assert_columns(ref2, port2, atol=TOL, skip=POINT_COLUMNS)
    assert _contact_points_match(ref2, port2, np.asarray(jw2.bodies.quat)) <= 4
    assert np.asarray(ref2.evicted).sum() >= 2          # the moved box's old pairs ended
    assert int(ref2.next_contact_id) > int(ref.next_contact_id)  # and new ones began
    assert np.asarray(ref2.was_touching).sum() > n_boxes  # among carried ones
    warm = np.asarray(ref2.normal_impulse)
    assert (warm > 0).sum() > n_boxes                    # impulses were carried


def test_equally_good_old_points_give_the_first():
    """Two old points equally far from a new point, no feature id in common:
    the first old point's impulse is taken, in the reference (``jnp.argmax``)
    and in the port (``first_argmax``; ``torch.argmax`` does not promise it)."""
    tw, template = settled_pyramid()
    _, port, _, _ = _both_narrow_phases(tw, template)
    slot = int(torch.nonzero(port.touching & (port.num_points >= 2))[0, 0])
    old = tw.contacts
    row = int(torch.nonzero(old.pair_key == port.pair_key[slot])[0, 0])
    anchor = old.anchor_a.clone()
    shift = torch.tensor([0.03125, 0.0, 0.0])
    anchor[row, 0] = port.anchor_a[slot, 0] + shift
    anchor[row, 1] = port.anchor_a[slot, 0] - shift
    anchor[row, 2:] = 100.0
    nimp = old.normal_impulse.clone()
    nimp[row] = torch.tensor([7.0, 9.0, 11.0, 13.0])
    tw = tw.replace(contacts=old.replace(
        anchor_a=anchor, normal_impulse=nimp,
        feature_id=old.feature_id.index_fill(0, torch.tensor([row]), 999),
        num_points=old.num_points.index_fill(0, torch.tensor([row]), 4),
    ))
    ref, port, _, _ = _both_narrow_phases(tw, template)
    d = (port.anchor_a[slot, 0] - anchor[row, :2]).square().sum(-1)
    assert float(d[0]) == float(d[1]) < 0.01  # an exact tie within the match distance
    assert float(port.normal_impulse[slot, 0]) == 7.0
    assert float(np.asarray(ref.normal_impulse)[slot, 0]) == 7.0


def test_first_argmax_breaks_ties_toward_the_first():
    inf = float("inf")
    score = torch.tensor([[-1.0, -1.0, -2.0, -inf], [-inf, -inf, -inf, -inf],
                          [-3.0, -inf, -0.5, -0.5]])
    assert kf.first_argmax(score).tolist() == [0, 0, 2]


@pytest.mark.parametrize("fn", ["contact_join", "contact_rows"])
def test_wrappers_refuse_other_devices(fn):
    tw, _ = settled_pyramid(steps=1)
    tw = tw.to("meta")
    c = tw.contacts.capacity
    with pytest.raises(RuntimeError):
        if fn == "contact_join":
            z = torch.zeros((2 * c,), dtype=torch.int64, device="meta")
            kf.contact_join(z, z, c)
        else:
            kf.contact_rows(tw.bodies, tw.colliders, tw.contacts, *([None] * 7),
                            tcontacts.row_params(pile_configs()[1]))
