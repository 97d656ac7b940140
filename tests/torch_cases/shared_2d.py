"""2D worlds and checks that the CPU cases, the card cases and
``chip_smoke.py`` share; imports neither JAX nor the JAX package.

- The worlds of the five 2D joint examples (``examples/chain_2d.py``,
  ``revolute_joint_2d.py``, ``distance_joint_2d.py``, ``fixed_joint_2d.py``,
  ``prismatic_joint_2d.py``) for either package's ``SceneBuilder2D``, with
  each example's config, step count and own checks: ``add`` puts an
  example's bodies into a builder shifted by ``(ox, oy)``; ``world`` builds
  it alone with the example's capacities.
- ``inside_polygons``: which points lie inside a polygon collider's core.
- ``all_in_overflow`` and ``joint_substep``: Kernel AA's checks against its
  twins.
"""

import math

import numpy as np
import torch

from avian_tpu_torch.core.types import BodyType, JointType
from avian_tpu_torch.dim2 import broadphase as bp2
from avian_tpu_torch.kernels import solve_joints_2d as kaa

N_LINKS, LINK = 8, 0.5


def _chain(b, ox, oy):
    anchor = b.add_body(body_type=BodyType.STATIC, pos=(ox, oy + 5.0))
    prev, ids = anchor, [anchor]
    for k in range(N_LINKS):
        body = b.add_body(pos=(ox + (k + 1) * LINK, oy + 5.0))
        b.capsule(body, 0.08, LINK - 0.2)
        ids.append(body)
        b.add_joint(JointType.REVOLUTE, prev, body,
                    anchor_a=(0.0, 0.0) if prev == anchor else (LINK / 2, 0.0),
                    anchor_b=(-LINK / 2, 0.0), ang_damping=1.0, lin_damping=1.0)
        prev = body
    return ids


def _revolute(b, ox, oy):
    anchor = b.add_body(body_type=BodyType.STATIC, pos=(ox, oy + 3.0))
    bob = b.add_body(pos=(ox + 1.2, oy + 3.0))
    b.box(bob, 0.5, 0.1)
    b.add_joint(JointType.REVOLUTE, anchor, bob, anchor_a=(0, 0), anchor_b=(-1.2, 0),
                ang_damping=2.0, lin_damping=2.0)
    return [anchor, bob]


def _distance(b, ox, oy):
    anchor = b.add_body(body_type=BodyType.STATIC, pos=(ox, oy + 4.0))
    ball = b.add_body(pos=(ox + 0.3, oy + 3.5))
    b.circle(ball, 0.2)
    b.add_joint(JointType.DISTANCE, anchor, ball, limit_min=1.5, limit_max=2.0, lin_damping=1.0)
    return [anchor, ball]


def _fixed(b, ox, oy):
    post = b.add_body(body_type=BodyType.STATIC, pos=(ox, oy + 2.0))
    bar = b.add_body(pos=(ox + 1.0, oy + 2.0))
    b.box(bar, 0.5, 0.1)
    b.add_joint(JointType.FIXED, post, bar, anchor_a=(0.5, 0), anchor_b=(-0.5, 0))
    return [post, bar]


def _prismatic(b, ox, oy):
    rail = b.add_body(body_type=BodyType.STATIC, pos=(ox, oy + 3.0))
    block = b.add_body(pos=(ox, oy + 2.0))
    b.box(block, 0.3, 0.3)
    b.add_joint(JointType.PRISMATIC, rail, block, axis_angle=math.pi / 2, limit_enabled=True,
                limit_min=-2.5, limit_max=0.0)
    return [rail, block]


def _check_chain(pos, angle, ids):
    pts = [np.asarray([0.0, 5.0])] + [pos[k] for k in ids[1:]]
    gaps = [float(np.linalg.norm(c - a)) for a, c in zip(pts[:-1], pts[1:])]
    assert max(gaps) < LINK * 1.15, f"chain stretched: {max(gaps)}"
    assert pos[ids[-1]][1] < 5.0 - 0.6 * N_LINKS * LINK, f"chain did not hang: {pos[ids[-1]]}"


def _check_revolute(pos, angle, ids):
    p = pos[ids[1]] - [0.0, 3.0]
    arm = float(np.linalg.norm(p))
    assert abs(arm - 1.2) < 0.03, f"hinge arm drifted: {arm}"
    assert p[1] < -1.0, f"damped pendulum should hang down: {p}"


def _check_distance(pos, angle, ids):
    d = float(np.linalg.norm(pos[ids[1]] - [0.0, 4.0]))
    assert 1.45 < d < 2.05, f"distance band violated: {d}"


def _check_fixed(pos, angle, ids):
    p = pos[ids[1]]
    assert abs(p[0] - 1.0) < 0.05 and abs(p[1] - 2.0) < 0.05, f"weld moved: {p}"
    assert abs(float(angle[ids[1]])) < 0.05, f"weld rotated: {angle[ids[1]]}"


def _check_prismatic(pos, angle, ids):
    p = pos[ids[1]]
    assert abs(p[0]) < 0.02, f"slider drifted off the rail: {p}"
    assert -3.0 < p[1] - 3.0 < -2.3, f"should rest at the lower limit: {p}"


# name: (add, the example's config, its steps, its capacities, its check)
EXAMPLES = {
    "chain_2d": (_chain, dict(max_colors=8), 500,
                 dict(max_bodies=N_LINKS + 1, max_colliders=N_LINKS, max_contacts=8 * N_LINKS,
                      max_joints=N_LINKS), _check_chain),
    "revolute_joint_2d": (_revolute, dict(max_colors=4), 400, None, _check_revolute),
    "distance_joint_2d": (_distance, dict(max_colors=4), 300, None, _check_distance),
    "fixed_joint_2d": (_fixed, dict(max_colors=4), 200, None, _check_fixed),
    "prismatic_joint_2d": (_prismatic, dict(max_colors=4), 300, None, _check_prismatic),
}
_PAIR_CAPACITIES = dict(max_bodies=2, max_colliders=2, max_contacts=8, max_joints=1)


def add(name, b, ox=0.0, oy=0.0):
    """Add example ``name``'s bodies and joints to ``b``, shifted by (ox, oy);
    returns their ids."""
    return EXAMPLES[name][0](b, ox, oy)


def world(name, b, **finalize_kw):
    """``(world, ids)``: example ``name``'s world alone, with its capacities."""
    ids = add(name, b)
    return b.finalize(**(EXAMPLES[name][3] or _PAIR_CAPACITIES), **finalize_kw), ids


def check(name, pos, angle, ids):
    """Example ``name``'s own assertions on numpy poses of its world."""
    EXAMPLES[name][4](np.asarray(pos), np.asarray(angle), ids)


def inside_polygons(points, world):
    """bool[P]: whether each point lies inside the core of a polygon collider
    of three or more vertices (its rounding aside)."""
    col = world.colliders
    poses = bp2.collider_poses(world)
    poly = col.active & ~col.is_plane & (col.vert_count >= 3)
    rel = points[:, None, :] - poses.pos[None, :, :]
    c, s = poses.cs[None, :, 0], poses.cs[None, :, 1]
    local = torch.stack([c * rel[..., 0] + s * rel[..., 1], -s * rel[..., 0] + c * rel[..., 1]],
                        -1)
    v = col.poly_verts
    lanes = torch.arange(v.shape[1], device=v.device)[None, :]
    nxt = torch.where(lanes + 1 < col.vert_count[:, None], lanes + 1, 0)
    e = torch.gather(v, 1, nxt[..., None].expand(-1, -1, 2)) - v
    d = (e[None, ..., 1] * (local[:, :, None, 0] - v[None, ..., 0])
         - e[None, ..., 0] * (local[:, :, None, 1] - v[None, ..., 1]))
    inside = torch.where(lanes[None] < col.vert_count[None, :, None], d < 0.0, True).all(-1)
    return (inside & poly[None]).any(1)


def all_in_overflow(jc, colors, n_bodies):
    """The joint constraints ``jc`` with every solved joint in the overflow
    colour (the last of ``colors``), so that a row's joints share its boxes
    there: hinge rows are paths, which 2 colours colour properly."""
    on = jc.mask > 0
    last = torch.full_like(jc.color, colors - 1)
    order, key = kaa.entry_order_2d(jc.body_a, jc.body_b, jc.data, on, n_bodies)
    return jc.replace(color=last, color_j=torch.where(on, last, -1).to(torch.int32),
                      ovf_order=order, ovf_key=key)


def joint_substep(jc, colors, h, twin, state, lam):
    """Kernel AA (or its twins) through every joint colour and the
    velocities of one substep, on ``state`` and ``lam`` in place."""
    pre = state[:, 3:6].clone()
    for c in range(colors):
        if twin:
            kaa.joint_color_2d_twin(c, state, jc.data, lam, jc.jtype, jc.body_a, jc.body_b,
                                    jc.color, jc.mask, h * h)
        else:
            kaa.joint_color_2d(c, c == colors - 1, state, jc.data, lam, jc.jtype, jc.body_a,
                               jc.body_b, jc.color, jc.mask, jc.ovf_order, jc.ovf_key, h * h)
    if twin:
        kaa.joint_velocities_2d_twin(state, pre, jc.data, jc.body_a, jc.body_b, jc.mask, h)
    else:
        kaa.joint_velocities_2d(state, pre, jc.data, jc.body_a, jc.body_b, jc.mask,
                                jc.damp_order, jc.damp_key, h)
    return state, lam
