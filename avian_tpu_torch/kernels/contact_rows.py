"""Kernel F, ``contact_rows``: contact persistence after the manifolds.

Replaces the body of ``avian_tpu/pipeline/contacts.py::narrow_phase`` (:54):
the join of old and new pair keys (:133-187), the speculative keep
predicate with in-row point compaction, COM-relative anchors, contact ids,
carried colours, warm-start matching by feature id or anchor distance
(:203-235), the material combine rules and the eviction columns (:256-275).
The stable sort of ``[old keys ++ new keys]`` and the ``cumsum`` that mints
new contact ids stay torch calls between the two launches, as the reference
calls ``lax.sort`` and ``jnp.cumsum`` there.

- ``contact_join``: one thread per sorted entry compares with its left and
  right neighbour and writes ``hit`` (the old slot + 1 that a new pair
  continues, 0 for none) and ``survives`` (an old row that a new pair took
  over). Every slot is written by exactly one thread: no atomics.
- ``contact_rows``: one thread per pair slot does everything else in
  registers.

On the H100 the rows launch is bound by bytes (a row reads about 300 and
writes about 250, with gathers of two colliders, two bodies and one old
row); the plain version makes some 150 elementwise, gather and ``argsort``
launches and writes every intermediate to device memory. Among old points
that match equally well the first wins, as ``jnp.argmax`` picks; the plain
version spells that rule out, since the tie index of ``torch.argmax`` is not
promised, and a resting stack has many exactly equal anchors.

The plain PyTorch versions, ``contact_join_twin`` and ``contact_rows_twin``,
run on CPU tensors; on a CUDA tensor the wrappers launch the kernel or raise.
"""

from typing import NamedTuple

import torch

from avian_tpu_torch.core import types
from avian_tpu_torch.core.state import MAX_POINTS
from avian_tpu_torch.math import quat as quat_m
from avian_tpu_torch.math import vec


class RowParams(NamedTuple):
    dt: float
    spec_default: float     # cap on the colliders' speculative margins
    tolerance: float        # contact tolerance in length units
    match_distance2: float  # squared warm-start match distance
    match_contacts: bool


# Columns of ``Contacts`` that ``contact_rows`` returns, in the kernel's order.
ROW_COLUMNS = (
    "body_a", "body_b", "touching", "was_touching", "is_sensor", "num_points",
    "anchor_a", "anchor_b", "penetration", "feature_id", "normal_impulse",
    "tangent_impulse", "friction", "static_friction", "restitution", "color",
    "contact_id", "evicted", "evicted_contact_id", "evicted_body_a", "evicted_body_b",
)


def _shift_right(x, fill):
    """[fill, x[0], ..., x[-2]]"""
    return torch.cat([torch.full((1,), fill, dtype=x.dtype, device=x.device), x[:-1]])


def _shift_left(x, fill):
    """[x[1], ..., x[-1], fill]"""
    return torch.cat([x[1:], torch.full((1,), fill, dtype=x.dtype, device=x.device)])


def contact_join_twin(ks, s, c_cap):
    """Plain PyTorch version; see ``contact_join``."""
    dev = ks.device
    key_ok = ks >= 0
    same_prev = torch.cat(
        [torch.zeros((1,), dtype=torch.bool, device=dev), ks[1:] == ks[:-1]]
    )
    tag_s = s >= c_cap
    src_s = torch.where(tag_s, s - c_cap, s)
    prev_old = _shift_right(~tag_s, False)
    m_new = tag_s & same_prev & prev_old & key_ok
    prev_src = _shift_right(src_s, 0)
    hit = torch.zeros((c_cap + 1,), dtype=torch.int64, device=dev)
    hit[torch.where(tag_s, src_s, c_cap)] = torch.where(m_new, prev_src + 1, 0)

    next_same = _shift_left(same_prev, False)
    next_new = _shift_left(tag_s, False)
    m_old_survives = ~tag_s & next_same & next_new & key_ok
    survives = torch.zeros((c_cap + 1,), dtype=torch.bool, device=dev)
    survives[torch.where(~tag_s, src_s, c_cap)] = m_old_survives
    return hit[:c_cap].to(torch.int32), survives[:c_cap]


def contact_join(ks, s, c_cap):
    """Join old and new pairs on their keys.

    ``ks`` i64[2C] is ``[old keys ++ new keys]`` stably sorted, ``s`` i64[2C]
    the sort's permutation (entries ``>= C`` are new pairs). Returns ``hit``
    i32[C], per new slot the old slot + 1 with the same key (0 = none), and
    ``survives`` bool[C], per old slot whether a new pair has its key."""
    if ks.device.type == "cpu":
        return contact_join_twin(ks, s, c_cap)
    if ks.device.type != "cuda":
        raise RuntimeError(f"contact_join: unsupported device {ks.device}")
    from avian_tpu_torch.kernels import build

    dev = ks.device
    build.require("contact_join", dev, (
        ("ks", ks, (2 * c_cap,), torch.int64), ("s", s, (2 * c_cap,), torch.int64),
    ))
    hit = torch.empty((c_cap,), dtype=torch.int32, device=dev)
    survives = torch.empty((c_cap,), dtype=torch.bool, device=dev)
    if c_cap == 0:
        return hit, survives
    build.launch("avian_contact_join", dev, c_cap, ks, s, hit, survives)
    contact_join.launches += 1
    return hit, survives


contact_join.launches = 0


def _combine(val_a, val_b, rule_a, rule_b):
    """CoefficientCombine; the higher-priority rule wins."""
    rule = torch.maximum(rule_a, rule_b)
    out = 0.5 * (val_a + val_b)
    C = types.CoefficientCombine
    out = torch.where(rule == C.GEOMETRIC_MEAN, torch.sqrt(torch.clamp(val_a * val_b, min=0.0)), out)
    out = torch.where(rule == C.MIN, torch.minimum(val_a, val_b), out)
    out = torch.where(rule == C.MULTIPLY, val_a * val_b, out)
    return torch.where(rule == C.MAX, torch.maximum(val_a, val_b), out)


def first_argmax(score):
    """Index of the largest entry along the last axis; among equal entries
    the first, as ``jnp.argmax`` promises and ``torch.argmax`` does not."""
    lanes = torch.arange(score.shape[-1], device=score.device)
    is_max = score == score.amax(dim=-1, keepdim=True)
    return torch.where(is_max, lanes, score.shape[-1] - 1).amin(dim=-1)


def contact_rows_twin(bodies, col, old, valid, ca, cb, man, hit, survives, new_id,
                      p: RowParams):
    """Plain PyTorch version; see ``contact_rows``."""
    b = bodies
    dev = col.params.device
    ca, cb = ca.long(), cb.long()
    ba = col.body_idx[ca]
    bb = col.body_idx[cb]
    bal, bbl = ba.long(), bb.long()

    # ---- effective speculative margin (reference :88-106) ---------------
    def clamped_vel(body_idx, collider_idx):
        v = b.lin_vel[body_idx]
        spec = torch.clamp(col.speculative_margin[collider_idx], max=p.spec_default)
        speed = vec.length(v)
        scale = torch.clamp(spec / torch.clamp(speed * p.dt, min=1e-9), max=1.0)
        return v * scale[:, None]

    v_rel = clamped_vel(bbl, cb) - clamped_vel(bal, ca)
    margin = p.dt * vec.length(v_rel)
    keep_dist = (
        torch.clamp(margin, min=p.tolerance)
        + col.collision_margin[ca]
        + col.collision_margin[cb]
    )

    lanes = torch.arange(MAX_POINTS, device=dev)[None, :]
    point_valid = (
        (man.separation < keep_dist[:, None])
        & (lanes < man.count[:, None])
        & valid[:, None]
    )
    order = torch.argsort((~point_valid).to(torch.int8), dim=1, stable=True)
    sep = man.separation.gather(1, order)
    fid = man.feature_id.gather(1, order)
    o3 = order[..., None].expand(-1, -1, 3)
    p_a = man.point_a.gather(1, o3)
    p_b = man.point_b.gather(1, o3)
    num_points = point_valid.sum(dim=1).to(torch.int32)
    touching = (num_points > 0) & valid

    com_a = b.pos[bal] + quat_m.rotate(b.quat[bal], b.com[bal])
    com_b = b.pos[bbl] + quat_m.rotate(b.quat[bbl], b.com[bbl])
    anchor_a = p_a - com_a[:, None, :]
    anchor_b = p_b - com_b[:, None, :]

    # ---- what the join carries over --------------------------------------
    matched = hit > 0
    old_slot = torch.clamp(hit.long() - 1, min=0)
    was_touching = matched & old.touching[old_slot]
    carried_color = torch.where(matched, old.color[old_slot], -1)
    is_new = valid & ~matched
    contact_id = torch.where(
        matched,
        old.contact_id[old_slot],
        torch.where(is_new, new_id, 0),
    ).to(torch.int32)

    # ---- per-point warm-start matching (reference :203-235) -------------
    old_fid = old.feature_id[old_slot]
    old_anchor = old.anchor_a[old_slot]
    old_np = old.normal_impulse[old_slot]
    old_tp = old.tangent_impulse[old_slot]
    old_valid = (lanes < old.num_points[old_slot][:, None]) & matched[:, None]
    fid_match = (fid[:, :, None] == old_fid[:, None, :]) & old_valid[:, None, :]
    dd = anchor_a[:, :, None, :] - old_anchor[:, None, :, :]
    d2 = vec.dot(dd, dd)
    dist_match = (d2 < p.match_distance2) & old_valid[:, None, :]
    use_match = torch.where(fid_match.any(dim=-1, keepdim=True), fid_match, dist_match)
    score = torch.where(use_match, -d2, -float("inf"))
    best = first_argmax(score)
    has_match = use_match.any(dim=-1) & bool(p.match_contacts)
    warm_np = torch.where(has_match, old_np.gather(1, best), 0.0)
    warm_tp = torch.where(
        has_match[..., None],
        old_tp.gather(1, best[..., None].expand(-1, -1, 2)),
        0.0,
    )

    # ---- materials --------------------------------------------------------
    friction = _combine(
        col.friction[ca], col.friction[cb],
        col.friction_combine[ca], col.friction_combine[cb],
    )
    static_friction = _combine(
        col.static_friction[ca], col.static_friction[cb],
        col.friction_combine[ca], col.friction_combine[cb],
    )
    restitution = _combine(
        col.restitution[ca], col.restitution[cb],
        col.restitution_combine[ca], col.restitution_combine[cb],
    )

    # ---- CollisionEnd on eviction (reference :256-275) ------------------
    evicted = old.active & old.touching & ~survives
    return dict(
        body_a=ba, body_b=bb, touching=touching, was_touching=was_touching,
        is_sensor=col.is_sensor[ca] | col.is_sensor[cb], num_points=num_points,
        anchor_a=anchor_a, anchor_b=anchor_b, penetration=-sep, feature_id=fid,
        normal_impulse=warm_np, tangent_impulse=warm_tp, friction=friction,
        static_friction=static_friction, restitution=restitution,
        color=carried_color.to(torch.int32), contact_id=contact_id, evicted=evicted,
        evicted_contact_id=torch.where(evicted, old.contact_id, 0),
        evicted_body_a=torch.where(evicted, old.body_a, 0),
        evicted_body_b=torch.where(evicted, old.body_b, 0),
    )


def contact_rows(bodies, col, old, valid, ca, cb, man, hit, survives, new_id,
                 p: RowParams):
    """This step's contact rows, as a dict of the ``ROW_COLUMNS`` of
    ``Contacts``.

    ``bodies``, ``col``: the world's ``Bodies`` and ``Colliders``; ``old``:
    last step's ``Contacts``; ``valid`` bool[C], ``ca``/``cb`` i32[C]: the
    broadphase's pair slots; ``man``: their manifolds; ``hit``, ``survives``:
    from ``contact_join``; ``new_id`` i32[C]: the contact id of each new pair
    (its scene's next id plus its rank among the scene's new pairs), read
    where ``valid & hit == 0``."""
    dev = col.params.device
    if dev.type == "cpu":
        return contact_rows_twin(bodies, col, old, valid, ca, cb, man, hit, survives,
                                 new_id, p)
    if dev.type != "cuda":
        raise RuntimeError(f"contact_rows: unsupported device {dev}")
    from avian_tpu_torch.kernels import build

    c, m, n, k = old.capacity, col.capacity, bodies.capacity, MAX_POINTS
    f32, i32, u8 = torch.float32, torch.int32, torch.bool
    inputs = (
        ("valid", valid, (c,), u8), ("collider_a", ca, (c,), i32), ("collider_b", cb, (c,), i32),
        ("point_a", man.point_a, (c, k, 3), f32), ("point_b", man.point_b, (c, k, 3), f32),
        ("separation", man.separation, (c, k), f32),
        ("feature_id", man.feature_id, (c, k), i32), ("count", man.count, (c,), i32),
        ("body_idx", col.body_idx, (m,), i32),
        ("speculative_margin", col.speculative_margin, (m,), f32),
        ("collision_margin", col.collision_margin, (m,), f32),
        ("friction", col.friction, (m,), f32),
        ("static_friction", col.static_friction, (m,), f32),
        ("restitution", col.restitution, (m,), f32),
        ("friction_combine", col.friction_combine, (m,), i32),
        ("restitution_combine", col.restitution_combine, (m,), i32),
        ("is_sensor", col.is_sensor, (m,), u8),
        ("pos", bodies.pos, (n, 3), f32), ("quat", bodies.quat, (n, 4), f32),
        ("com", bodies.com, (n, 3), f32), ("lin_vel", bodies.lin_vel, (n, 3), f32),
        ("hit", hit, (c,), i32), ("survives", survives, (c,), u8),
        ("new_id", new_id, (c,), i32),
        ("old.active", old.active, (c,), u8), ("old.touching", old.touching, (c,), u8),
        ("old.color", old.color, (c,), i32), ("old.contact_id", old.contact_id, (c,), i32),
        ("old.feature_id", old.feature_id, (c, k), i32),
        ("old.anchor_a", old.anchor_a, (c, k, 3), f32),
        ("old.normal_impulse", old.normal_impulse, (c, k), f32),
        ("old.tangent_impulse", old.tangent_impulse, (c, k, 2), f32),
        ("old.num_points", old.num_points, (c,), i32),
        ("old.body_a", old.body_a, (c,), i32), ("old.body_b", old.body_b, (c,), i32),
    )
    build.require("contact_rows", dev, inputs)
    shapes = dict(
        anchor_a=((c, k, 3), f32), anchor_b=((c, k, 3), f32), penetration=((c, k), f32),
        feature_id=((c, k), i32), normal_impulse=((c, k), f32),
        tangent_impulse=((c, k, 2), f32), friction=((c,), f32),
        static_friction=((c,), f32), restitution=((c,), f32),
        touching=((c,), u8), was_touching=((c,), u8), is_sensor=((c,), u8),
        evicted=((c,), u8),
    )
    out = {}
    for name in ROW_COLUMNS:
        shape, dtype = shapes.get(name, ((c,), i32))
        out[name] = torch.empty(shape, dtype=dtype, device=dev)
    if c == 0:
        return out
    build.launch(
        "avian_contact_rows", dev, c, *(x for _, x, _, _ in inputs),
        float(p.dt), float(p.spec_default), float(p.tolerance), float(p.match_distance2),
        int(bool(p.match_contacts)), *(out[name] for name in ROW_COLUMNS),
    )
    contact_rows.launches += 1
    return out


contact_rows.launches = 0
