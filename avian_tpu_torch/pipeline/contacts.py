"""Narrowphase stage: manifolds, persistent pair matching and warm-start
carry (port of ``avian_tpu/pipeline/contacts.py::narrow_phase``).

Manifolds come from Kernel A through ``geometry.narrowphase``; the rest is
plain PyTorch: the speculative keep predicate, in-row point compaction,
the sort-merge persistence join over int64 pair keys, contact ids,
feature-id / anchor-distance warm-start matching, material combination and
eviction flags.
"""

import torch

from avian_tpu_torch.core import types
from avian_tpu_torch.core.config import PhysicsConfig
from avian_tpu_torch.core.state import MAX_POINTS, Contacts, World
from avian_tpu_torch.geometry.narrowphase import compute_manifolds
from avian_tpu_torch.math import quat as quat_m
from avian_tpu_torch.math import vec
from avian_tpu_torch.pipeline.broadphase import BroadPhaseResult, update_collider_poses


def _combine(val_a, val_b, rule_a, rule_b):
    """CoefficientCombine; the higher-priority rule wins."""
    rule = torch.maximum(rule_a, rule_b)
    avg = 0.5 * (val_a + val_b)
    out = avg
    C = types.CoefficientCombine
    out = torch.where(rule == C.GEOMETRIC_MEAN, torch.sqrt(torch.clamp(val_a * val_b, min=0.0)), out)
    out = torch.where(rule == C.MIN, torch.minimum(val_a, val_b), out)
    out = torch.where(rule == C.MULTIPLY, val_a * val_b, out)
    return torch.where(rule == C.MAX, torch.maximum(val_a, val_b), out)


def _shift_right(x, fill):
    """[fill, x[0], ..., x[-2]]"""
    return torch.cat([torch.full((1,), fill, dtype=x.dtype, device=x.device), x[:-1]])


def _shift_left(x, fill):
    """[x[1], ..., x[-1], fill]"""
    return torch.cat([x[1:], torch.full((1,), fill, dtype=x.dtype, device=x.device)])


def narrow_phase(world: World, bp: BroadPhaseResult, config: PhysicsConfig):
    """Build this step's Contacts from broadphase pairs + the old buffer.

    Returns ``(contacts, bucket_sizes)``; ``bucket_sizes`` maps each
    Kernel A kind to the number of pairs it was launched on."""
    old = world.contacts
    col = world.colliders
    b = world.bodies
    c_cap = old.capacity
    dev = col.params.device
    ca, cb = bp.collider_a.long(), bp.collider_b.long()
    ba = col.body_idx[ca]
    bb = col.body_idx[cb]
    bal, bbl = ba.long(), bb.long()

    pos, quat = update_collider_poses(world)
    pairs = config.shape_pairs if config.shape_pairs is not None else world.shape_pairs
    man, sizes = compute_manifolds(
        col.shape_type, col.params, pos, quat, ca, cb, bp.valid, pairs
    )

    # ---- effective speculative margin (reference :88-106) ---------------
    dt = config.dt
    spec_default = config.narrow_phase.default_speculative_margin

    def clamped_vel(body_idx, collider_idx):
        v = b.lin_vel[body_idx]
        spec = torch.clamp(col.speculative_margin[collider_idx], max=spec_default)
        speed = vec.length(v)
        scale = torch.clamp(spec / torch.clamp(speed * dt, min=1e-9), max=1.0)
        return v * scale[:, None]

    v_rel = clamped_vel(bbl, cb) - clamped_vel(bal, ca)
    margin = dt * vec.length(v_rel)
    tol = config.narrow_phase.contact_tolerance * config.length_unit
    keep_dist = (
        torch.clamp(margin, min=tol)
        + col.collision_margin[ca]
        + col.collision_margin[cb]
    )

    lanes = torch.arange(MAX_POINTS, device=dev)[None, :]
    point_valid = (
        (man.separation < keep_dist[:, None])
        & (lanes < man.count[:, None])
        & bp.valid[:, None]
    )
    order = torch.argsort((~point_valid).to(torch.int8), dim=1, stable=True)
    sep = man.separation.gather(1, order)
    fid = man.feature_id.gather(1, order)
    o3 = order[..., None].expand(-1, -1, 3)
    p_a = man.point_a.gather(1, o3)
    p_b = man.point_b.gather(1, o3)
    num_points = point_valid.sum(dim=1).to(torch.int32)
    touching = (num_points > 0) & bp.valid

    com_a = b.pos[bal] + quat_m.rotate(b.quat[bal], b.com[bal])
    com_b = b.pos[bbl] + quat_m.rotate(b.quat[bbl], b.com[bbl])
    anchor_a = p_a - com_a[:, None, :]
    anchor_b = p_b - com_b[:, None, :]

    # ---- pair persistence: one stable sort of [old keys ++ new keys] ----
    karr = torch.cat([old.pair_key, bp.pair_key])
    ks, s = torch.sort(karr, stable=True)
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
    hit = hit[:c_cap]
    matched = hit > 0
    old_slot = torch.clamp(hit - 1, min=0)

    was_touching = matched & old.touching[old_slot]
    carried_color = torch.where(matched, old.color[old_slot], -1)

    is_new = bp.valid & ~matched
    new_rank = torch.cumsum(is_new.to(torch.int32), dim=0, dtype=torch.int32) - 1
    contact_id = torch.where(
        matched,
        old.contact_id[old_slot],
        torch.where(is_new, old.next_contact_id + new_rank, 0),
    ).to(torch.int32)
    next_contact_id = (old.next_contact_id + is_new.sum()).to(torch.int32)

    # ---- per-point warm-start matching (reference :203-235) -------------
    old_fid = old.feature_id[old_slot]
    old_anchor = old.anchor_a[old_slot]
    old_np = old.normal_impulse[old_slot]
    old_tp = old.tangent_impulse[old_slot]
    old_valid = (lanes < old.num_points[old_slot][:, None]) & matched[:, None]
    fid_match = (fid[:, :, None] == old_fid[:, None, :]) & old_valid[:, None, :]
    dd = anchor_a[:, :, None, :] - old_anchor[:, None, :, :]
    d2 = vec.dot(dd, dd)
    dist_thresh = (config.narrow_phase.match_distance * config.length_unit) ** 2
    dist_match = (d2 < dist_thresh) & old_valid[:, None, :]
    use_match = torch.where(fid_match.any(dim=-1, keepdim=True), fid_match, dist_match)
    score = torch.where(use_match, -d2, -float("inf"))
    best = torch.argmax(score, dim=-1)
    has_match = use_match.any(dim=-1) & bool(config.narrow_phase.match_contacts)
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
    is_sensor = col.is_sensor[ca] | col.is_sensor[cb]

    # ---- CollisionEnd on eviction (reference :256-275) ------------------
    next_same = _shift_left(same_prev, False)
    next_new = _shift_left(tag_s, False)
    m_old_survives = ~tag_s & next_same & next_new & key_ok
    survives = torch.zeros((c_cap + 1,), dtype=torch.bool, device=dev)
    survives[torch.where(~tag_s, src_s, c_cap)] = m_old_survives
    survives = survives[:c_cap]
    evicted = old.active & old.touching & ~survives

    contacts = Contacts(
        pair_key=bp.pair_key,
        collider_a=bp.collider_a,
        collider_b=bp.collider_b,
        body_a=ba,
        body_b=bb,
        active=bp.valid,
        touching=touching,
        was_touching=was_touching,
        is_sensor=is_sensor,
        normal=man.normal,
        num_points=num_points,
        anchor_a=anchor_a,
        anchor_b=anchor_b,
        penetration=-sep,
        feature_id=fid,
        normal_impulse=warm_np,
        tangent_impulse=warm_tp,
        max_normal_impulse=torch.zeros_like(warm_np),
        friction=friction,
        static_friction=static_friction,
        restitution=restitution,
        surface_velocity=torch.zeros((c_cap, 3), device=dev),
        color=carried_color.to(torch.int32),
        contact_id=contact_id,
        next_contact_id=next_contact_id,
        evicted=evicted,
        evicted_contact_id=torch.where(evicted, old.contact_id, 0),
        evicted_body_a=torch.where(evicted, old.body_a, 0),
        evicted_body_b=torch.where(evicted, old.body_b, 0),
    )
    return contacts, sizes
