"""Kernel W, ``contact_rows_2d``: the 2D engine's contact persistence after
the manifolds.

Replaces ``avian_tpu/dim2/contacts.py::narrow_phase`` (:18) from the
manifolds on: the speculative keep predicate (:43-63) with in-row point
compaction, COM-relative anchors, ``was_touching`` and the carried colour
(:102-108), contact ids and ``next_contact_id``, the per-point warm-start
match by feature id, else by anchor distance (:117-135), the material
combine rules, and the eviction columns. The join of old and new pair keys
(:76-100) is Kernel F's ``contact_join`` (``kernels/contact_rows.py``), which
does not depend on the dimension, after one stable sort of the int64 keys;
one ``cumsum`` mints the new contact ids, as in 3D.

One launch, one thread per pair slot, everything in registers (2 points, a
2 x 2 match). Among old points that match equally well the first wins, as
``jnp.argmax`` picks. The cosine and sine of each body's angle come in as
inputs, so that the anchors round as the plain version's do. On the H100 the
launch is bound by bytes: a row reads about 200 (two colliders, two bodies,
the manifold and one old row) and writes about 130.

The plain PyTorch version, ``contact_rows_2d_twin``, runs on CPU tensors; on
a CUDA tensor the wrapper launches the kernel or raises.
"""

from typing import NamedTuple

import torch

from avian_tpu_torch.kernels.contact_rows import _combine, first_argmax
from avian_tpu_torch.kernels.manifold_2d import norm2

P = 2  # points a pair


class RowParams2D(NamedTuple):
    dt: float
    spec_default: float     # cap on the colliders' speculative margins
    tolerance: float        # contact tolerance in length units
    match_distance2: float  # squared warm-start match distance
    match_contacts: bool


# Columns of ``Contacts2D`` that ``contact_rows_2d`` returns, in the kernel's order.
ROW_COLUMNS = (
    "body_a", "body_b", "touching", "was_touching", "is_sensor", "num_points",
    "anchor_a", "anchor_b", "penetration", "feature_id", "normal_impulse",
    "tangent_impulse", "friction", "static_friction", "restitution", "color",
    "contact_id", "evicted", "evicted_contact_id", "evicted_body_a", "evicted_body_b",
)


def contact_rows_2d_twin(bodies, body_cs, col, old, valid, ca, cb, man, hit, survives,
                         new_rank, p: RowParams2D):
    """Plain PyTorch version; see ``contact_rows_2d``."""
    b = bodies
    dev = valid.device
    ca, cb = ca.long(), cb.long()
    ba, bb = col.body_idx[ca], col.body_idx[cb]
    bal, bbl = ba.long(), bb.long()

    def clamped_vel(body, collider):
        v = b.lin_vel[body]
        spec = torch.clamp(col.speculative_margin[collider], max=p.spec_default)
        scale = torch.clamp(spec / torch.clamp(norm2(v) * p.dt, min=1e-9), max=1.0)
        return v * scale[:, None]

    margin = p.dt * norm2(clamped_vel(bbl, cb) - clamped_vel(bal, ca))
    keep_dist = (torch.clamp(margin, min=p.tolerance)
                 + col.collision_margin[ca] + col.collision_margin[cb])

    lanes = torch.arange(P, device=dev)[None, :]
    point_valid = ((man.separation < keep_dist[:, None]) & (lanes < man.count[:, None])
                   & valid[:, None])
    order = torch.argsort((~point_valid).to(torch.int8), dim=1, stable=True)
    sep = man.separation.gather(1, order)
    fid = man.feature_id.gather(1, order)
    o2 = order[..., None].expand(-1, -1, 2)
    p_a = man.point_a.gather(1, o2)
    p_b = man.point_b.gather(1, o2)
    num_points = point_valid.sum(dim=1).to(torch.int32)
    touching = (num_points > 0) & valid

    def com(body):
        c, s, r = body_cs[body, 0], body_cs[body, 1], b.com[body]
        return b.pos[body] + torch.stack(
            [c * r[:, 0] - s * r[:, 1], s * r[:, 0] + c * r[:, 1]], -1)

    anchor_a = p_a - com(bal)[:, None, :]
    anchor_b = p_b - com(bbl)[:, None, :]

    matched = hit > 0
    old_slot = torch.clamp(hit.long() - 1, min=0)
    was_touching = matched & old.touching[old_slot]
    carried_color = torch.where(matched, old.color[old_slot], -1)
    is_new = valid & ~matched
    contact_id = torch.where(
        matched, old.contact_id[old_slot],
        torch.where(is_new, old.next_contact_id + new_rank, 0),
    ).to(torch.int32)

    old_valid = (lanes < old.num_points[old_slot][:, None]) & matched[:, None]
    fid_match = (fid[:, :, None] == old.feature_id[old_slot][:, None, :]) & old_valid[:, None, :]
    dd = anchor_a[:, :, None, :] - old.anchor_a[old_slot][:, None, :, :]
    d2 = dd[..., 0] * dd[..., 0] + dd[..., 1] * dd[..., 1]
    dist_match = (d2 < p.match_distance2) & old_valid[:, None, :]
    use_match = torch.where(fid_match.any(dim=-1, keepdim=True), fid_match, dist_match)
    best = first_argmax(torch.where(use_match, -d2, -float("inf")))
    has_match = use_match.any(dim=-1) & bool(p.match_contacts)
    warm_np = torch.where(has_match, old.normal_impulse[old_slot].gather(1, best), 0.0)
    warm_tp = torch.where(has_match, old.tangent_impulse[old_slot].gather(1, best), 0.0)

    fc, rc = col.friction_combine, col.restitution_combine
    evicted = old.active & old.touching & ~survives
    return dict(
        body_a=ba, body_b=bb, touching=touching, was_touching=was_touching,
        is_sensor=col.is_sensor[ca] | col.is_sensor[cb], num_points=num_points,
        anchor_a=anchor_a, anchor_b=anchor_b, penetration=-sep, feature_id=fid,
        normal_impulse=warm_np, tangent_impulse=warm_tp,
        friction=_combine(col.friction[ca], col.friction[cb], fc[ca], fc[cb]),
        static_friction=_combine(col.static_friction[ca], col.static_friction[cb],
                                 fc[ca], fc[cb]),
        restitution=_combine(col.restitution[ca], col.restitution[cb], rc[ca], rc[cb]),
        color=carried_color.to(torch.int32), contact_id=contact_id, evicted=evicted,
        evicted_contact_id=torch.where(evicted, old.contact_id, 0),
        evicted_body_a=torch.where(evicted, old.body_a, 0),
        evicted_body_b=torch.where(evicted, old.body_b, 0),
    )


def contact_rows_2d(bodies, body_cs, col, old, valid, ca, cb, man, hit, survives, new_rank,
                    p: RowParams2D):
    """This step's 2D contact rows, as a dict of the ``ROW_COLUMNS`` of
    ``Contacts2D``.

    ``bodies``, ``col``: the world's ``Bodies2D`` and ``Colliders2D``;
    ``body_cs`` f32[N, 2]: cosine and sine of each body's angle; ``old``:
    last step's ``Contacts2D``; ``valid`` bool[C], ``ca``/``cb`` i32[C]: the
    broadphase's pair slots; ``man``: their ``Manifold2D``; ``hit``,
    ``survives``: from ``contact_join``; ``new_rank`` i32[C]:
    ``cumsum(valid & hit == 0) - 1``."""
    dev = valid.device
    if dev.type == "cpu":
        return contact_rows_2d_twin(bodies, body_cs, col, old, valid, ca, cb, man, hit,
                                    survives, new_rank, p)
    if dev.type != "cuda":
        raise RuntimeError(f"contact_rows_2d: unsupported device {dev}")
    from avian_tpu_torch.kernels import build

    c, m, n = old.capacity, col.capacity, bodies.capacity
    f32, i32, u8 = torch.float32, torch.int32, torch.bool
    inputs = (
        ("valid", valid, (c,), u8), ("collider_a", ca, (c,), i32), ("collider_b", cb, (c,), i32),
        ("point_a", man.point_a, (c, P, 2), f32), ("point_b", man.point_b, (c, P, 2), f32),
        ("separation", man.separation, (c, P), f32),
        ("feature_id", man.feature_id, (c, P), i32), ("count", man.count, (c,), i32),
        ("body_idx", col.body_idx, (m,), i32),
        ("speculative_margin", col.speculative_margin, (m,), f32),
        ("collision_margin", col.collision_margin, (m,), f32),
        ("friction", col.friction, (m,), f32),
        ("static_friction", col.static_friction, (m,), f32),
        ("restitution", col.restitution, (m,), f32),
        ("friction_combine", col.friction_combine, (m,), i32),
        ("restitution_combine", col.restitution_combine, (m,), i32),
        ("is_sensor", col.is_sensor, (m,), u8),
        ("pos", bodies.pos, (n, 2), f32), ("body_cs", body_cs, (n, 2), f32),
        ("com", bodies.com, (n, 2), f32), ("lin_vel", bodies.lin_vel, (n, 2), f32),
        ("hit", hit, (c,), i32), ("survives", survives, (c,), u8),
        ("new_rank", new_rank, (c,), i32),
        ("old.active", old.active, (c,), u8), ("old.touching", old.touching, (c,), u8),
        ("old.color", old.color, (c,), i32), ("old.contact_id", old.contact_id, (c,), i32),
        ("old.next_contact_id", old.next_contact_id, (), i32),
        ("old.feature_id", old.feature_id, (c, P), i32),
        ("old.anchor_a", old.anchor_a, (c, P, 2), f32),
        ("old.normal_impulse", old.normal_impulse, (c, P), f32),
        ("old.tangent_impulse", old.tangent_impulse, (c, P), f32),
        ("old.num_points", old.num_points, (c,), i32),
        ("old.body_a", old.body_a, (c,), i32), ("old.body_b", old.body_b, (c,), i32),
    )
    build.require("contact_rows_2d", dev, inputs)
    shapes = dict(
        anchor_a=((c, P, 2), f32), anchor_b=((c, P, 2), f32), penetration=((c, P), f32),
        feature_id=((c, P), i32), normal_impulse=((c, P), f32),
        tangent_impulse=((c, P), f32), friction=((c,), f32),
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
        "avian_contact_rows_2d", dev, c, *(x for _, x, _, _ in inputs),
        float(p.dt), float(p.spec_default), float(p.tolerance), float(p.match_distance2),
        int(bool(p.match_contacts)), *(out[name] for name in ROW_COLUMNS),
    )
    contact_rows_2d.launches += 1
    return out


contact_rows_2d.launches = 0
