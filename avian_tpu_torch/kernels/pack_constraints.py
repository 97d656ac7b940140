"""Kernel H, ``pack_constraints``: the packed, colour-bucketed constraint rows.

Replaces ``avian_tpu/pipeline/solver.py::prepare_constraints`` (:158) around
the colouring (Kernel G): ``constraint_flags`` before it (which ends are
dynamic, which constraints are solved, the stored impulses as 16-float
rows), ``pack_constraints`` after it (``data[colors, cap, 88]``,
``imp[colors, cap, 16]``, ``bucket_a/b`` and the overflow colour's
relaxation ``1 / per-body multiplicity``).

The reference and the plain version build a ``[C, 88]`` row per constraint
and then gather rows into bucket order. The kernel gives one thread to each
bucket slot, which reads its contact row and both bodies and writes its rows
straight in bucket order: no intermediate, no gather. The multiplicity is
counted per body with ``atomicAdd`` on int32, which has no order; no float
atomic is used, so reruns are bitwise equal. On the H100 the rows launch is
bound by bytes (about 330 read and 428 written per slot). Every sum is
spelled in the plain version's order, the thresholds of ``any_orthonormal``
and ``normalize_or`` are copied, and a zero ``k_normal`` (two locked or static
ends) gives a zero mass, not a division. A padded slot packs constraint 0
with a zero point mask, so that it names a real body as Kernel D expects.

The plain PyTorch versions, ``constraint_flags_twin`` and
``pack_constraints_twin``, run on CPU tensors; on a CUDA tensor the wrappers
launch the kernels or raise.
"""

from typing import NamedTuple

import torch

from avian_tpu_torch.core import types
from avian_tpu_torch.core.state import MAX_POINTS
from avian_tpu_torch.kernels import solve_color as kd
from avian_tpu_torch.math import sym3, vec


class Packed(NamedTuple):
    data: torch.Tensor      # f32[colors, cap, 88]
    imp: torch.Tensor       # f32[colors, cap, 16]
    bucket_a: torch.Tensor  # i32[colors, cap]
    bucket_b: torch.Tensor  # i32[colors, cap]
    relax: torch.Tensor     # f32[colors, cap]


def constraint_flags_twin(contacts, solve_mask):
    """Plain PyTorch version; see ``constraint_flags``."""
    c = contacts.capacity
    dyn_a = solve_mask[contacts.body_a.long()] > 0.0
    dyn_b = solve_mask[contacts.body_b.long()] > 0.0
    solve = contacts.active & contacts.touching & ~contacts.is_sensor & (dyn_a | dyn_b)
    base_imp = torch.cat(
        [
            contacts.normal_impulse,
            contacts.tangent_impulse.reshape(c, 8),
            torch.zeros((c, 4), device=solve_mask.device),
        ],
        dim=-1,
    )
    return dyn_a, dyn_b, solve, base_imp


def constraint_flags(contacts, solve_mask):
    """Per constraint: ``dyn_a``/``dyn_b`` bool[C] (that end responds to
    impulses: ``solve_mask`` f32[N] > 0), ``solve`` bool[C] (active, touching,
    no sensor, a dynamic end) and ``base_imp`` f32[C, 16], the stored normal
    and tangent impulses in Kernel D's row layout."""
    dev = solve_mask.device
    if dev.type == "cpu":
        return constraint_flags_twin(contacts, solve_mask)
    if dev.type != "cuda":
        raise RuntimeError(f"constraint_flags: unsupported device {dev}")
    from avian_tpu_torch.kernels import build

    c, k = contacts.capacity, MAX_POINTS
    f32, i32, u8 = torch.float32, torch.int32, torch.bool
    build.require("constraint_flags", dev, (
        ("body_a", contacts.body_a, (c,), i32), ("body_b", contacts.body_b, (c,), i32),
        ("active", contacts.active, (c,), u8), ("touching", contacts.touching, (c,), u8),
        ("is_sensor", contacts.is_sensor, (c,), u8),
        ("solve_mask", solve_mask, (solve_mask.shape[0],), f32),
        ("normal_impulse", contacts.normal_impulse, (c, k), f32),
        ("tangent_impulse", contacts.tangent_impulse, (c, k, 2), f32),
    ))
    dyn_a = torch.empty((c,), dtype=u8, device=dev)
    dyn_b = torch.empty((c,), dtype=u8, device=dev)
    solve = torch.empty((c,), dtype=u8, device=dev)
    base_imp = torch.empty((c, kd.IMP), dtype=f32, device=dev)
    if c == 0:
        return dyn_a, dyn_b, solve, base_imp
    build.launch(
        "avian_pack_flags", dev, c, contacts.body_a, contacts.body_b, contacts.active,
        contacts.touching, contacts.is_sensor, solve_mask, contacts.normal_impulse,
        contacts.tangent_impulse, dyn_a, dyn_b, solve, base_imp,
    )
    constraint_flags.launches += 1
    return dyn_a, dyn_b, solve, base_imp


constraint_flags.launches = 0


def pack_constraints_twin(bodies, contacts, s, dyn_a, dyn_b, solve, base_imp,
                          buckets, bucket_valid, dyn_soft, non_dyn_soft) -> Packed:
    """Plain PyTorch version; see ``pack_constraints``."""
    b = bodies
    ba, bb = contacts.body_a.long(), contacts.body_b.long()
    c = contacts.capacity
    n_bodies = b.capacity
    colors, cap = buckets.shape
    dev = ba.device

    eff_dom = torch.where(
        (b.body_type == types.BodyType.DYNAMIC) & ~b.sleeping, b.dominance, 127
    )
    rel_dom = eff_dom[ba] - eff_dom[bb]
    a_static = (rel_dom > 0)[:, None]
    b_static = (rel_dom < 0)[:, None]
    inv_mass_a = torch.where(a_static, 0.0, s.inv_mass[ba])
    inv_inertia_a = torch.where(a_static, 0.0, s.inv_inertia[ba])
    inv_mass_b = torch.where(b_static, 0.0, s.inv_mass[bb])
    inv_inertia_b = torch.where(b_static, 0.0, s.inv_inertia[bb])
    softness = torch.where(
        (rel_dom != 0)[:, None],
        torch.tensor(non_dyn_soft, dtype=torch.float32, device=dev)[None, :],
        torch.tensor(dyn_soft, dtype=torch.float32, device=dev)[None, :],
    )

    n = contacts.normal
    force_dir = -n
    rel_v = b.lin_vel[ba] - b.lin_vel[bb]
    tang_v = rel_v - force_dir * vec.dot(force_dir, rel_v)[:, None]
    t1 = vec.normalize_or(tang_v, vec.any_orthonormal(force_dir))
    t2 = vec.cross(force_dir, t1)

    r1 = contacts.anchor_a
    r2 = contacts.anchor_b
    im_sum = inv_mass_a + inv_mass_b
    n_p = n[:, None, :]
    iia = inv_inertia_a[:, None, :]
    iib = inv_inertia_b[:, None, :]
    r1xn = vec.cross(r1, n_p)
    r2xn = vec.cross(r2, n_p)
    k_normal = (
        vec.dot(n_p, im_sum[:, None, :] * n_p)
        + vec.dot(r1xn, sym3.mv(iia, r1xn))
        + vec.dot(r2xn, sym3.mv(iib, r2xn))
    )
    normal_mass = vec.safe_recip(k_normal)

    t1_p = t1[:, None, :]
    t2_p = t2[:, None, :]
    rt11 = vec.cross(r1, t1_p)
    rt12 = vec.cross(r2, t1_p)
    rt21 = vec.cross(r1, t2_p)
    rt22 = vec.cross(r2, t2_p)
    i1_rt11 = sym3.mv(iia, rt11)
    i2_rt12 = sym3.mv(iib, rt12)
    i1_rt21 = sym3.mv(iia, rt21)
    i2_rt22 = sym3.mv(iib, rt22)
    k1 = (
        vec.dot(t1_p, im_sum[:, None, :] * t1_p)
        + vec.dot(rt11, i1_rt11) + vec.dot(rt12, i2_rt12)
    )
    k2 = (
        vec.dot(t2_p, im_sum[:, None, :] * t2_p)
        + vec.dot(rt21, i1_rt21) + vec.dot(rt22, i2_rt22)
    )
    k12 = 2.0 * (vec.dot(rt11, i1_rt21) + vec.dot(rt12, i2_rt22))

    initial_separation = -contacts.penetration - vec.dot(r2 - r1, n_p)
    v_a = s.lin_vel[ba][:, None, :] + vec.cross(s.ang_vel[ba][:, None, :], r1)
    v_b = s.lin_vel[bb][:, None, :] + vec.cross(s.ang_vel[bb][:, None, :], r2)
    normal_speed = vec.dot(v_b - v_a, n_p)
    lanes = torch.arange(MAX_POINTS, device=dev)[None, :]
    point_mask = ((lanes < contacts.num_points[:, None]) & solve[:, None]).float()

    # Overflow under-relaxation: 1 / (max per-body multiplicity) in the
    # last color, whose rows may share a dynamic body.
    last = buckets[-1]
    lvalid = bucket_valid[-1]
    la = torch.where(lvalid & dyn_a[last], ba[last], n_bodies)
    lb = torch.where(lvalid & dyn_b[last], bb[last], n_bodies)
    cnt = torch.zeros((n_bodies + 1,), dtype=torch.float32, device=dev)
    ones = torch.ones_like(la, dtype=torch.float32)
    cnt.index_add_(0, la, ones)
    cnt.index_add_(0, lb, ones)
    cnt[n_bodies] = 1.0
    mult = torch.maximum(cnt[la], cnt[lb])
    relax = torch.ones((colors, cap), dtype=torch.float32, device=dev)
    relax[-1] = 1.0 / torch.clamp(mult, min=1.0)

    data = torch.cat(
        [
            n, t1, t2,
            contacts.friction[:, None],
            contacts.restitution[:, None],
            softness,
            inv_mass_a, inv_mass_b,
            inv_inertia_a, inv_inertia_b,
            r1.reshape(c, 12), r2.reshape(c, 12),
            initial_separation,
            normal_mass,
            torch.stack([k1, k2, k12], dim=-1).reshape(c, 12),
            normal_speed,
            point_mask,
            contacts.surface_velocity,
            contacts.static_friction[:, None],
        ],
        dim=-1,
    )
    data_b = data[buckets]
    data_b[:, :, kd.PM:kd.PM + 4] *= bucket_valid[:, :, None].float()
    return Packed(
        data=data_b.contiguous(),
        imp=base_imp[buckets].contiguous(),
        bucket_a=ba[buckets].to(torch.int32).contiguous(),
        bucket_b=bb[buckets].to(torch.int32).contiguous(),
        relax=relax,
    )


def pack_constraints(bodies, contacts, s, dyn_a, dyn_b, solve, base_imp,
                     buckets, bucket_valid, dyn_soft, non_dyn_soft) -> Packed:
    """The constraint rows of every bucket slot, in bucket order.

    ``bodies``: the world's ``Bodies``; ``contacts``: this step's
    ``Contacts``; ``s``: the ``SolverState`` (``state`` f32[N, 13],
    ``inv_mass`` f32[N, 3], ``inv_inertia`` f32[N, 6]); ``dyn_a``, ``dyn_b``,
    ``solve``, ``base_imp``: from ``constraint_flags``; ``buckets`` i64[colors,
    cap] and ``bucket_valid`` bool[colors, cap]: from Kernel G;
    ``dyn_soft``/``non_dyn_soft``: (bias, mass scale, impulse scale) of
    contacts between equals and against a dominant body."""
    dev = buckets.device
    if dev.type == "cpu":
        return pack_constraints_twin(bodies, contacts, s, dyn_a, dyn_b, solve, base_imp,
                                     buckets, bucket_valid, dyn_soft, non_dyn_soft)
    if dev.type != "cuda":
        raise RuntimeError(f"pack_constraints: unsupported device {dev}")
    from avian_tpu_torch.kernels import build

    c, n, k = contacts.capacity, bodies.capacity, MAX_POINTS
    colors, cap = buckets.shape
    f32, i32, u8 = torch.float32, torch.int32, torch.bool
    inputs = (
        ("buckets", buckets, (colors, cap), torch.int64),
        ("bucket_valid", bucket_valid, (colors, cap), u8),
        ("body_a", contacts.body_a, (c,), i32), ("body_b", contacts.body_b, (c,), i32),
        ("dyn_a", dyn_a, (c,), u8), ("dyn_b", dyn_b, (c,), u8), ("solve", solve, (c,), u8),
        ("normal", contacts.normal, (c, 3), f32),
        ("anchor_a", contacts.anchor_a, (c, k, 3), f32),
        ("anchor_b", contacts.anchor_b, (c, k, 3), f32),
        ("penetration", contacts.penetration, (c, k), f32),
        ("num_points", contacts.num_points, (c,), i32),
        ("friction", contacts.friction, (c,), f32),
        ("restitution", contacts.restitution, (c,), f32),
        ("static_friction", contacts.static_friction, (c,), f32),
        ("surface_velocity", contacts.surface_velocity, (c, 3), f32),
        ("base_imp", base_imp, (c, kd.IMP), f32),
        ("body_type", bodies.body_type, (n,), i32), ("sleeping", bodies.sleeping, (n,), u8),
        ("dominance", bodies.dominance, (n,), i32), ("lin_vel", bodies.lin_vel, (n, 3), f32),
        ("state", s.state, (n, 13), f32), ("inv_mass", s.inv_mass, (n, 3), f32),
        ("inv_inertia", s.inv_inertia, (n, 6), f32),
    )
    build.require("pack_constraints", dev, inputs)
    out = Packed(
        data=torch.empty((colors, cap, kd.D), dtype=f32, device=dev),
        imp=torch.empty((colors, cap, kd.IMP), dtype=f32, device=dev),
        bucket_a=torch.empty((colors, cap), dtype=i32, device=dev),
        bucket_b=torch.empty((colors, cap), dtype=i32, device=dev),
        relax=torch.empty((colors, cap), dtype=f32, device=dev),
    )
    cnt = torch.zeros((n,), dtype=i32, device=dev)
    build.launch(
        "avian_pack_count", dev, cap, buckets[-1], bucket_valid[-1], contacts.body_a,
        contacts.body_b, dyn_a, dyn_b, cnt,
    )
    pack_constraints.launches += 1
    build.launch(
        "avian_pack_rows", dev, colors, cap, *(x for _, x, _, _ in inputs), cnt, *out,
        *(float(x) for x in dyn_soft), *(float(x) for x in non_dyn_soft),
    )
    pack_constraints.launches += 1
    return out


pack_constraints.launches = 0
