"""TGS-soft contact solver with warm starting and graph coloring (port of
``avian_tpu/pipeline/solver.py``).

``prepare_constraints`` (packing, coloring, bucketing, overflow relaxation)
and ``store_impulses`` are plain PyTorch. Every pass over the constraints,
``warm_start``, ``solve_pass`` (bias and relax) and ``solve_restitution``,
is one launch of Kernel D (``kernels/solve_color.py``) per color, in color
order. The packed layouts are the reference's: ``data[colors, cap, 88]``,
``imp[colors, cap, 16]``.
"""

import math
from dataclasses import dataclass, replace

import torch

from avian_tpu_torch.core import types
from avian_tpu_torch.core.config import PhysicsConfig
from avian_tpu_torch.core.state import MAX_POINTS, Contacts, World
from avian_tpu_torch.kernels import solve_color as kd
from avian_tpu_torch.math import sym3, vec
from avian_tpu_torch.pipeline.coloring import run_rank, color_constraints
from avian_tpu_torch.pipeline.solver_body import SolverState


def softness_coefficients(damping_ratio, hz, h):
    """(bias, mass_scale, impulse_scale), host-side floats."""
    omega = 2.0 * math.pi * hz
    a1 = 2.0 * damping_ratio + omega * h
    a2 = omega * h * a1
    a3 = 1.0 / (1.0 + a2)
    return omega / a1, a2 * a3, a3


def contact_softness(config: PhysicsConfig):
    """Dynamic and non-dynamic contact softness for the current timestep."""
    dt = config.dt
    h = config.substep_dt
    hz = config.solver.contact_frequency_factor * min(1.0 / (2.0 * dt), 0.25 / h)
    dyn = softness_coefficients(config.solver.contact_damping_ratio, hz, h)
    non_dyn = softness_coefficients(config.solver.contact_damping_ratio, 2.0 * hz, h)
    return dyn, non_dyn


def solve_params(config: PhysicsConfig) -> kd.SolveParams:
    return kd.SolveParams(
        h=config.substep_dt,
        max_overlap_speed=config.solver.max_overlap_solve_speed,
        stiction_t2=(
            config.solver.static_friction_speed_threshold * config.length_unit
        ) ** 2,
        warm_coefficient=config.solver.warm_start_coefficient,
        restitution_threshold=config.solver.restitution_threshold * config.length_unit,
    )


@dataclass(frozen=True)
class ContactConstraints:
    """Per-step contact constraints, packed and color-bucketed."""

    color_c: torch.Tensor       # i32[C] per-constraint color (-1 = none)
    base_imp: torch.Tensor      # f32[C, 16] impulses of constraints in no bucket
    data: torch.Tensor          # f32[colors, cap, 88]
    imp: torch.Tensor           # f32[colors, cap, 16], updated in place
    buckets: torch.Tensor       # i64[colors, cap] constraint indices
    bucket_valid: torch.Tensor  # bool[colors, cap]
    bucket_a: torch.Tensor      # i32[colors, cap]
    bucket_b: torch.Tensor      # i32[colors, cap]
    relax: torch.Tensor         # f32[colors, cap]
    ovf_order: torch.Tensor     # i32[2 cap] overflow-color write order
    ovf_key: torch.Tensor       # i32[2 cap] body written by each ordered entry
    overflow_dropped: torch.Tensor  # i32[]
    num_overflow: torch.Tensor      # i32[]

    def replace(self, **kw):
        return replace(self, **kw)


def _bucketize(color, active_mask, num_colors, cap):
    """Fixed-capacity per-color index buckets via one stable sort; rows
    beyond a bucket's capacity are dropped and counted."""
    c = color.shape[0]
    key = torch.where(active_mask, color.long(), num_colors)
    sorted_key, order = torch.sort(key, stable=True)
    rank = run_rank(sorted_key)
    in_cap = (rank < cap) & (sorted_key < num_colors)
    slot = torch.clamp(sorted_key, 0, num_colors - 1) * cap + rank
    slot = torch.where(in_cap, slot, num_colors * cap)
    flat = torch.full((num_colors * cap + 1,), c, dtype=torch.int64, device=color.device)
    flat[slot] = order
    buckets = flat[:-1].reshape(num_colors, cap)
    valid = buckets < c
    buckets = torch.where(valid, buckets, 0)
    dropped = ((sorted_key < num_colors) & ~in_cap).sum()
    return buckets, valid, dropped


def prepare_constraints(world: World, contacts: Contacts, s: SolverState,
                        config: PhysicsConfig) -> ContactConstraints:
    """Reference ``prepare_constraints`` (solver.py:158)."""
    b = world.bodies
    ba, bb = contacts.body_a.long(), contacts.body_b.long()
    c = contacts.capacity
    n_bodies = b.capacity
    dev = ba.device

    dyn_a = s.solve_mask[ba] > 0.0
    dyn_b = s.solve_mask[bb] > 0.0
    solve = contacts.active & contacts.touching & ~contacts.is_sensor & (dyn_a | dyn_b)

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

    dyn_soft, non_dyn_soft = contact_softness(config)
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

    color, _ = color_constraints(
        ba, bb, dyn_a, dyn_b, solve, n_bodies, config.max_colors,
        prev_color=contacts.color,
    )
    colors = config.max_colors
    cap = max(1, int(config.color_bucket_factor * c + colors - 1) // colors)
    buckets, bucket_valid, dropped = _bucketize(color, solve, colors, cap)

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
    num_overflow = lvalid.sum() + dropped

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
    imp = torch.cat(
        [
            contacts.normal_impulse,
            contacts.tangent_impulse.reshape(c, 8),
            torch.zeros((c, 4), device=dev),
        ],
        dim=-1,
    )
    data_b = data[buckets]
    data_b[:, :, kd.PM:kd.PM + 4] *= bucket_valid[:, :, None].float()
    bucket_a = ba[buckets].to(torch.int32).contiguous()
    bucket_b = bb[buckets].to(torch.int32).contiguous()
    ovf_order, ovf_key = kd.overflow_order(
        data_b[-1], bucket_a[-1], bucket_b[-1], bucket_valid[-1], n_bodies
    )
    return ContactConstraints(
        color_c=torch.where(solve, color, -1).to(torch.int32),
        base_imp=imp,
        data=data_b.contiguous(),
        imp=imp[buckets].contiguous(),
        buckets=buckets,
        bucket_valid=bucket_valid.contiguous(),
        bucket_a=bucket_a,
        bucket_b=bucket_b,
        relax=relax,
        ovf_order=ovf_order,
        ovf_key=ovf_key,
        overflow_dropped=dropped.to(torch.int32),
        num_overflow=num_overflow.to(torch.int32),
    )


def _run_colors(mode, s: SolverState, con: ContactConstraints, params):
    for color in range(con.data.shape[0]):
        kd.solve_color(
            mode, color, s.state, con.data, con.imp, con.bucket_a,
            con.bucket_b, con.bucket_valid, con.relax, con.ovf_order,
            con.ovf_key, params,
        )


def warm_start(s: SolverState, con: ContactConstraints, config) -> SolverState:
    """Apply the stored impulses at substep start (reference :370), color by
    color. Updates ``s.state`` in place."""
    _run_colors(kd.WARM, s, con, solve_params(config))
    return s


def solve_pass(s: SolverState, con: ContactConstraints, use_bias: bool,
               config: PhysicsConfig):
    """One bias or relax pass over the colors (reference :410). Updates
    ``s.state`` and ``con.imp`` in place."""
    _run_colors(kd.BIAS if use_bias else kd.RELAX, s, con, solve_params(config))
    return s, con


def solve_restitution(s: SolverState, con: ContactConstraints, config: PhysicsConfig):
    """Post-substep restitution (reference :593)."""
    params = solve_params(config)
    for _ in range(config.solver.restitution_iterations):
        _run_colors(kd.RESTITUTION, s, con, params)
    return s, con


def store_impulses(contacts: Contacts, con: ContactConstraints) -> Contacts:
    """Persist accumulated impulses for next-step warm starting."""
    c = contacts.capacity
    flat_idx = torch.where(con.bucket_valid.reshape(-1), con.buckets.reshape(-1), c)
    imp = torch.cat([con.base_imp, torch.zeros((1, kd.IMP), device=flat_idx.device)])
    imp[flat_idx] = con.imp.reshape(-1, kd.IMP)
    imp = imp[:c]
    return contacts.replace(
        normal_impulse=imp[:, 0:4],
        tangent_impulse=imp[:, 4:12].reshape(c, 4, 2),
        max_normal_impulse=imp[:, 12:16],
        color=con.color_c,
    )
