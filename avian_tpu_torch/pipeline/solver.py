"""TGS-soft contact solver with warm starting and graph coloring (port of
``avian_tpu/pipeline/solver.py``).

``prepare_constraints`` is Kernel H (flags, packing, overflow relaxation;
``kernels/pack_constraints.py``) around Kernel G (coloring and bucketing;
``kernels/color_edges.py``); ``store_impulses`` is plain PyTorch. Every pass
over the constraints,
``warm_start``, ``solve_pass`` (bias and relax) and ``solve_restitution``,
is one launch of Kernel D (``kernels/solve_color.py``) per color, in color
order. The packed layouts are the reference's: ``data[colors, cap, 88]``,
``imp[colors, cap, 16]``.
"""

import math
from dataclasses import dataclass, replace

import torch

from avian_tpu_torch.core.config import PhysicsConfig
from avian_tpu_torch.core.state import Contacts, World
from avian_tpu_torch.kernels import color_edges as kg
from avian_tpu_torch.kernels import pack_constraints as kh
from avian_tpu_torch.kernels import solve_color as kd
from avian_tpu_torch.pipeline.coloring import color_constraints
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
    beyond a bucket's capacity are dropped and counted (Kernel G). Returns
    ``(buckets, valid, dropped, num_overflow)``."""
    return kg.bucket_edges(color, active_mask, num_colors, cap)


def prepare_constraints(world: World, contacts: Contacts, s: SolverState,
                        config: PhysicsConfig) -> ContactConstraints:
    """Reference ``prepare_constraints`` (solver.py:158): flags (Kernel H),
    coloring and bucketing (Kernel G), packing (Kernel H)."""
    n_bodies = world.bodies.capacity
    c = contacts.capacity
    colors = config.max_colors
    dyn_a, dyn_b, solve, base_imp = kh.constraint_flags(contacts, s.solve_mask)
    color, _ = color_constraints(
        contacts.body_a, contacts.body_b, dyn_a, dyn_b, solve, n_bodies, colors,
        prev_color=contacts.color,
    )
    cap = max(1, int(config.color_bucket_factor * c + colors - 1) // colors)
    buckets, bucket_valid, dropped, num_overflow = _bucketize(color, solve, colors, cap)
    dyn_soft, non_dyn_soft = contact_softness(config)
    packed = kh.pack_constraints(
        world.bodies, contacts, s, dyn_a, dyn_b, solve, base_imp, buckets,
        bucket_valid, dyn_soft, non_dyn_soft,
    )
    ovf_order, ovf_key = kd.overflow_order(
        packed.data[-1], packed.bucket_a[-1], packed.bucket_b[-1], bucket_valid[-1],
        n_bodies,
    )
    return ContactConstraints(
        color_c=torch.where(solve, color, -1).to(torch.int32),
        base_imp=base_imp,
        data=packed.data,
        imp=packed.imp,
        buckets=buckets,
        bucket_valid=bucket_valid,
        bucket_a=packed.bucket_a,
        bucket_b=packed.bucket_b,
        relax=packed.relax,
        ovf_order=ovf_order,
        ovf_key=ovf_key,
        overflow_dropped=dropped,
        num_overflow=num_overflow,
    )


def overflow_by_scene(con: ContactConstraints, scenes: int):
    """``(overflow_dropped i32[B], num_overflow i32[B])`` of B scenes of
    C / B constraints (B = 1 for a world, where they are Kernel G's own
    counts): each scene's solved rows that found no bucket slot, and those
    plus its rows in the last colour's bucket. The buckets of the flat world
    of ``parallel.make_batched_step`` are pooled (sized from its whole C),
    so a scene drops rows only when the pooled bucket of a colour is full,
    where ``jax.vmap`` of the reference gives each scene buckets of its own."""
    c = con.color_c.shape[0]
    dev = con.color_c.device

    def placed(buckets, valid):
        flag = torch.zeros((c + 1,), dtype=torch.bool, device=dev)
        flag.index_fill_(0, torch.where(valid, buckets, c).reshape(-1), True)
        return flag[:c].reshape(scenes, -1)

    solved = (con.color_c >= 0).reshape(scenes, -1)
    dropped = (solved & ~placed(con.buckets, con.bucket_valid)).sum(dim=1)
    in_last = placed(con.buckets[-1], con.bucket_valid[-1]).sum(dim=1)
    return dropped.to(torch.int32), (in_last + dropped).to(torch.int32)


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
        normal_impulse=imp[:, 0:4].contiguous(),
        tangent_impulse=imp[:, 4:12].reshape(c, 4, 2).contiguous(),
        max_normal_impulse=imp[:, 12:16].contiguous(),
        color=con.color_c,
    )
