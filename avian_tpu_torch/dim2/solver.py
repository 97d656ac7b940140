"""2D TGS-soft contact solver with warm starting and graph colouring (port of
``avian_tpu/dim2/solver.py``).

``prepare_constraints`` colours the contacts with Kernel G
(``pipeline/coloring.py``), buckets them per colour with the 3D port's
``_bucketize`` (Kernel G) at the reference's bucket capacity (:171-176), and
packs the 33-float rows with Kernel X (``kernels/pack_2d.py``). Every pass
over the constraints, ``warm_start``, ``solve_pass`` (bias and relax) and
``solve_restitution``, is one launch of Kernel Y (``kernels/solve_2d.py``)
per colour, in colour order. ``store_impulses`` is tensor operations.
"""

from dataclasses import dataclass, replace

import torch

from avian_tpu_torch.core.config import PhysicsConfig
from avian_tpu_torch.dim2.dynamics import SolverState2D
from avian_tpu_torch.dim2.state import Contacts2D, World2D
from avian_tpu_torch.kernels import pack_2d as kx
from avian_tpu_torch.kernels import solve_2d as ky
from avian_tpu_torch.pipeline.coloring import color_constraints
from avian_tpu_torch.pipeline.solver import _bucketize, contact_softness


@dataclass(frozen=True)
class ContactConstraints2D:
    """Per-step contact constraints, packed and colour-bucketed."""

    color_c: torch.Tensor       # i32[C] colour of each solved contact (-1 = none)
    base_imp: torch.Tensor      # f32[C, 6] impulses of contacts in no bucket
    data: torch.Tensor          # f32[colors, cap, 33]
    imp: torch.Tensor           # f32[colors, cap, 6], updated in place
    buckets: torch.Tensor       # i64[colors, cap]
    bucket_valid: torch.Tensor  # bool[colors, cap]
    bucket_a: torch.Tensor      # i32[colors, cap]
    bucket_b: torch.Tensor      # i32[colors, cap]
    relax: torch.Tensor         # f32[colors, cap]
    ovf_order: torch.Tensor     # i32[2 cap] overflow-colour write order
    ovf_key: torch.Tensor       # i32[2 cap]
    overflow_dropped: torch.Tensor  # i32[]
    num_overflow: torch.Tensor      # i32[]

    def replace(self, **kw):
        return replace(self, **kw)


def solve_params(config: PhysicsConfig) -> ky.SolveParams2D:
    return ky.SolveParams2D(
        h=config.substep_dt,
        max_overlap_speed=config.solver.max_overlap_solve_speed,
        stiction_t2=(config.solver.static_friction_speed_threshold * config.length_unit) ** 2,
        warm_coefficient=config.solver.warm_start_coefficient,
        restitution_threshold=config.solver.restitution_threshold * config.length_unit,
    )


def bucket_capacity(config: PhysicsConfig, c: int) -> int:
    """Rows a colour holds (reference :171-176)."""
    return max(1, int(config.color_bucket_factor * c + config.max_colors - 1)
               // config.max_colors)


def prepare_constraints(world: World2D, contacts: Contacts2D, s: SolverState2D,
                        config: PhysicsConfig) -> ContactConstraints2D:
    """Reference ``prepare_constraints`` (:87)."""
    n_bodies = world.bodies.capacity
    colors = config.max_colors
    ba, bb = contacts.body_a.long(), contacts.body_b.long()
    dyn_a = s.solve_mask[ba] > 0.0
    dyn_b = s.solve_mask[bb] > 0.0
    solve = contacts.active & contacts.touching & ~contacts.is_sensor & (dyn_a | dyn_b)
    color, _ = color_constraints(contacts.body_a, contacts.body_b, dyn_a, dyn_b, solve,
                                 n_bodies, colors, prev_color=contacts.color)
    cap = bucket_capacity(config, contacts.capacity)
    buckets, bucket_valid, dropped, num_overflow = _bucketize(color, solve, colors, cap)
    dyn_soft, non_dyn_soft = contact_softness(config)
    packed = kx.pack_2d(world.bodies, contacts, s.state, s.inv_mass, s.inv_inertia, dyn_a,
                        dyn_b, solve, buckets, bucket_valid, dyn_soft, non_dyn_soft)
    ovf_order, ovf_key = ky.overflow_order(packed.data[-1], packed.bucket_a[-1],
                                           packed.bucket_b[-1], bucket_valid[-1], n_bodies)
    c = contacts.capacity
    base_imp = torch.cat([contacts.normal_impulse, contacts.tangent_impulse,
                          torch.zeros((c, 2), device=ba.device)], -1)
    return ContactConstraints2D(
        color_c=torch.where(solve, color, -1).to(torch.int32),
        base_imp=base_imp, data=packed.data, imp=packed.imp, buckets=buckets,
        bucket_valid=bucket_valid, bucket_a=packed.bucket_a, bucket_b=packed.bucket_b,
        relax=packed.relax, ovf_order=ovf_order, ovf_key=ovf_key,
        overflow_dropped=dropped, num_overflow=num_overflow,
    )


def _run_colors(mode, s: SolverState2D, con: ContactConstraints2D, params):
    for color in range(con.data.shape[0]):
        ky.solve_2d(mode, color, s.state, con.data, con.imp, con.bucket_a, con.bucket_b,
                    con.bucket_valid, con.relax, con.ovf_order, con.ovf_key, params)


def warm_start(s: SolverState2D, con: ContactConstraints2D, config) -> SolverState2D:
    """Apply the stored impulses at substep start (reference :275), colour by
    colour. Updates ``s.state`` in place."""
    _run_colors(ky.WARM, s, con, solve_params(config))
    return s


def solve_pass(s: SolverState2D, con: ContactConstraints2D, use_bias: bool,
               config: PhysicsConfig):
    """One bias or relax pass over the colours (reference :314). Updates
    ``s.state`` and ``con.imp`` in place."""
    _run_colors(ky.BIAS if use_bias else ky.RELAX, s, con, solve_params(config))
    return s, con


def solve_restitution(s: SolverState2D, con: ContactConstraints2D, config: PhysicsConfig):
    """Post-substep restitution (reference :464)."""
    params = solve_params(config)
    for _ in range(config.solver.restitution_iterations):
        _run_colors(ky.RESTITUTION, s, con, params)
    return s, con


def store_impulses(contacts: Contacts2D, con: ContactConstraints2D) -> Contacts2D:
    """Persist the accumulated impulses for the next step (reference :550)."""
    c = contacts.capacity
    flat_idx = torch.where(con.bucket_valid.reshape(-1), con.buckets.reshape(-1), c)
    imp = torch.cat([con.base_imp, torch.zeros((1, ky.IMP), device=flat_idx.device)])
    imp[flat_idx] = con.imp.reshape(-1, ky.IMP)
    imp = imp[:c]
    return contacts.replace(
        normal_impulse=imp[:, 0:2].contiguous(),
        tangent_impulse=imp[:, 2:4].contiguous(),
        max_normal_impulse=imp[:, 4:6].contiguous(),
        color=con.color_c,
    )
