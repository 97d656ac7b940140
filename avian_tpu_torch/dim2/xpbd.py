"""2D XPBD joint solver: fixed, distance, revolute, prismatic (port of
``avian_tpu/dim2/xpbd.py``).

``prepare_joints`` builds the per-step joint rows once (Kernel AA's
``joint_rows_2d``, ``kernels/solve_joints_2d.py``), coloured by Kernel G
with the carried colours, as the reference passes ``prev_color``.
``solve_position_constraints`` is one substep: every joint colour in order
(Kernel AA's ``joint_color_2d``), then a custom joint's solve, then the
velocity projection from the delta pose's change and joint damping
(``joint_velocities_2d``). ``store_joint_forces`` is two multiplies.

The reference runs the projection and damping whenever the world has joint
slots, even with no joint solved, where they add exact zeros; the step skips
the joint stages when no joint is active (``dim2/step.py``), which gives the
same results to the bit apart from the sign of a zero.
"""

from dataclasses import dataclass, replace

import torch

from avian_tpu_torch.core.config import PhysicsConfig
from avian_tpu_torch.dim2.broadphase import Poses2D
from avian_tpu_torch.dim2.dynamics import SolverState2D
from avian_tpu_torch.dim2.state import Joints2D, World2D
from avian_tpu_torch.kernels import solve_joints_2d as kaa
from avian_tpu_torch.pipeline.coloring import color_constraints


@dataclass(frozen=True)
class JointConstraints2D:
    """Per-step joint solver data. The reference's float columns are views
    of the packed rows ``data``; ``lam`` is updated in place."""

    jtype: torch.Tensor       # i32[J]
    body_a: torch.Tensor      # i32[J]
    body_b: torch.Tensor      # i32[J]
    mask: torch.Tensor        # f32[J] 1.0 for a joint that is solved
    color: torch.Tensor       # i32[J]
    color_j: torch.Tensor     # i32[J] color, -1 where not solved (persisted)
    data: torch.Tensor        # f32[J, JD] packed rows (kernels/solve_joints_2d.py)
    lam: torch.Tensor         # f32[J, 3] Lagrange totals: positional (2), rotational
    ovf_order: torch.Tensor   # i32[2J] overflow-colour write order
    ovf_key: torch.Tensor     # i32[2J] body written by each ordered entry
    damp_order: torch.Tensor  # i32[2J] damping write order
    damp_key: torch.Tensor    # i32[2J]

    def replace(self, **kw):
        return replace(self, **kw)

    def _col(self, lo, width=None):
        return self.data[:, lo] if width is None else self.data[:, lo:lo + width]

    world_r1 = property(lambda self: self._col(kaa.R1, 2))
    world_r2 = property(lambda self: self._col(kaa.R2, 2))
    center_difference = property(lambda self: self._col(kaa.CD, 2))
    base_angle = property(lambda self: self._col(kaa.BASE))
    axis_world = property(lambda self: self._col(kaa.AXIS, 2))
    compliance = property(lambda self: self._col(kaa.COMP, 4))
    limit_min = property(lambda self: self._col(kaa.LMIN))
    limit_max = property(lambda self: self._col(kaa.LMAX))
    limit_enabled = property(lambda self: self._col(kaa.LEN) > 0.0)
    lin_damping = property(lambda self: self._col(kaa.LDAMP))
    ang_damping = property(lambda self: self._col(kaa.ADAMP))
    inv_mass_a = property(lambda self: self._col(kaa.IMA))
    inv_mass_b = property(lambda self: self._col(kaa.IMB))
    inv_mass_vec_a = property(lambda self: self._col(kaa.IMVA, 2))
    inv_mass_vec_b = property(lambda self: self._col(kaa.IMVB, 2))
    inv_inertia_a = property(lambda self: self._col(kaa.IIA))
    inv_inertia_b = property(lambda self: self._col(kaa.IIB))
    total_pos_lagrange = property(lambda self: self.lam[:, 0:2])
    total_rot_lagrange = property(lambda self: self.lam[:, 2])


def prepare_joints(world: World2D, s: SolverState2D, poses: Poses2D,
                   config: PhysicsConfig) -> JointConstraints2D:
    """Per-step joint rows (reference ``prepare_joints`` :71): the rows from
    Kernel AA's ``joint_rows_2d`` (the bodies' cosines and sines from this
    step's ``poses``), the colours from Kernel G with the carried ones, and
    the write orders of the shared-body passes."""
    j = world.joints
    n = world.bodies.capacity
    axis_cs = torch.stack([torch.cos(j.axis_angle), torch.sin(j.axis_angle)], -1).contiguous()
    data, mask, dyn_a, dyn_b = kaa.joint_rows_2d(j, world.bodies, poses.body_cs.contiguous(),
                                                 axis_cs, s.inv_mass, s.inv_inertia,
                                                 s.solve_mask)
    color, _ = color_constraints(j.body_a, j.body_b, dyn_a, dyn_b, mask, n, config.max_colors,
                                 prev_color=j.color)
    last = config.max_colors - 1
    ovf_order, ovf_key = kaa.entry_order_2d(j.body_a, j.body_b, data, mask & (color == last), n)
    damp_order, damp_key = kaa.entry_order_2d(j.body_a, j.body_b, data, mask, n)
    return JointConstraints2D(
        jtype=j.jtype, body_a=j.body_a, body_b=j.body_b, mask=mask.float(), color=color,
        color_j=torch.where(mask, color, -1).to(torch.int32), data=data,
        lam=torch.zeros((j.capacity, kaa.LAM), dtype=torch.float32, device=data.device),
        ovf_order=ovf_order, ovf_key=ovf_key, damp_order=damp_order, damp_key=damp_key,
    )


def solve_position_constraints(s: SolverState2D, jc, h: float, config: PhysicsConfig,
                               custom=None, custom_data=None):
    """One substep of the joint solve (reference :168): every colour in
    order, a custom joint's ``solve``, then the velocity projection from the
    delta pose's change since before the colours and joint damping. The
    built-in passes update ``s.state`` and ``jc.lam`` in place. Returns
    ``(s, custom_data)``."""
    pre = s.state[:, 3:6].clone()
    if jc is not None:
        last = config.max_colors - 1
        for c in range(config.max_colors):
            kaa.joint_color_2d(c, c == last, s.state, jc.data, jc.lam, jc.jtype, jc.body_a,
                               jc.body_b, jc.color, jc.mask, jc.ovf_order, jc.ovf_key, h * h)
    if custom is not None:
        s, custom_data = custom.solve(s, custom_data, h)
    if jc is None:
        # The projection alone: no joint rows, so no damping.
        dev = s.state.device
        i32 = torch.zeros((0,), dtype=torch.int32, device=dev)
        kaa.joint_velocities_2d(s.state, pre, torch.zeros((0, kaa.JD), device=dev), i32, i32,
                                torch.zeros((0,), device=dev), i32, i32, h)
    else:
        kaa.joint_velocities_2d(s.state, pre, jc.data, jc.body_a, jc.body_b, jc.mask,
                                jc.damp_order, jc.damp_key, h)
    return s, custom_data


def store_joint_forces(joints: Joints2D, jc: JointConstraints2D,
                       config: PhysicsConfig) -> Joints2D:
    """JointForces readback ``f = lambda_total * substeps / h^2`` (reference
    :344) and the colours carried to the next step."""
    h = config.substep_dt
    return joints.replace(total_lambda=jc.lam * (config.substeps / (h * h)), color=jc.color_j)
