"""XPBD joint solver: fixed, distance, revolute, prismatic, spherical (port
of ``avian_tpu/pipeline/xpbd.py``).

``prepare_joints`` builds the per-step joint rows once (Kernel I's
``joint_rows``, ``kernels/solve_joints.py``), coloured by Kernel G with the
carried colours, as the reference passes ``prev_color``.
``solve_position_constraints`` is one substep of Kernel I: every joint
colour in order, then the velocity projection and joint damping.
``store_joint_forces`` is two multiplies.

Joint frames: the primary axis (hinge, slider, swing) is the local Z of each
body's ``frame_quat``, X the secondary axis of the angle limits.
"""

from dataclasses import dataclass, replace

import torch

from avian_tpu_torch.core.config import PhysicsConfig
from avian_tpu_torch.core.state import Joints, World
from avian_tpu_torch.kernels import solve_joints as ki
from avian_tpu_torch.pipeline.coloring import color_constraints
from avian_tpu_torch.pipeline.solver_body import SolverState


@dataclass(frozen=True)
class JointConstraints:
    """Per-step joint solver data. The reference's float columns are views
    of the packed rows ``data``; ``lam`` is updated in place."""

    jtype: torch.Tensor       # i32[J]
    body_a: torch.Tensor      # i32[J]
    body_b: torch.Tensor      # i32[J]
    mask: torch.Tensor        # f32[J] 1.0 for a joint that is solved
    color: torch.Tensor       # i32[J]
    color_j: torch.Tensor     # i32[J] color, -1 where not solved (persisted)
    data: torch.Tensor        # f32[J, JD] packed rows (kernels/solve_joints.py)
    lam: torch.Tensor         # f32[J, 6] Lagrange totals: positional, rotational
    ovf_order: torch.Tensor   # i32[2J] overflow-colour write order
    ovf_key: torch.Tensor     # i32[2J] body written by each ordered entry
    damp_order: torch.Tensor  # i32[2J] damping write order
    damp_key: torch.Tensor    # i32[2J]

    def replace(self, **kw):
        return replace(self, **kw)

    def _col(self, lo, width=None):
        return self.data[:, lo] if width is None else self.data[:, lo:lo + width]

    world_r1 = property(lambda self: self._col(ki.R1, 3))
    world_r2 = property(lambda self: self._col(ki.R2, 3))
    center_difference = property(lambda self: self._col(ki.CD, 3))
    axis_a = property(lambda self: self._col(ki.AXA, 3))
    axis_b = property(lambda self: self._col(ki.AXB, 3))
    sec_a = property(lambda self: self._col(ki.SECA, 3))
    sec_b = property(lambda self: self._col(ki.SECB, 3))
    rot_difference = property(lambda self: self._col(ki.ROTD, 4))
    compliance = property(lambda self: self._col(ki.COMP, 4))
    limit_min = property(lambda self: self._col(ki.LMIN))
    limit_max = property(lambda self: self._col(ki.LMAX))
    limit_enabled = property(lambda self: self._col(ki.LEN) > 0.0)
    twist_min = property(lambda self: self._col(ki.TMIN))
    twist_max = property(lambda self: self._col(ki.TMAX))
    twist_enabled = property(lambda self: self._col(ki.TEN) > 0.0)
    lin_damping = property(lambda self: self._col(ki.LDAMP))
    ang_damping = property(lambda self: self._col(ki.ADAMP))
    inv_mass_a = property(lambda self: self._col(ki.IMA))
    inv_mass_b = property(lambda self: self._col(ki.IMB))
    inv_mass_vec_a = property(lambda self: self._col(ki.IMVA, 3))
    inv_mass_vec_b = property(lambda self: self._col(ki.IMVB, 3))
    inv_inertia_a = property(lambda self: self._col(ki.IIA, 6))
    inv_inertia_b = property(lambda self: self._col(ki.IIB, 6))
    total_pos_lagrange = property(lambda self: self.lam[:, 0:3])
    total_rot_lagrange = property(lambda self: self.lam[:, 3:6])


def prepare_joints(world: World, s: SolverState, config: PhysicsConfig) -> JointConstraints:
    """Per-step joint rows (reference ``prepare_joints``, xpbd.py:89): the
    rows from Kernel I's ``joint_rows``, the colours from Kernel G with the
    carried ones, and the write orders of the shared-body passes."""
    j = world.joints
    n = world.bodies.capacity
    data, mask, dyn_a, dyn_b = ki.joint_rows(j, world.bodies, s.inv_mass, s.inv_inertia,
                                             s.solve_mask)
    color, _ = color_constraints(
        j.body_a, j.body_b, dyn_a, dyn_b, mask, n, config.max_colors, prev_color=j.color
    )
    last = config.max_colors - 1
    ovf_order, ovf_key = ki.entry_order(j.body_a, j.body_b, data, mask & (color == last), n)
    damp_order, damp_key = ki.entry_order(j.body_a, j.body_b, data, mask, n)
    return JointConstraints(
        jtype=j.jtype, body_a=j.body_a, body_b=j.body_b, mask=mask.float(), color=color,
        color_j=torch.where(mask, color, -1).to(torch.int32), data=data,
        lam=torch.zeros((j.capacity, ki.LAM), dtype=torch.float32, device=data.device),
        ovf_order=ovf_order, ovf_key=ovf_key, damp_order=damp_order, damp_key=damp_key,
    )


def solve_position_constraints(s: SolverState, jc: JointConstraints, h: float,
                               config: PhysicsConfig) -> SolverState:
    """One substep of the joint solve: every colour in order, then the
    velocity projection from the delta pose's change and joint damping
    (reference :229). Updates ``s.state`` and ``jc.lam`` in place."""
    return solve_with_custom(s, jc, h, config)[0]


def solve_with_custom(s: SolverState, jc, h: float, config: PhysicsConfig, custom=None,
                      custom_data=None):
    """``solve_position_constraints`` with a user constraint (reference :229,
    ``custom``/``custom_data``): Kernel I's colours, then ``custom.solve(s,
    custom_data, h)``, then Kernel I's velocity projection, so that the
    projection sees the custom deltas. ``jc`` is None for a world without
    joint slots; with a custom constraint the projection still runs. Returns
    ``(s, custom_data)``."""
    has_rows = jc is not None and jc.data.shape[0] > 0
    if not has_rows and custom is None:
        return s, custom_data
    pre = s.state[:, 6:13].clone()
    if has_rows:
        last = config.max_colors - 1
        for c in range(config.max_colors):
            ki.joint_color(c, c == last, s.state, jc.data, jc.lam, jc.jtype, jc.body_a,
                           jc.body_b, jc.color, jc.mask, jc.ovf_order, jc.ovf_key, h * h)
    if custom is not None:
        s, custom_data = custom.solve(s, custom_data, h)
    if has_rows:
        rows = (jc.data, jc.body_a, jc.body_b, jc.mask, jc.damp_order, jc.damp_key)
    else:
        dev = s.state.device
        i32 = torch.zeros((0,), dtype=torch.int32, device=dev)
        rows = (torch.zeros((0, ki.JD), dtype=torch.float32, device=dev), i32, i32,
                torch.zeros((0,), dtype=torch.float32, device=dev), i32, i32)
    ki.joint_velocities(s.state, pre, *rows, h)
    return s, custom_data


def store_joint_forces(joints: Joints, jc: JointConstraints, config: PhysicsConfig) -> Joints:
    """JointForces readback ``f = lambda_total * substeps / h^2`` (reference
    :496) and the colours carried to the next step."""
    h = config.substep_dt
    return joints.replace(total_lambda=jc.lam * (config.substeps / (h * h)), color=jc.color_j)
