"""Transient solver-body state (port of ``avian_tpu/pipeline/solver_body.py``).

The mutable per-body state of the substep loop is ONE contiguous ``f32[N, 13]``
tensor, ``state = [lin_vel | ang_vel | delta_pos | delta_quat]``: the layout
the reference's solve pass packs per pass (solver.py:421-423). Kernels C and
D read and write it directly; ``lin_vel`` etc. are column views.
"""

from dataclasses import dataclass, replace

import torch

from avian_tpu_torch.core import types
from avian_tpu_torch.core.state import Bodies
from avian_tpu_torch.math import quat as quat_m
from avian_tpu_torch.math import sym3

# Column offsets of the packed state.
LIN, ANG, DPOS, DQUAT, STATE_COLS = 0, 3, 6, 9, 13


@dataclass(frozen=True)
class SolverState:
    """Per-body solver state for one physics step."""

    state: torch.Tensor        # f32[N, 13] lin_vel, ang_vel, delta_pos, delta_quat
    inv_mass: torch.Tensor     # f32[N, 3] effective per-axis inverse mass
    inv_inertia: torch.Tensor  # f32[N, 6] effective world inverse inertia
    solve_mask: torch.Tensor   # f32[N] 1.0 if the body responds to impulses

    def replace(self, **kw):
        return replace(self, **kw)

    @property
    def lin_vel(self):
        return self.state[:, LIN:LIN + 3]

    @property
    def ang_vel(self):
        return self.state[:, ANG:ANG + 3]

    @property
    def delta_pos(self):
        return self.state[:, DPOS:DPOS + 3]

    @property
    def delta_quat(self):
        return self.state[:, DQUAT:DQUAT + 4]


def _lock_mask(locked_axes, bits):
    b = torch.stack([(locked_axes & bit) for bit in bits], dim=-1)
    return torch.where(b > 0, 0.0, 1.0)


def locked_translation_mask(locked_axes):
    """f32[N, 3]: 0 where the translation axis is locked, else 1."""
    return _lock_mask(locked_axes, (types.LOCK_TX, types.LOCK_TY, types.LOCK_TZ))


def locked_rotation_mask(locked_axes):
    """f32[N, 3]: 0 where the rotation axis is locked, else 1."""
    return _lock_mask(locked_axes, (types.LOCK_RX, types.LOCK_RY, types.LOCK_RZ))


def mask_inertia(inertia6, rmask):
    """Zero rows+columns of a symmetric tensor for locked rotation axes."""
    x, y, z = rmask[..., 0], rmask[..., 1], rmask[..., 2]
    m = torch.stack([x * x, y * y, z * z, x * y, x * z, y * z], dim=-1)
    return inertia6 * m


def world_inv_inertia(bodies: Bodies):
    """World-frame inverse inertia ``R I^-1 R^T`` as sym6."""
    return sym3.rotate(bodies.inv_inertia, quat_m.to_mat3(bodies.quat))


def moving_mask(bodies: Bodies):
    return bodies.active & ~bodies.sleeping & (
        bodies.body_type != types.BodyType.STATIC
    )


def prepare(bodies: Bodies) -> SolverState:
    """Build the solver state (reference ``prepare`` solver_body.py:85)."""
    n = bodies.capacity
    dynamic = bodies.body_type == types.BodyType.DYNAMIC
    moving = moving_mask(bodies)
    responds = dynamic & moving
    tmask = locked_translation_mask(bodies.locked_axes)
    rmask = locked_rotation_mask(bodies.locked_axes)
    inv_mass = torch.where(
        responds[:, None], bodies.inv_mass[:, None] * tmask, 0.0
    )
    inv_inertia = torch.where(
        responds[:, None], mask_inertia(world_inv_inertia(bodies), rmask), 0.0
    )
    vel_mask = moving[:, None]
    dq = quat_m.identity((n,), device=bodies.pos.device)
    state = torch.cat(
        [
            torch.where(vel_mask, bodies.lin_vel, 0.0),
            torch.where(vel_mask, bodies.ang_vel, 0.0),
            torch.zeros_like(bodies.pos),
            dq,
        ],
        dim=-1,
    ).contiguous()
    return SolverState(
        state=state,
        inv_mass=inv_mass,
        inv_inertia=inv_inertia,
        solve_mask=responds.float(),
    )


def writeback(bodies: Bodies, s: SolverState) -> Bodies:
    """Apply the delta pose about the center of mass (reference
    ``writeback`` solver_body.py:117)."""
    old_world_com = quat_m.rotate(bodies.quat, bodies.com)
    new_quat = quat_m.fast_renormalize(quat_m.mul(s.delta_quat, bodies.quat))
    new_world_com = quat_m.rotate(new_quat, bodies.com)
    new_pos = bodies.pos + s.delta_pos + old_world_com - new_world_com
    m1 = moving_mask(bodies)[:, None]
    return bodies.replace(
        pos=torch.where(m1, new_pos, bodies.pos),
        quat=torch.where(m1, new_quat, bodies.quat),
        lin_vel=torch.where(m1, s.lin_vel, bodies.lin_vel),
        ang_vel=torch.where(m1, s.ang_vel, bodies.ang_vel),
    )
