"""Semi-implicit Euler integration (port of ``avian_tpu/pipeline/integrator.py``).

``pre_process_velocity_increments`` and ``integration_table`` run once per
step in plain PyTorch. The substep work, ``integrate_velocities`` (with
``clamp_velocities`` and the gyroscopic step) and ``integrate_positions``,
goes through Kernel C (``kernels/integrate_bodies.py``), which reads the
packed per-step table built here.
"""

from dataclasses import dataclass

import torch

from avian_tpu_torch.core import types
from avian_tpu_torch.core.state import Bodies
from avian_tpu_torch.kernels import integrate_bodies as kc
from avian_tpu_torch.math import quat as quat_m
from avian_tpu_torch.math import sym3
from avian_tpu_torch.pipeline.solver_body import (
    SolverState,
    locked_rotation_mask,
    locked_translation_mask,
    world_inv_inertia,
)


@dataclass(frozen=True)
class VelocityIncrements:
    """Per-substep velocity increments + damping factors, computed once per
    step (reference ``VelocityIncrements``, integrator.py:37)."""

    lin_inc: torch.Tensor          # [N, 3]
    ang_inc: torch.Tensor          # [N, 3]
    lin_damping_rhs: torch.Tensor  # [N]
    ang_damping_rhs: torch.Tensor  # [N]


def pre_process_velocity_increments(
    bodies: Bodies, gravity, h: float
) -> VelocityIncrements:
    """Velocity increments from gravity, forces and constant actuation
    (reference integrator.py:47)."""
    dynamic = (bodies.body_type == types.BodyType.DYNAMIC) & bodies.active
    tmask = locked_translation_mask(bodies.locked_axes)
    rmask = locked_rotation_mask(bodies.locked_axes)
    q = bodies.quat
    force = (
        bodies.force + bodies.const_force
        + quat_m.rotate(q, bodies.const_local_force)
    )
    lin_acc = (
        gravity[None, :] * bodies.gravity_scale[:, None]
        + force * bodies.inv_mass[:, None]
        + bodies.const_lin_acc
        + quat_m.rotate(q, bodies.const_local_lin_acc)
    )
    torque = (
        bodies.torque + bodies.const_torque
        + quat_m.rotate(q, bodies.const_local_torque)
    )
    ang_acc = (
        sym3.mv(world_inv_inertia(bodies), torque)
        + bodies.const_ang_acc
        + quat_m.rotate(q, bodies.const_local_ang_acc)
    )
    d1 = dynamic[:, None]
    return VelocityIncrements(
        lin_inc=torch.where(d1, lin_acc * tmask * h, 0.0),
        ang_inc=torch.where(d1, ang_acc * rmask * h, 0.0),
        lin_damping_rhs=1.0 / (1.0 + h * bodies.lin_damping),
        ang_damping_rhs=1.0 / (1.0 + h * bodies.ang_damping),
    )


def integration_table(bodies: Bodies, inc: VelocityIncrements):
    """The per-step constants Kernel C reads, one ``f32[N, 22]`` row per
    body (column layout in ``kernels/integrate_bodies.py``)."""
    is_dyn = (
        (bodies.body_type == types.BodyType.DYNAMIC)
        & bodies.active
        & ~bodies.sleeping
    )
    return torch.cat(
        [
            inc.lin_inc,
            inc.ang_inc,
            inc.lin_damping_rhs[:, None],
            inc.ang_damping_rhs[:, None],
            is_dyn.float()[:, None],
            bodies.gyroscopic.float()[:, None],
            bodies.quat,
            bodies.inv_inertia,
            bodies.max_lin_speed[:, None],
            bodies.max_ang_speed[:, None],
        ],
        dim=-1,
    ).contiguous()


def integrate_velocities(s: SolverState, table, h: float) -> SolverState:
    """One substep of velocity integration and speed clamping (reference
    ``integrate_velocities`` + ``clamp_velocities``), through Kernel C."""
    return s.replace(state=kc.integrate_bodies(s.state, table, h, kc.VELOCITIES))


def integrate_positions(s: SolverState, table, h: float) -> SolverState:
    """Advance the delta pose by the velocities (reference
    ``integrate_positions``), through Kernel C."""
    return s.replace(state=kc.integrate_bodies(s.state, table, h, kc.POSITIONS))
