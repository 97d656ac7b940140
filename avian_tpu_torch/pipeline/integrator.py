"""Semi-implicit Euler integration (port of ``avian_tpu/pipeline/integrator.py``).

The per-step velocity increments and Kernel C's table of per-body constants
come from Kernel K (``pipeline/solver_body.py::prepare_with_table``). The
substep work, ``integrate_velocities`` (with ``clamp_velocities`` and the
gyroscopic step) and ``integrate_positions``, goes through Kernel C
(``kernels/integrate_bodies.py``), which reads that table.
"""

from dataclasses import dataclass

import torch

from avian_tpu_torch.core.state import Bodies
from avian_tpu_torch.kernels import integrate_bodies as kc
from avian_tpu_torch.pipeline.solver_body import SolverState, prepare_with_table


@dataclass(frozen=True)
class VelocityIncrements:
    """Per-substep velocity increments + damping factors, computed once per
    step (reference ``VelocityIncrements``, integrator.py:37)."""

    lin_inc: torch.Tensor          # [N, 3]
    ang_inc: torch.Tensor          # [N, 3]
    lin_damping_rhs: torch.Tensor  # [N]
    ang_damping_rhs: torch.Tensor  # [N]


def pre_process_velocity_increments(bodies: Bodies, gravity, h: float) -> VelocityIncrements:
    """Velocity increments from gravity, forces and constant actuation
    (reference integrator.py:47): columns of Kernel K's table."""
    table = prepare_with_table(bodies, gravity, h)[1]
    return VelocityIncrements(
        lin_inc=table[:, kc.T_LIN_INC:kc.T_LIN_INC + 3],
        ang_inc=table[:, kc.T_ANG_INC:kc.T_ANG_INC + 3],
        lin_damping_rhs=table[:, kc.T_LIN_DAMP],
        ang_damping_rhs=table[:, kc.T_ANG_DAMP],
    )


def integrate_velocities(s: SolverState, table, h: float) -> SolverState:
    """One substep of velocity integration and speed clamping (reference
    ``integrate_velocities`` + ``clamp_velocities``), through Kernel C."""
    return s.replace(state=kc.integrate_bodies(s.state, table, h, kc.VELOCITIES))


def integrate_positions(s: SolverState, table, h: float) -> SolverState:
    """Advance the delta pose by the velocities (reference
    ``integrate_positions``), through Kernel C."""
    return s.replace(state=kc.integrate_bodies(s.state, table, h, kc.POSITIONS))
