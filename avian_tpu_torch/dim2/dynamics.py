"""2D solver bodies and semi-implicit Euler integration (port of
``avian_tpu/dim2/dynamics.py``).

The solver state is one ``[N, 6]`` tensor per step, the reference's packed
body row: linear velocity (2), angular velocity, delta position (2), delta
angle. Every pass is a kernel: ``prepare`` (the reference's ``prepare`` and
``pre_process_velocity_increments``) is Kernel Z's prologue, the substep
work, ``integrate_velocities`` (with ``clamp_velocities``) and
``integrate_positions``, is Kernel Z (``kernels/integrate_2d.py``), and
``writeback`` with the force clear is Kernel K's 2D pass
(``kernels/body_pass.py::writeback_2d``).
"""

from dataclasses import dataclass, replace

import torch

from avian_tpu_torch.dim2.state import Bodies2D
from avian_tpu_torch.kernels import body_pass as kk
from avian_tpu_torch.kernels import integrate_2d as kz


@dataclass(frozen=True)
class SolverState2D:
    state: torch.Tensor        # f32[N, 6]
    inv_mass: torch.Tensor     # f32[N, 2] per axis, locked axes masked
    inv_inertia: torch.Tensor  # f32[N]
    solve_mask: torch.Tensor   # f32[N] 1 for a body that responds to impulses

    def replace(self, **kw):
        return replace(self, **kw)

    @property
    def lin_vel(self):
        return self.state[:, 0:2]

    @property
    def ang_vel(self):
        return self.state[:, 2]

    @property
    def delta_pos(self):
        return self.state[:, 3:5]

    @property
    def delta_angle(self):
        return self.state[:, 5]


def prepare(b: Bodies2D, gravity, h: float):
    """Solver bodies of this step (reference :46) and Kernel Z's per-body
    table f32[N, 8] (the velocity increments of reference :111, whether the
    body integrates, its speed limits)."""
    state, inv_mass, inv_inertia, solve_mask, table = kz.prepare_2d(b, gravity, h)
    return SolverState2D(state=state, inv_mass=inv_mass, inv_inertia=inv_inertia,
                         solve_mask=solve_mask), table


def integrate_velocities(s: SolverState2D, table, h: float) -> SolverState2D:
    """Reference ``integrate_velocities`` + ``clamp_velocities``, Kernel Z."""
    return s.replace(state=kz.integrate_2d(s.state, table, h, kz.VELOCITIES))


def integrate_positions(s: SolverState2D, table, h: float) -> SolverState2D:
    """Reference ``integrate_positions``, Kernel Z."""
    return s.replace(state=kz.integrate_2d(s.state, table, h, kz.POSITIONS))


def writeback(b: Bodies2D, s: SolverState2D) -> Bodies2D:
    """Apply the delta pose, rotating about the COM (reference :80), and
    clear the force and torque accumulators."""
    pos, angle, lin_vel, ang_vel, force, torque = kk.writeback_2d(b, s.state)
    return b.replace(pos=pos, angle=angle, lin_vel=lin_vel, ang_vel=ang_vel, force=force,
                     torque=torque)
