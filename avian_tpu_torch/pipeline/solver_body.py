"""Transient solver-body state (port of ``avian_tpu/pipeline/solver_body.py``).

The mutable per-body state of the substep loop is ONE contiguous ``f32[N, 13]``
tensor, ``state = [lin_vel | ang_vel | delta_pos | delta_quat]``: the layout
the reference's solve pass packs per pass (solver.py:421-423). Kernels C, D
and I read and write it directly; ``lin_vel`` etc. are column views. Kernel
K (``kernels/body_pass.py``) builds it and writes it back.
"""

from dataclasses import dataclass, replace

import torch

from avian_tpu_torch.core.state import Bodies
from avian_tpu_torch.kernels import body_pass as kk

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


def prepare_with_table(bodies: Bodies, gravity, h: float):
    """``(SolverState, table)``: the solver state of one step (reference
    ``prepare`` solver_body.py:85) and Kernel C's per-step table with the
    velocity increments (reference ``pre_process_velocity_increments``),
    both from one launch of Kernel K (``kernels/body_pass.py``). ``gravity``
    is f32[3] for a world, f32[B, 3] for B scenes of N / B bodies."""
    state, inv_mass, inv_inertia, solve_mask, table = kk.prepare_bodies(
        bodies, gravity.reshape(-1, 3), h)
    return SolverState(state=state, inv_mass=inv_mass, inv_inertia=inv_inertia,
                       solve_mask=solve_mask), table


def prepare(bodies: Bodies) -> SolverState:
    """The solver state alone (reference ``prepare`` solver_body.py:85)."""
    gravity = torch.zeros((3,), dtype=torch.float32, device=bodies.pos.device)
    return prepare_with_table(bodies, gravity, 0.0)[0]


def writeback(bodies: Bodies, s: SolverState) -> Bodies:
    """Apply the delta pose about the center of mass and clear the force
    and torque accumulators (reference ``writeback`` solver_body.py:117 and
    the force clear of step.py), through Kernel K."""
    pos, quat, lin_vel, ang_vel, force, torque = kk.writeback_bodies(bodies, s.state)
    return bodies.replace(pos=pos, quat=quat, lin_vel=lin_vel, ang_vel=ang_vel,
                          force=force, torque=torque)
