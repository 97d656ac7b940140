"""Kernel C, ``integrate_bodies``: the per-body substep integration.

Replaces ``avian_tpu/pipeline/integrator.py::integrate_velocities`` together
with ``clamp_velocities`` (integrator.py:97-158, gyroscopic step :132-150) in
mode ``VELOCITIES``, and ``integrate_positions`` (:161-167) in mode
``POSITIONS``.

On the H100 this pass is bound by its f32 loads and stores: per body it
reads the 13-column state and, for velocities, a 22-column table of
per-step constants, and its arithmetic (damping, the gyroscopic update, a
quaternion step) stays in registers. It is elementwise across bodies, so
it is a Triton kernel (``integrate_bodies_triton.py``): one
program per block of bodies, columns loaded with masked strided loads, no
shared memory and nothing shared between bodies. The sine and cosine of
``from_scaled_axis`` are libdevice's precise ``sinf``/``cosf`` (the
routines ``torch.sin``/``torch.cos`` use on CUDA) rather than Triton's
approximate ``sin``/``cos``, and square roots and divisions are
IEEE-rounded, so the kernel agrees with the plain version below to a few
units in the last place.

The plain PyTorch version of the same function, ``integrate_bodies_twin``,
runs whenever the state lies on the CPU; on a CUDA tensor the wrapper
launches the kernel or raises.
"""

import torch

from avian_tpu_torch.math import quat as quat_m
from avian_tpu_torch.math import sym3, vec

VELOCITIES = 0
POSITIONS = 1

# Columns of the per-step body table built by
# ``pipeline.integrator.integration_table``.
T_LIN_INC, T_ANG_INC = 0, 3
T_LIN_DAMP, T_ANG_DAMP = 6, 7
T_DYN, T_GYRO = 8, 9
T_QUAT = 10
T_INV_I = 14
T_MAX_LIN, T_MAX_ANG = 20, 21
TABLE_COLS = 22
STATE_COLS = 13


def solve_gyroscopic_torque(ang_vel, rot_quat, local_inv_inertia6, dt):
    """Semi-implicit gyroscopic update with angular-momentum-magnitude
    clamping (reference integrator.py:132)."""
    local_w = quat_m.rotate_inv(rot_quat, ang_vel)
    local_inertia = sym3.inverse_or_zero(local_inv_inertia6)
    local_momentum = sym3.mv(local_inertia, local_w)
    new_momentum = local_momentum - dt * vec.cross(local_w, local_momentum)
    new_sq = vec.length_sq(new_momentum)
    scale = torch.where(
        new_sq > 0.0,
        torch.sqrt(
            vec.length_sq(local_momentum) / torch.clamp(new_sq, min=1e-30)
        ),
        0.0,
    )
    new_momentum = new_momentum * scale[..., None]
    return quat_m.rotate(rot_quat, sym3.mv(local_inv_inertia6, new_momentum))


def integrate_bodies_twin(state, table, h, mode):
    """Plain PyTorch version: returns the new ``f32[N, 13]`` state."""
    lin = state[:, 0:3]
    ang = state[:, 3:6]
    dpos = state[:, 6:9]
    dq = state[:, 9:13]
    if mode == VELOCITIES:
        dyn = table[:, T_DYN] > 0.0
        gyro = dyn & (table[:, T_GYRO] > 0.0)
        d1 = dyn[:, None]
        lin = torch.where(
            d1,
            lin * table[:, T_LIN_DAMP, None] + table[:, T_LIN_INC:T_LIN_INC + 3],
            lin,
        )
        ang = torch.where(
            d1,
            ang * table[:, T_ANG_DAMP, None] + table[:, T_ANG_INC:T_ANG_INC + 3],
            ang,
        )
        rot = quat_m.mul(dq, table[:, T_QUAT:T_QUAT + 4])
        ang_gyro = solve_gyroscopic_torque(
            ang, rot, table[:, T_INV_I:T_INV_I + 6], h
        )
        ang = torch.where(gyro[:, None], ang_gyro, ang)
        lin = vec.clamp_length_max(lin, table[:, T_MAX_LIN])
        ang = vec.clamp_length_max(ang, table[:, T_MAX_ANG])
        return torch.cat([lin, ang, dpos, dq], dim=-1)
    if mode == POSITIONS:
        dpos = dpos + lin * h
        dq = quat_m.mul(quat_m.from_scaled_axis(ang * h), dq)
        return torch.cat([lin, ang, dpos, dq], dim=-1)
    raise ValueError(f"unknown integrate_bodies mode {mode}")


_BLOCK = 128


def integrate_bodies(state, table, h, mode):
    """Integrate one substep; returns a new ``f32[N, 13]`` state.

    ``mode``: ``VELOCITIES`` (damping, increments, gyroscopic torque,
    speed clamps) or ``POSITIONS`` (delta pose)."""
    if state.device.type == "cpu":
        return integrate_bodies_twin(state, table, h, mode)
    n = state.shape[0]
    if state.device.type != "cuda":
        raise RuntimeError(f"integrate_bodies: unsupported device {state.device}")
    if table.device != state.device:
        raise ValueError("integrate_bodies: state and table on different devices")
    if state.dtype != torch.float32 or table.dtype != torch.float32:
        raise TypeError("integrate_bodies: state and table must be float32")
    if state.shape != (n, STATE_COLS) or table.shape != (n, TABLE_COLS):
        raise ValueError(
            f"integrate_bodies: shapes {tuple(state.shape)}, "
            f"{tuple(table.shape)}; want ({n}, 13), ({n}, 22)"
        )
    if not (state.is_contiguous() and table.is_contiguous()):
        raise ValueError("integrate_bodies: tensors must be contiguous")
    if mode not in (VELOCITIES, POSITIONS):
        raise ValueError(f"unknown integrate_bodies mode {mode}")
    from avian_tpu_torch.kernels import integrate_bodies_triton as tk

    out = torch.empty_like(state)
    grid = ((n + _BLOCK - 1) // _BLOCK,)
    with torch.cuda.device(state.device):
        tk.integrate_bodies_kernel[grid](
            state, table, out, n, float(h),
            MODE=mode, BLOCK=_BLOCK, num_warps=4,
        )
    integrate_bodies.launches += 1
    return out


integrate_bodies.launches = 0
