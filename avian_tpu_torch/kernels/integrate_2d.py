"""Kernel Z, ``integrate_2d``: the 2D engine's substep integration, and its
prologue ``prepare_2d``.

``integrate_2d`` replaces ``avian_tpu/dim2/dynamics.py::integrate_velocities``
(:141) with ``clamp_velocities`` (:160) (mode ``VELOCITIES``), and
``integrate_positions`` (:170) (mode ``POSITIONS``): an elementwise pass
over the N bodies' ``[N, 6]`` solver state, with no reduction and no shared
data. The per-body constants come from a table that the prologue builds once
per step: the velocity increments of gravity and forces, the two damping
factors, whether the body integrates, and its speed limits.

``prepare_2d``, the prologue, replaces ``dim2/dynamics.py::prepare`` (:46)
and ``pre_process_velocity_increments`` (:111): from the bodies' columns it
writes the solver state, the masked inverse mass and inertia, the solve mask
and the table, one thread a body. It cannot share a launch with the first
``VELOCITIES`` pass, because Kernel X packs the rows from the prepared state
before the substeps begin.

The CUDA kernels (``csrc/integrate_2d.cu``) give one thread to each body and
compute what the plain versions do, operation for operation, so the two
agree to the bit. On the H100 both are bound by bytes (56 read and 24
written a body a substep; about 70 read and 76 written at the prologue) and,
at 5,000 bodies, by launch latency.

The plain PyTorch versions, ``integrate_2d_twin`` and ``prepare_2d_twin``,
run on CPU tensors; on a CUDA tensor the wrappers launch the kernels or
raise.
"""

import torch

from avian_tpu_torch.core import types

VELOCITIES, POSITIONS = 0, 1

# Table columns, f32[N, 8].
T_LIN_INC = 0    # 0:2 linear velocity increment a substep
T_ANG_INC = 2
T_LIN_DAMP = 3   # 1 / (1 + h * linear damping)
T_ANG_DAMP = 4
T_DYN = 5        # 1 for an awake, active dynamic body
T_MAX_LIN = 6    # speed limits
T_MAX_ANG = 7
T_COLS = 8
STATE_COLS = 6

# Axis locks of ``Bodies2D.locked_axes``.
LOCK_TX, LOCK_TY, LOCK_ROT = 1, 2, 4


def prepare_2d_twin(b, gravity, h):
    """Plain PyTorch version; see ``prepare_2d``."""
    dynamic = b.body_type == types.BodyType.DYNAMIC
    moving = b.active & ~b.sleeping & (b.body_type != types.BodyType.STATIC)
    responds = dynamic & moving
    tmask = torch.stack([torch.where(b.locked_axes & LOCK_TX > 0, 0.0, 1.0),
                         torch.where(b.locked_axes & LOCK_TY > 0, 0.0, 1.0)], -1)
    rmask = torch.where(b.locked_axes & LOCK_ROT > 0, 0.0, 1.0)
    n = b.capacity
    state = torch.cat([
        torch.where(moving[:, None], b.lin_vel, 0.0),
        torch.where(moving, b.ang_vel, 0.0)[:, None],
        torch.zeros((n, 3), device=b.pos.device),
    ], -1)
    inv_mass = torch.where(responds[:, None], b.inv_mass[:, None] * tmask, 0.0)
    inv_inertia = torch.where(responds, b.inv_inertia * rmask, 0.0)
    d1 = dynamic & b.active
    lin_acc = gravity[None, :] * b.gravity_scale[:, None] + (b.force + b.const_force) * b.inv_mass[:, None]
    ang_acc = (b.torque + b.const_torque) * b.inv_inertia
    table = torch.cat([
        torch.where(d1[:, None], lin_acc * tmask * h, 0.0),
        torch.where(d1, ang_acc * rmask * h, 0.0)[:, None],
        (1.0 / (1.0 + h * b.lin_damping))[:, None],
        (1.0 / (1.0 + h * b.ang_damping))[:, None],
        (d1 & ~b.sleeping).float()[:, None],
        b.max_lin_speed[:, None], b.max_ang_speed[:, None],
    ], -1).contiguous()
    return state, inv_mass, inv_inertia, responds.float(), table


def prepare_2d(b, gravity, h):
    """``(state f32[N, 6], inv_mass f32[N, 2], inv_inertia f32[N],
    solve_mask f32[N], table f32[N, 8])`` for one step of substep ``h`` of the
    ``Bodies2D`` ``b`` under ``gravity`` f32[2]: the velocities of the moving
    bodies with a zero delta pose, the locked-axis-masked inverse mass and
    inertia of the bodies that respond to impulses (else 0), and the table
    of ``integrate_2d``."""
    dev = b.pos.device
    if dev.type == "cpu":
        return prepare_2d_twin(b, gravity, h)
    if dev.type != "cuda":
        raise RuntimeError(f"prepare_2d: unsupported device {dev}")
    from avian_tpu_torch.kernels import build

    n = b.capacity
    f32, i32, u8 = torch.float32, torch.int32, torch.bool
    v2 = [(name, getattr(b, name), (n, 2), f32) for name in ("lin_vel", "force", "const_force")]
    s1 = [(name, getattr(b, name), (n,), f32) for name in (
        "ang_vel", "torque", "const_torque", "inv_mass", "inv_inertia", "gravity_scale",
        "lin_damping", "ang_damping", "max_lin_speed", "max_ang_speed")]
    build.require("prepare_2d", dev, v2 + s1 + [
        ("body_type", b.body_type, (n,), i32), ("locked_axes", b.locked_axes, (n,), i32),
        ("active", b.active, (n,), u8), ("sleeping", b.sleeping, (n,), u8),
        ("gravity", gravity, (2,), f32),
    ])
    state = torch.empty((n, STATE_COLS), dtype=f32, device=dev)
    inv_mass = torch.empty((n, 2), dtype=f32, device=dev)
    inv_inertia = torch.empty((n,), dtype=f32, device=dev)
    solve_mask = torch.empty((n,), dtype=f32, device=dev)
    table = torch.empty((n, T_COLS), dtype=f32, device=dev)
    if n:
        build.launch("avian_prepare_2d", dev, n, b.body_type, b.locked_axes, b.active,
                     b.sleeping, *(x for _, x, _, _ in v2), *(x for _, x, _, _ in s1), gravity,
                     state, inv_mass, inv_inertia, solve_mask, table, float(h))
        prepare_2d.launches += 1
    return state, inv_mass, inv_inertia, solve_mask, table


prepare_2d.launches = 0


def integrate_2d_twin(state, table, h, mode):
    """Plain PyTorch version; see ``integrate_2d``."""
    out = state.clone()
    if mode == POSITIONS:
        out[:, 3:5] = state[:, 3:5] + state[:, 0:2] * h
        out[:, 5] = state[:, 5] + state[:, 2] * h
        return out
    dyn = table[:, T_DYN] > 0.0
    lin = torch.where(dyn[:, None],
                      state[:, 0:2] * table[:, T_LIN_DAMP, None] + table[:, T_LIN_INC:T_LIN_INC + 2],
                      state[:, 0:2])
    ang = torch.where(dyn, state[:, 2] * table[:, T_ANG_DAMP] + table[:, T_ANG_INC], state[:, 2])
    speed = torch.sqrt(lin[:, 0] * lin[:, 0] + lin[:, 1] * lin[:, 1])
    scale = torch.clamp(table[:, T_MAX_LIN] / torch.clamp(speed, min=1e-9), max=1.0)
    out[:, 0:2] = lin * scale[:, None]
    max_ang = table[:, T_MAX_ANG]
    out[:, 2] = torch.minimum(torch.maximum(ang, -max_ang), max_ang)
    return out


def integrate_2d(state, table, h, mode):
    """One substep of ``mode`` on ``state`` f32[N, 6] with the per-body
    ``table`` f32[N, 8]; returns the new state."""
    dev = state.device
    if dev.type == "cpu":
        return integrate_2d_twin(state, table, h, mode)
    if dev.type != "cuda":
        raise RuntimeError(f"integrate_2d: unsupported device {dev}")
    if mode not in (VELOCITIES, POSITIONS):
        raise ValueError(f"unknown integrate_2d mode {mode}")
    from avian_tpu_torch.kernels import build

    n = state.shape[0]
    build.require("integrate_2d", dev, (
        ("state", state, (n, 6), torch.float32), ("table", table, (n, T_COLS), torch.float32),
    ))
    out = torch.empty_like(state)
    if n:
        build.launch("avian_integrate_2d", dev, mode, n, state, table, out, float(h))
        integrate_2d.launches += 1
    return out


integrate_2d.launches = 0
