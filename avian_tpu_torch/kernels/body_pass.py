"""Kernel K, ``body_pass``: the per-body passes at either end of the solver.

Replaces ``avian_tpu/pipeline/solver_body.py::prepare`` (:85) and
``writeback`` (:117) and ``avian_tpu/pipeline/integrator.py::
pre_process_velocity_increments`` (:47), with the per-step table Kernel C
reads and the force clear of ``pipeline/step.py`` (:156-161). Two entry
points, one thread per body each:

- ``prepare_bodies``: the effective inverse mass and world inverse inertia
  (axis locks applied, zero for a body that does not respond), the packed
  solver state ``[lin_vel | ang_vel | delta_pos | delta_quat]``, the velocity
  increments of gravity, forces and constant actuation, and Kernel C's
  ``f32[N, 22]`` integration table;
- ``writeback_bodies``: the delta pose applied about the centre of mass with
  the fast renormalisation, the velocities written back, and zeroed force
  and torque accumulators.

Each is a fused elementwise pass with no gathers and nothing shared between
bodies; on the H100 both are bound by bytes (about 240 read and 208 written
per body at prepare, 150 and 88 at writeback). The world inverse inertia
``R I^-1 R^T`` and every sum are spelled in the plain version's order and
the file is compiled without fused multiply-adds, so the kernel agrees with
the plain version to the bit.

``writeback_2d`` is the same pass for the native 2D engine: it replaces
``avian_tpu/dim2/dynamics.py::writeback`` (:80) and the force clear of
``dim2/step.py`` (:100-105), with the new angle's ``cosf``/``sinf`` in the
kernel (the device code is ``d2::writeback_body_2d`` in ``csrc/dim2.cuh``).
Its prologue, the 2D ``prepare``, is Kernel Z's (``integrate_2d.prepare_2d``).

Gravity is f32[B, 3], one row for each of B scenes of N / B bodies (B = 1
for a world, B > 1 for the flat world that ``parallel.make_batched_step``
steps): each body takes its own scene's, as ``jax.vmap`` of the reference
gives each scene its own.

The plain PyTorch versions, ``prepare_bodies_twin``, ``writeback_bodies_twin``
and ``writeback_2d_twin``, run on CPU tensors; on a CUDA tensor the wrappers
launch the kernels or raise.
"""

import torch

from avian_tpu_torch.core import types
from avian_tpu_torch.math import quat as quat_m
from avian_tpu_torch.math import sym3

TABLE_COLS = 22
STATE_COLS = 13


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


def world_inv_inertia(bodies):
    """World-frame inverse inertia ``R I^-1 R^T`` as sym6."""
    return sym3.rotate(bodies.inv_inertia, quat_m.to_mat3(bodies.quat))


def moving_mask(bodies):
    return bodies.active & ~bodies.sleeping & (bodies.body_type != types.BodyType.STATIC)


def _scene_size(gravity, n):
    """N / B: the bodies of each scene of the gravity rows ``gravity`` f32[B, 3]."""
    if gravity.dim() != 2 or gravity.shape[0] == 0 or n % gravity.shape[0]:
        raise ValueError(f"prepare_bodies: {n} bodies in scenes of gravity "
                         f"{tuple(gravity.shape)}")
    return max(n // gravity.shape[0], 1)


def prepare_bodies_twin(bodies, gravity, h):
    """Plain PyTorch version; see ``prepare_bodies``."""
    n = bodies.capacity
    body_gravity = gravity[torch.arange(n, device=gravity.device) // _scene_size(gravity, n)]
    b = bodies
    dynamic = b.body_type == types.BodyType.DYNAMIC
    moving = moving_mask(b)
    responds = dynamic & moving
    tmask = locked_translation_mask(b.locked_axes)
    rmask = locked_rotation_mask(b.locked_axes)
    w_inv_i = world_inv_inertia(b)
    inv_mass = torch.where(responds[:, None], b.inv_mass[:, None] * tmask, 0.0)
    inv_inertia = torch.where(responds[:, None], mask_inertia(w_inv_i, rmask), 0.0)
    vel_mask = moving[:, None]
    state = torch.cat(
        [
            torch.where(vel_mask, b.lin_vel, 0.0),
            torch.where(vel_mask, b.ang_vel, 0.0),
            torch.zeros_like(b.pos),
            quat_m.identity((n,), device=b.pos.device),
        ],
        dim=-1,
    ).contiguous()

    # Velocity increments (reference integrator.py:47).
    q = b.quat
    force = b.force + b.const_force + quat_m.rotate(q, b.const_local_force)
    lin_acc = (
        body_gravity * b.gravity_scale[:, None]
        + force * b.inv_mass[:, None]
        + b.const_lin_acc
        + quat_m.rotate(q, b.const_local_lin_acc)
    )
    torque = b.torque + b.const_torque + quat_m.rotate(q, b.const_local_torque)
    ang_acc = (
        sym3.mv(w_inv_i, torque) + b.const_ang_acc + quat_m.rotate(q, b.const_local_ang_acc)
    )
    d1 = (dynamic & b.active)[:, None]
    is_dyn = dynamic & b.active & ~b.sleeping
    table = torch.cat(
        [
            torch.where(d1, lin_acc * tmask * h, 0.0),
            torch.where(d1, ang_acc * rmask * h, 0.0),
            (1.0 / (1.0 + h * b.lin_damping))[:, None],
            (1.0 / (1.0 + h * b.ang_damping))[:, None],
            is_dyn.float()[:, None],
            b.gyroscopic.float()[:, None],
            b.quat,
            b.inv_inertia,
            b.max_lin_speed[:, None],
            b.max_ang_speed[:, None],
        ],
        dim=-1,
    ).contiguous()
    return state, inv_mass, inv_inertia, responds.float(), table


def prepare_bodies(bodies, gravity, h):
    """``(state f32[N, 13], inv_mass f32[N, 3], inv_inertia f32[N, 6],
    solve_mask f32[N], table f32[N, 22])`` for one step of substep ``h``
    under ``gravity`` f32[B, 3] of B scenes of N / B bodies (column layout
    of ``table`` in ``kernels/integrate_bodies.py``)."""
    dev = bodies.pos.device
    if dev.type == "cpu":
        return prepare_bodies_twin(bodies, gravity, h)
    if dev.type != "cuda":
        raise RuntimeError(f"prepare_bodies: unsupported device {dev}")
    from avian_tpu_torch.kernels import build

    n = bodies.capacity
    b = bodies
    n_scene = _scene_size(gravity, n)
    f32, i32, u8 = torch.float32, torch.int32, torch.bool
    v3 = [(name, getattr(b, name), (n, 3), f32) for name in (
        "lin_vel", "ang_vel", "force", "torque", "const_force", "const_local_force",
        "const_torque", "const_local_torque", "const_lin_acc", "const_local_lin_acc",
        "const_ang_acc", "const_local_ang_acc")]
    s1 = [(name, getattr(b, name), (n,), f32) for name in (
        "inv_mass", "gravity_scale", "lin_damping", "ang_damping", "max_lin_speed",
        "max_ang_speed")]
    build.require("prepare_bodies", dev, v3 + s1 + [
        ("body_type", b.body_type, (n,), i32), ("locked_axes", b.locked_axes, (n,), i32),
        ("active", b.active, (n,), u8), ("sleeping", b.sleeping, (n,), u8),
        ("gyroscopic", b.gyroscopic, (n,), u8), ("quat", b.quat, (n, 4), f32),
        ("inv_inertia", b.inv_inertia, (n, 6), f32),
        ("gravity", gravity, (gravity.shape[0], 3), f32),
    ])
    state = torch.empty((n, STATE_COLS), dtype=f32, device=dev)
    inv_mass = torch.empty((n, 3), dtype=f32, device=dev)
    inv_inertia = torch.empty((n, 6), dtype=f32, device=dev)
    solve_mask = torch.empty((n,), dtype=f32, device=dev)
    table = torch.empty((n, TABLE_COLS), dtype=f32, device=dev)
    if n == 0:
        return state, inv_mass, inv_inertia, solve_mask, table
    build.launch("avian_prepare_bodies", dev, n, n_scene, b.body_type, b.locked_axes, b.active,
                 b.sleeping, b.gyroscopic, b.quat, b.inv_inertia, *(x for _, x, _, _ in v3),
                 *(x for _, x, _, _ in s1), gravity, state, inv_mass, inv_inertia, solve_mask,
                 table, float(h))
    prepare_bodies.launches += 1
    return state, inv_mass, inv_inertia, solve_mask, table


prepare_bodies.launches = 0


def writeback_bodies_twin(bodies, state):
    """Plain PyTorch version; see ``writeback_bodies``."""
    b = bodies
    old_world_com = quat_m.rotate(b.quat, b.com)
    new_quat = quat_m.fast_renormalize(quat_m.mul(state[:, 9:13], b.quat))
    new_world_com = quat_m.rotate(new_quat, b.com)
    new_pos = b.pos + state[:, 6:9] + old_world_com - new_world_com
    m1 = moving_mask(b)[:, None]
    z3 = torch.zeros_like(b.force)
    return (torch.where(m1, new_pos, b.pos), torch.where(m1, new_quat, b.quat),
            torch.where(m1, state[:, 0:3], b.lin_vel), torch.where(m1, state[:, 3:6], b.ang_vel),
            z3, z3.clone())


def writeback_bodies(bodies, state):
    """``(pos, quat, lin_vel, ang_vel, force, torque)`` after the step: the
    delta pose of ``state`` f32[N, 13] applied about the centre of mass of
    every moving body, its velocities written back, and zeroed
    accumulators."""
    dev = bodies.pos.device
    if dev.type == "cpu":
        return writeback_bodies_twin(bodies, state)
    if dev.type != "cuda":
        raise RuntimeError(f"writeback_bodies: unsupported device {dev}")
    from avian_tpu_torch.kernels import build

    n = bodies.capacity
    b = bodies
    f32, i32, u8 = torch.float32, torch.int32, torch.bool
    build.require("writeback_bodies", dev, (
        ("state", state, (n, STATE_COLS), f32), ("pos", b.pos, (n, 3), f32),
        ("quat", b.quat, (n, 4), f32), ("com", b.com, (n, 3), f32),
        ("lin_vel", b.lin_vel, (n, 3), f32), ("ang_vel", b.ang_vel, (n, 3), f32),
        ("active", b.active, (n,), u8), ("sleeping", b.sleeping, (n,), u8),
        ("body_type", b.body_type, (n,), i32),
    ))
    out = [torch.empty((n, k), dtype=f32, device=dev) for k in (3, 4, 3, 3, 3, 3)]
    if n == 0:
        return tuple(out)
    build.launch("avian_writeback_bodies", dev, n, state, b.pos, b.quat, b.com, b.lin_vel,
                 b.ang_vel, b.active, b.sleeping, b.body_type, *out)
    writeback_bodies.launches += 1
    return tuple(out)


writeback_bodies.launches = 0


def writeback_2d_twin(bodies, state):
    """Plain PyTorch version; see ``writeback_2d``."""
    b = bodies

    def rotate(angle, v):
        c, s = torch.cos(angle), torch.sin(angle)
        return torch.stack([c * v[:, 0] - s * v[:, 1], s * v[:, 0] + c * v[:, 1]], -1)

    new_angle = b.angle + state[:, 5]
    new_pos = b.pos + state[:, 3:5] + rotate(b.angle, b.com) - rotate(new_angle, b.com)
    moving = moving_mask(b)
    m1 = moving[:, None]
    return (torch.where(m1, new_pos, b.pos), torch.where(moving, new_angle, b.angle),
            torch.where(m1, state[:, 0:2], b.lin_vel), torch.where(moving, state[:, 2], b.ang_vel),
            torch.zeros_like(b.force), torch.zeros_like(b.torque))


def writeback_2d(bodies, state):
    """``(pos f32[N, 2], angle, lin_vel f32[N, 2], ang_vel, force f32[N, 2],
    torque)`` of the ``Bodies2D`` ``bodies`` after the step: the delta pose
    of the 2D solver ``state`` f32[N, 6] applied about the centre of mass of
    every moving body, its velocities written back, and zeroed
    accumulators."""
    dev = bodies.pos.device
    if dev.type == "cpu":
        return writeback_2d_twin(bodies, state)
    if dev.type != "cuda":
        raise RuntimeError(f"writeback_2d: unsupported device {dev}")
    from avian_tpu_torch.kernels import build

    n = bodies.capacity
    b = bodies
    f32, i32, u8 = torch.float32, torch.int32, torch.bool
    build.require("writeback_2d", dev, (
        ("state", state, (n, 6), f32), ("pos", b.pos, (n, 2), f32), ("angle", b.angle, (n,), f32),
        ("com", b.com, (n, 2), f32), ("lin_vel", b.lin_vel, (n, 2), f32),
        ("ang_vel", b.ang_vel, (n,), f32), ("active", b.active, (n,), u8),
        ("sleeping", b.sleeping, (n,), u8), ("body_type", b.body_type, (n,), i32),
    ))
    out = [torch.empty(shape, dtype=f32, device=dev) for shape in ((n, 2), (n,)) * 3]
    if n == 0:
        return tuple(out)
    build.launch("avian_writeback_2d", dev, n, state, b.pos, b.angle, b.com, b.lin_vel, b.ang_vel,
                 b.active, b.sleeping, b.body_type, *out)
    writeback_2d.launches += 1
    return tuple(out)


writeback_2d.launches = 0
