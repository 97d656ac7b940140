"""User constraint extension point: XPBD correction helpers (port of
``avian_tpu/api/custom.py``).

A custom joint is an object passed to ``physics_step(world, config,
custom_joints=obj)`` with two methods:

- ``prepare(world, s, config) -> data``: called once a step, after the
  contact prepare;
- ``solve(s, data, h) -> (s, data)``: called every substep after the
  built-in joints' colours (Kernel I) and before Kernel I's velocity
  projection, so that the projection sees the custom deltas, as the
  reference's does.

``s`` is the port's :class:`~avian_tpu_torch.pipeline.solver_body.SolverState`;
``delta_pos``, ``delta_quat``, ``inv_mass`` and ``inv_inertia`` are views of
it. The helpers are vectorized over K constraint rows; rows that share a
body add up Jacobi-style.

A custom joint is the user's own code, so these helpers are plain PyTorch
operations on whatever device the world lives on: on the card they run as
PyTorch's CUDA operations. That is not a fallback for a missing kernel; the
built-in joints are Kernel I's. The corrections return a new solver state
(the rest of the step carries on from it) and scatter with ``index_add_``,
which on the card adds a body's duplicate entries in no fixed order.
"""

import torch

from avian_tpu_torch.math import quat as quat_m
from avian_tpu_torch.math import sym3, vec
from avian_tpu_torch.pipeline.solver_body import DPOS, DQUAT, SolverState


def _index(body, device):
    return torch.as_tensor(body, dtype=torch.long, device=device)


def _rows(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def anchors_from_com(world, body, local_point):
    """World-space anchor vector from a body's COM at prepare time: ``local_point
    - com`` rotated into the world frame."""
    b = world.bodies
    body = _index(body, world.device)
    return quat_m.rotate(b.quat[body], _rows(local_point, world.device) - b.com[body])


def center_difference(world, body_a, body_b):
    """World-space COM-to-COM vector at prepare time."""
    b = world.bodies
    body_a, body_b = _index(body_a, world.device), _index(body_b, world.device)
    com_a = b.pos[body_a] + quat_m.rotate(b.quat[body_a], b.com[body_a])
    com_b = b.pos[body_b] + quat_m.rotate(b.quat[body_b], b.com[body_b])
    return com_b - com_a


def current_separation(s: SolverState, body_a, body_b, r1, r2, center_diff):
    """Anchor separation under the current delta poses: the prepare-time
    anchors rotated by each body's delta rotation, plus the delta
    translations."""
    dev = s.state.device
    body_a, body_b = _index(body_a, dev), _index(body_b, dev)
    r1c = quat_m.rotate(s.delta_quat[body_a], r1)
    r2c = quat_m.rotate(s.delta_quat[body_b], r2)
    return (s.delta_pos[body_b] - s.delta_pos[body_a]) + (r2c - r1c) + center_diff


def _with_deltas(s: SolverState, body_a, body_b, dp_a, dp_b, rv_a, rv_b):
    """A new solver state with the delta positions added (the a-sides first,
    as the reference's ``.at[body_a].add`` then ``.at[body_b].add``) and the
    summed rotation vectors composed onto the delta rotations."""
    state = s.state.clone()
    dpos = state[:, DPOS:DPOS + 3]
    dpos.index_add_(0, body_a, dp_a)
    dpos.index_add_(0, body_b, dp_b)
    rot_acc = torch.zeros_like(dpos)
    rot_acc.index_add_(0, body_a, rv_a)
    rot_acc.index_add_(0, body_b, rv_b)
    state[:, DQUAT:DQUAT + 4] = quat_m.mul(quat_m.from_scaled_axis(rot_acc),
                                           state[:, DQUAT:DQUAT + 4])
    return s.replace(state=state)


def _prologue(s, body_a, body_b, compliance, active):
    dev = s.state.device
    body_a, body_b = _index(body_a, dev), _index(body_b, dev)
    compliance = torch.broadcast_to(_rows(compliance, dev), body_a.shape)
    if active is None:
        active = torch.ones(body_a.shape, dtype=torch.bool, device=dev)
    return body_a, body_b, compliance, active


def apply_positional_correction(s: SolverState, body_a, body_b, r1, r2, correction,
                                compliance, h, active=None):
    """Apply an XPBD positional correction ``correction`` (= C * dir, the
    violation vector to cancel) at world-space anchors ``r1``/``r2`` (from
    each COM, prepare-time frame; rotated by the current delta rotations
    here). Rank-1 over K constraints (``body_a`` i32[K], ``r1`` f32[K, 3],
    ``correction`` f32[K, 3], ``compliance`` f32[K] or a scalar). Returns
    ``(s, delta_lagrange f32[K])``."""
    body_a, body_b, compliance, active = _prologue(s, body_a, body_b, compliance, active)
    c = vec.length(correction)
    ok = active & (c > 1e-9)
    dir_ = -correction / torch.clamp(c, min=1e-9)[..., None]

    r1c = quat_m.rotate(s.delta_quat[body_a], r1)
    r2c = quat_m.rotate(s.delta_quat[body_b], r2)
    ima, imb = s.inv_mass[body_a], s.inv_mass[body_b]
    iia, iib = s.inv_inertia[body_a], s.inv_inertia[body_b]
    r1xn = vec.cross(r1c, dir_)
    r2xn = vec.cross(r2c, dir_)
    w1 = ima.amax(-1) + vec.dot(r1xn, sym3.mv(iia, r1xn))
    w2 = imb.amax(-1) + vec.dot(r2xn, sym3.mv(iib, r2xn))
    w_sum = w1 + w2
    tilde = compliance / (h * h)
    delta_lagrange = torch.where(ok & (w_sum > 1e-12),
                                 -c / torch.clamp(w_sum + tilde, min=1e-12), 0.0)
    impulse = delta_lagrange[..., None] * dir_
    m = ok[..., None]
    s = _with_deltas(
        s, body_a, body_b,
        torch.where(m, impulse * ima, 0.0), torch.where(m, -impulse * imb, 0.0),
        torch.where(m, sym3.mv(iia, vec.cross(r1c, impulse)), 0.0),
        torch.where(m, -sym3.mv(iib, vec.cross(r2c, impulse)), 0.0))
    return s, delta_lagrange


def apply_angular_correction(s: SolverState, body_a, body_b, difference, compliance, h,
                             active=None):
    """Apply an XPBD angular correction cancelling the rotation vector
    ``difference`` f32[K, 3] between two bodies (``a1 x a2`` aligns two
    axes). Returns ``(s, delta_lagrange f32[K])``."""
    body_a, body_b, compliance, active = _prologue(s, body_a, body_b, compliance, active)
    angle = vec.length(difference)
    ok = active & (angle > 1e-9)
    axis = difference / torch.clamp(angle, min=1e-9)[..., None]
    iia, iib = s.inv_inertia[body_a], s.inv_inertia[body_b]
    w_sum = vec.dot(axis, sym3.mv(iia, axis)) + vec.dot(axis, sym3.mv(iib, axis))
    tilde = compliance / (h * h)
    delta_lagrange = torch.where(ok & (w_sum > 1e-12),
                                 -angle / torch.clamp(w_sum + tilde, min=1e-12), 0.0)
    impulse = -delta_lagrange[..., None] * axis
    m = ok[..., None]
    zero = torch.zeros_like(impulse)
    s = _with_deltas(s, body_a, body_b, zero, zero,
                     torch.where(m, sym3.mv(iia, impulse), 0.0),
                     torch.where(m, -sym3.mv(iib, impulse), 0.0))
    return s, delta_lagrange
