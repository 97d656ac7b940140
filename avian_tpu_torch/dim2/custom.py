"""2D user constraint extension point: XPBD correction helpers (port of
``avian_tpu/dim2/custom.py``).

A custom joint is an object passed to ``physics_step_2d(world, config,
custom_joints=obj)`` with ``prepare(world, s, config) -> data`` and
``solve(s, data, h) -> (s, data)`` methods; ``s`` is the port's
:class:`~avian_tpu_torch.dim2.dynamics.SolverState2D` (``delta_pos``,
``delta_angle``, ``inv_mass``, ``inv_inertia`` are views of it). The step
calls ``prepare`` once after the contact prepare and ``solve`` every substep
after the built-in joint colours and before the velocity projection, as the
reference does.

A custom joint is the user's own code, so these helpers are plain PyTorch
operations on whatever device the world lives on: on the card they run as
PyTorch's CUDA operations. That is not a fallback for a missing kernel; the
built-in joints are Kernel AA's. The corrections return a new solver state
(the rest of the step carries on from it) and scatter with ``index_add_``,
which on the card adds a body's duplicate entries in no fixed order.
"""

import torch

from avian_tpu_torch.dim2.dynamics import SolverState2D
from avian_tpu_torch.dim2.narrowphase import rotate


def _cross2(a, b):
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def _rot(angle):
    return torch.cos(angle), torch.sin(angle)


def _index(body, device):
    return torch.as_tensor(body, dtype=torch.long, device=device)


def anchors_from_com(world, body, local_point):
    """World-space anchor vector from a body's COM at prepare time."""
    b = world.bodies
    body = _index(body, world.device)
    c, s = _rot(b.angle[body])
    point = torch.as_tensor(local_point, dtype=torch.float32, device=world.device)
    return rotate(c, s, point - b.com[body])


def center_difference(world, body_a, body_b):
    """World-space COM-to-COM vector at prepare time."""
    b = world.bodies
    body_a, body_b = _index(body_a, world.device), _index(body_b, world.device)
    ca, sa = _rot(b.angle[body_a])
    cb, sb = _rot(b.angle[body_b])
    com_a = b.pos[body_a] + rotate(ca, sa, b.com[body_a])
    com_b = b.pos[body_b] + rotate(cb, sb, b.com[body_b])
    return com_b - com_a


def current_separation(s: SolverState2D, body_a, body_b, r1, r2, center_diff):
    """Anchor separation under the current delta poses."""
    dev = s.state.device
    body_a, body_b = _index(body_a, dev), _index(body_b, dev)
    ca, sa = _rot(s.delta_angle[body_a])
    cb, sb = _rot(s.delta_angle[body_b])
    r1c = rotate(ca, sa, r1)
    r2c = rotate(cb, sb, r2)
    return (s.delta_pos[body_b] - s.delta_pos[body_a]) + (r2c - r1c) + center_diff


def _with_deltas(s: SolverState2D, body_a, body_b, dp_a, dp_b, dth_a, dth_b):
    """A new solver state with the delta-pose increments added, the a-sides
    first (the reference's ``.at[body_a].add`` then ``.at[body_b].add``)."""
    state = s.state.clone()
    inc_a = torch.cat([dp_a, dth_a[..., None]], -1)
    inc_b = torch.cat([dp_b, dth_b[..., None]], -1)
    pose = state[:, 3:6]
    pose.index_add_(0, body_a, inc_a)
    pose.index_add_(0, body_b, inc_b)
    return s.replace(state=state)


def apply_positional_correction(s: SolverState2D, body_a, body_b, r1, r2, correction,
                                compliance, h, active=None):
    """Apply an XPBD positional correction (= C * dir, the violation vector
    to cancel) at anchors ``r1``/``r2`` (from each COM, prepare-time frame).
    Rank-1 over K constraints; returns ``(s, delta_lagrange)``."""
    dev = s.state.device
    body_a, body_b = _index(body_a, dev), _index(body_b, dev)
    compliance = torch.broadcast_to(
        torch.as_tensor(compliance, dtype=torch.float32, device=dev), body_a.shape)
    if active is None:
        active = torch.ones(body_a.shape, dtype=torch.bool, device=dev)

    c = torch.linalg.vector_norm(correction, dim=-1)
    ok = active & (c > 1e-9)
    dir_ = -correction / torch.clamp(c, min=1e-9)[..., None]

    ca, sa = _rot(s.delta_angle[body_a])
    cb, sb = _rot(s.delta_angle[body_b])
    r1c = rotate(ca, sa, r1)
    r2c = rotate(cb, sb, r2)

    ima, imb = s.inv_mass[body_a], s.inv_mass[body_b]
    iia, iib = s.inv_inertia[body_a], s.inv_inertia[body_b]
    r1xn = _cross2(r1c, dir_)
    r2xn = _cross2(r2c, dir_)
    w1 = ima.amax(-1) + iia * r1xn * r1xn
    w2 = imb.amax(-1) + iib * r2xn * r2xn
    w_sum = w1 + w2
    tilde = compliance / (h * h)
    delta_lagrange = torch.where(ok & (w_sum > 1e-12),
                                 -c / torch.clamp(w_sum + tilde, min=1e-12), 0.0)
    impulse = delta_lagrange[..., None] * dir_
    m = ok[..., None]
    s = _with_deltas(
        s, body_a, body_b, torch.where(m, impulse * ima, 0.0), torch.where(m, -impulse * imb, 0.0),
        torch.where(ok, iia * _cross2(r1c, impulse), 0.0),
        torch.where(ok, -iib * _cross2(r2c, impulse), 0.0))
    return s, delta_lagrange


def apply_angular_correction(s: SolverState2D, body_a, body_b, difference, compliance, h,
                             active=None):
    """Apply an XPBD angular correction cancelling the (scalar) angle
    ``difference`` between two bodies. Returns ``(s, delta_lagrange)``."""
    dev = s.state.device
    body_a, body_b = _index(body_a, dev), _index(body_b, dev)
    difference = torch.as_tensor(difference, dtype=torch.float32, device=dev)
    compliance = torch.broadcast_to(
        torch.as_tensor(compliance, dtype=torch.float32, device=dev), body_a.shape)
    if active is None:
        active = torch.ones(body_a.shape, dtype=torch.bool, device=dev)

    angle = torch.abs(difference)
    sign = torch.sign(difference)
    ok = active & (angle > 1e-9)
    iia, iib = s.inv_inertia[body_a], s.inv_inertia[body_b]
    w_sum = iia + iib
    tilde = compliance / (h * h)
    delta_lagrange = torch.where(ok & (w_sum > 1e-12),
                                 -angle / torch.clamp(w_sum + tilde, min=1e-12), 0.0)
    impulse = -delta_lagrange * sign
    zero = torch.zeros(body_a.shape + (2,), dtype=torch.float32, device=dev)
    s = _with_deltas(s, body_a, body_b, zero, zero, torch.where(ok, iia * impulse, 0.0),
                     torch.where(ok, -iib * impulse, 0.0))
    return s, delta_lagrange
