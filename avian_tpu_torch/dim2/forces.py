"""2D forces API (port of ``avian_tpu/dim2/forces.py``): the reference's
``Forces`` accessor on the [N, 2] profile.

Every helper returns a new world and accepts an int or an index tensor
``body``; duplicate indices accumulate, as the reference's ``.at[].add``
does. Torques, angular impulses and angular velocities are scalars (2D cross
product ``r x f = r.x * f.y - r.y * f.x``). These are indexed writes made
between steps, not a hot loop, so they are PyTorch operations with no kernel
of their own. A force, torque or impulse wakes its body unless
``wake=False``; a constant force or torque on a sleeping body wakes it at the
next step (``dim2/step.py::wake_pushed``).
"""

import torch

from avian_tpu_torch.dim2.narrowphase import rotate
from avian_tpu_torch.dim2.state import World2D


def _cross2(a, b):
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def _index(world, body):
    return torch.as_tensor(body, dtype=torch.long, device=world.device)


def _value(world, x):
    return torch.as_tensor(x, dtype=torch.float32, device=world.device)


def _add(column, body, value):
    out = column.clone()
    out.index_put_((body,), value.expand_as(out[body]), accumulate=True)
    return out


def _set(column, body, value):
    out = column.clone()
    out[body] = value
    return out


def _wake(bodies, body):
    return bodies.replace(sleeping=_set(bodies.sleeping, body, False),
                          sleep_timer=_set(bodies.sleep_timer, body, 0.0))


def _com_world(bodies, body):
    angle = bodies.angle[body]
    return bodies.pos[body] + rotate(torch.cos(angle), torch.sin(angle), bodies.com[body])


def _done(world, bodies, body, wake):
    return world.replace(bodies=_wake(bodies, body) if wake else bodies)


def apply_force(world: World2D, body, force, wake=True) -> World2D:
    """Accumulate a world-frame force for the next step."""
    body = _index(world, body)
    b = world.bodies
    return _done(world, b.replace(force=_add(b.force, body, _value(world, force))), body, wake)


def apply_torque(world: World2D, body, torque, wake=True) -> World2D:
    body = _index(world, body)
    b = world.bodies
    return _done(world, b.replace(torque=_add(b.torque, body, _value(world, torque))), body,
                 wake)


def apply_force_at_point(world: World2D, body, force, point, wake=True) -> World2D:
    """Force at a world-space point: adds the induced torque about the COM."""
    body = _index(world, body)
    force, point = _value(world, force), _value(world, point)
    b = world.bodies
    torque = _cross2(point - _com_world(b, body), force)
    b = b.replace(force=_add(b.force, body, force), torque=_add(b.torque, body, torque))
    return _done(world, b, body, wake)


def apply_linear_impulse(world: World2D, body, impulse, wake=True) -> World2D:
    """Immediate velocity change ``dv = J * inv_mass``."""
    body = _index(world, body)
    b = world.bodies
    dv = _value(world, impulse) * b.inv_mass[body][..., None]
    return _done(world, b.replace(lin_vel=_add(b.lin_vel, body, dv)), body, wake)


def apply_angular_impulse(world: World2D, body, impulse, wake=True) -> World2D:
    body = _index(world, body)
    b = world.bodies
    dw = _value(world, impulse) * b.inv_inertia[body]
    return _done(world, b.replace(ang_vel=_add(b.ang_vel, body, dw)), body, wake)


def apply_impulse_at_point(world: World2D, body, impulse, point, wake=True) -> World2D:
    impulse, point = _value(world, impulse), _value(world, point)
    com_world = _com_world(world.bodies, _index(world, body))
    world = apply_linear_impulse(world, body, impulse, wake)
    return apply_angular_impulse(world, body, _cross2(point - com_world, impulse), wake)


def set_constant_force(world: World2D, body, force) -> World2D:
    """``ConstantForce`` (``forces/mod.rs:260``)."""
    b = world.bodies
    return world.replace(bodies=b.replace(
        const_force=_set(b.const_force, _index(world, body), _value(world, force))))


def set_constant_torque(world: World2D, body, torque) -> World2D:
    """``ConstantTorque`` (``forces/mod.rs:317``)."""
    b = world.bodies
    return world.replace(bodies=b.replace(
        const_torque=_set(b.const_torque, _index(world, body), _value(world, torque))))
