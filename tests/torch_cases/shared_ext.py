"""The 3D extension points' worlds and port-side user code, shared by the CPU
cases (``cases_custom_shapes.py``, ``cases_extensions.py``) and
``chip_smoke.py``: the ellipsoid of ``examples/custom_collider.py`` as a port
``CustomShape`` with its CUDA source, the worlds of that example, of
``tests/test_custom_shapes.py``, ``tests/test_hooks.py``,
``examples/one_way_platform.py``, ``examples/conveyor_belt.py`` and
``examples/custom_constraint.py`` (each built by a builder class passed in,
so that both packages build the same world), and the port's hooks and
custom constraints of those files, written in PyTorch. Imports no JAX."""

import math

import numpy as np
import torch

from avian_tpu_torch.api.custom import (apply_angular_correction, apply_positional_correction,
                                        center_difference, current_separation)
from avian_tpu_torch.api.custom_shapes import CustomShape
from avian_tpu_torch.core.types import BodyType, JointType
from avian_tpu_torch.math import quat as quat_m
from avian_tpu_torch.math import vec

# ---- the ellipsoid -----------------------------------------------------------------

ELLIPSOID_CUDA = r"""
// Ellipsoid of semi-axes prm[0..3): A^2 d / |A d|, A = diag(a, b, c), in the
// torch version's order of operations.
__device__ V3 support(const float* prm, V3 d) {
  V3 a2 = v3(prm[0] * prm[0], prm[1] * prm[1], prm[2] * prm[2]);
  V3 v = mulv(a2, d);
  float s = __fsqrt_rn(fmaxf(dot(d, v), 1e-12f));
  return v3(__fdiv_rn(v.x, s), __fdiv_rn(v.y, s), __fdiv_rn(v.z, s));
}

__device__ V3 aabb_half_extents(const float* prm) { return v3(prm[0], prm[1], prm[2]); }
"""


def _ellipsoid_support(prm, d):
    a2 = prm[:, :3] * prm[:, :3]
    v = a2 * d
    return v / vec.sqrt_rn(torch.clamp(vec.dot(d, v), min=1e-12))[:, None]


def _ellipsoid_aabb(prm):
    return prm[:, :3]


def make_ellipsoid(cuda=True):
    """The example's ellipsoid (semi-axes in params[:3]) as a port shape,
    with its CUDA source unless ``cuda`` is false."""
    return CustomShape("ellipsoid", support=_ellipsoid_support,
                       aabb_half_extents=_ellipsoid_aabb, cuda=ELLIPSOID_CUDA if cuda else None)


ELLIPSOID = make_ellipsoid()


def ellipsoid_mass_inertia(a, b, c, density=1.0):
    """The examples' mass and diagonal inertia of a solid ellipsoid."""
    m = density * 4.0 / 3.0 * np.pi * a * b * c
    i = m / 5.0 * np.asarray([b * b + c * c, a * a + c * c, a * a + b * b], np.float32)
    return m, i


# ---- worlds of custom shapes -------------------------------------------------------

def custom_collider_world(builder, shape, **kw):
    """``examples/custom_collider.py``'s world: 9 ellipsoids (0.5, 0.25, 0.5)
    over a half-space. Returns ``(world, ids)``; checks: every body 0.15 <
    y < 0.8 after 300 steps, a ray down onto the first hits y = 0.5 within
    0.06."""
    b = builder()
    ground = b.add_body(body_type=BodyType.STATIC)
    b.half_space(ground, normal=(0, 1, 0))
    a_, b_, c_ = 0.5, 0.25, 0.5
    m, i = ellipsoid_mass_inertia(a_, b_, c_)
    ids = []
    for gx in range(3):
        for gz in range(3):
            body = b.add_body(pos=(1.2 * gx - 1.2, 1.0 + 0.8 * ((gx + gz) % 3), 1.2 * gz - 1.2))
            b.custom_collider(body, shape=shape, params=(a_, b_, c_), mass=m, inertia=i)
            ids.append(body)
    return b.finalize(max_bodies=16, max_colliders=16, max_contacts=256, **kw), ids


def custom_pairs_world(builder, shape, **kw):
    """``tests/test_custom_shapes.py::test_ellipsoid_vs_box_and_ellipsoid``'s
    world: an ellipsoid (0.6, 0.3, 0.6) on a half-space, a unit box with a
    second on top, a third over the first. Returns ``(world, (e1, box, e2,
    e3))``; checks after 300 steps: e2 at y 1.3 within 0.08, e3 above 0.45."""
    b = builder()
    g = b.add_body(body_type=BodyType.STATIC)
    b.half_space(g, normal=(0, 1, 0))
    m, i = ellipsoid_mass_inertia(0.6, 0.3, 0.6)
    e1 = b.add_body(pos=(0.0, 1.5, 0.0))
    b.custom_collider(e1, shape=shape, params=(0.6, 0.3, 0.6), mass=m, inertia=i)
    box = b.add_body(pos=(3.0, 0.5, 0.0))
    b.box(box, 0.5, 0.5, 0.5)
    e2 = b.add_body(pos=(3.0, 2.0, 0.0))
    b.custom_collider(e2, shape=shape, params=(0.6, 0.3, 0.6), mass=m, inertia=i)
    e3 = b.add_body(pos=(0.05, 2.6, 0.0))
    b.custom_collider(e3, shape=shape, params=(0.6, 0.3, 0.6), mass=m, inertia=i)
    return b.finalize(max_bodies=8, max_colliders=8, max_contacts=64, **kw), (e1, box, e2, e3)


# ---- hooks -------------------------------------------------------------------------

HOOK_CAPS = dict(max_bodies=8, max_colliders=8, max_contacts=64, max_joints=4)


class DisableAll:
    """``tests/test_hooks.py``'s ``_DisableAll``: every pair filtered out."""

    def filter_pairs(self, world, ca, cb, valid):
        return valid & False


class Conveyor:
    """The conveyor of ``tests/test_hooks.py`` and
    ``examples/conveyor_belt.py``: contacts with body ``belt`` get a surface
    velocity of ``speed`` along +x."""

    def __init__(self, belt=0, speed=2.0):
        self.belt, self.speed = belt, speed

    def modify_contacts(self, world, contacts):
        on_belt = (contacts.body_a == self.belt) | (contacts.body_b == self.belt)
        sign = torch.where(contacts.body_a == self.belt, -1.0, 1.0)
        belt_v = torch.tensor([self.speed, 0.0, 0.0], device=contacts.normal.device)
        sv = torch.where(on_belt[:, None], sign[:, None] * belt_v, contacts.surface_velocity)
        return contacts.replace(surface_velocity=sv)


class OneWay:
    """``examples/one_way_platform.py``'s hook: contacts with the platform
    body are kept only where the other body comes from above."""

    def __init__(self, platform=1):
        self.platform = platform

    def modify_contacts(self, world, contacts):
        involved = (contacts.body_a == self.platform) | (contacts.body_b == self.platform)
        n_to_other = torch.where((contacts.body_a == self.platform)[:, None], contacts.normal,
                                 -contacts.normal)
        from_above = n_to_other[:, 1] > 0.5
        keep = ~involved | from_above
        return contacts.replace(touching=contacts.touching & keep,
                                num_points=torch.where(keep, contacts.num_points, 0))


def drop_through_world(builder, **kw):
    """``test_filter_pairs_disables_collisions``: a ball over a half-space.
    Returns ``(world, ball)``; check: below y = -1 after 60 filtered steps."""
    b = builder()
    g = b.add_body(body_type=BodyType.STATIC)
    b.half_space(g, normal=(0, 1, 0))
    ball = b.add_body(pos=(0, 1.0, 0))
    b.sphere(ball, 0.5)
    return b.finalize(**HOOK_CAPS, **kw), ball


def belt_world(builder, x0=-2.0, y0=0.56, caps=None, **kw):
    """``test_conveyor_surface_velocity`` (x0 -2, y0 0.56) and
    ``examples/conveyor_belt.py`` (-3, 0.6, 4 slots): a box on a static belt.
    Returns ``(world, box)``; checks after 120 steps: x > -1, vx > 0.5."""
    b = builder()
    belt = b.add_body(body_type=BodyType.STATIC)
    b.box(belt, 5.0, 0.25, 2.0, friction=1.0)
    box = b.add_body(pos=(x0, y0, 0.0))
    b.box(box, 0.3, 0.3, 0.3, friction=1.0)
    return b.finalize(**(caps or HOOK_CAPS), **kw), box


def one_way_world(builder, **kw):
    """``examples/one_way_platform.py``'s world: a ball dropped on the
    platform and one shot up through it. Returns ``(world, (above, below))``;
    checks after 240 steps: the first rests on the platform (y 0.4 within
    0.05), the second passed it (y > 0.1)."""
    b = builder()
    ground = b.add_body(body_type=BodyType.STATIC, pos=(0, -3, 0))
    b.half_space(ground, normal=(0, 1, 0))
    plat = b.add_body(body_type=BodyType.STATIC, pos=(0, 0, 0))
    b.box(plat, 2.0, 0.1, 2.0)
    a = b.add_body(pos=(0.5, 2.0, 0))
    b.sphere(a, 0.3)
    c = b.add_body(pos=(-0.5, -2.0, 0), lin_vel=(0, 9.0, 0))
    b.sphere(c, 0.3)
    return b.finalize(max_bodies=8, max_colliders=8, max_contacts=32, **kw), (a, c)


# ---- custom constraints ----------------------------------------------------------

class CenterDistance:
    """``examples/custom_constraint.py``'s centre-distance constraint, for
    K pairs of bodies at once (rows of ``body_a``/``body_b``)."""

    def __init__(self, body_a, body_b, rest, compliance=0.0):
        self.body_a = np.atleast_1d(np.asarray(body_a, np.int64))
        self.body_b = np.atleast_1d(np.asarray(body_b, np.int64))
        self.rest, self.compliance = rest, compliance

    def prepare(self, world, s, config):
        dev = world.device
        return {"cd": center_difference(world, self.body_a, self.body_b),
                "lagrange": torch.zeros((self.body_a.shape[0],), device=dev)}

    def solve(self, s, data, h):
        z = torch.zeros((self.body_a.shape[0], 3), device=s.state.device)
        sep = current_separation(s, self.body_a, self.body_b, z, z, data["cd"])
        dist = torch.linalg.vector_norm(sep, dim=-1)
        dir_ = sep / torch.clamp(dist, min=1e-9)[..., None]
        corr = dir_ * (dist - self.rest)[..., None]
        s, dl = apply_positional_correction(s, self.body_a, self.body_b, z, z, corr,
                                            self.compliance, h)
        return s, {"cd": data["cd"], "lagrange": data["lagrange"] + dl}


class AlignOrientation:
    """``tests/test_custom_constraint.py``'s axis alignment of two bodies."""

    def __init__(self, body_a, body_b):
        self.body_a, self.body_b = body_a, body_b

    def prepare(self, world, s, config):
        y = torch.tensor([0.0, 1.0, 0.0], device=world.device)
        q = world.bodies.quat
        return {"axis_a": quat_m.rotate(q[self.body_a], y), "axis_b": quat_m.rotate(q[self.body_b], y)}

    def solve(self, s, data, h):
        ba, bb = [self.body_a], [self.body_b]
        a1 = quat_m.rotate(s.delta_quat[ba], data["axis_a"][None, :])
        a2 = quat_m.rotate(s.delta_quat[bb], data["axis_b"][None, :])
        s, _ = apply_angular_correction(s, ba, bb, vec.cross(a1, a2), 0.0, h)
        return s, data


def pendulum_world(builder, rest=2.5, **kw):
    """``examples/custom_constraint.py``'s world (rest 2.5) or
    ``test_center_distance_pendulum``'s (2.0): a static anchor box and a cube
    at ``rest`` along x, no joint slots. Returns ``(world, (anchor, cube))``;
    checks: |d - rest| < 0.05 and the cube below y = -1 (-0.5 for 2.0)."""
    b = builder()
    anchor = b.add_body(body_type=BodyType.STATIC)
    b.box(anchor, 0.25, 0.25, 0.25)
    cube = b.add_body(pos=(rest, 0.0, 0.0))
    b.box(cube, 0.25, 0.25, 0.25)
    return b.finalize(max_bodies=4, max_colliders=4, max_contacts=16, **kw), (anchor, cube)


def pendulums_world(builder, n, rest=2.5, spacing=1.0, **kw):
    """``n`` copies of the example's pendulum side by side along z, no joint
    slots. Returns ``(world, anchors, cubes)``."""
    b = builder()
    anchors, cubes = [], []
    for k in range(n):
        z = spacing * k
        a = b.add_body(body_type=BodyType.STATIC, pos=(0.0, 0.0, z))
        b.box(a, 0.25, 0.25, 0.25)
        c = b.add_body(pos=(rest, 0.0, z))
        b.box(c, 0.25, 0.25, 0.25)
        anchors.append(a)
        cubes.append(c)
    return (b.finalize(max_bodies=2 * n, max_colliders=2 * n, max_contacts=16 * n, **kw),
            anchors, cubes)


def chained_world(builder, **kw):
    """``test_custom_alongside_builtin_joints``: a spherical joint anchor-mid
    and a custom distance mid-tip. Returns ``(world, (mid, tip))``; check:
    |tip - mid| within 0.08 of 1 after 90 steps."""
    b = builder()
    anchor = b.add_body(body_type=BodyType.STATIC)
    mid = b.add_body(pos=(1.0, 0.0, 0.0))
    b.sphere(mid, 0.2)
    tip = b.add_body(pos=(2.0, 0.0, 0.0))
    b.sphere(tip, 0.2)
    b.add_joint(JointType.SPHERICAL, anchor, mid, anchor_a=(0.5, 0, 0), anchor_b=(-0.5, 0, 0))
    return b.finalize(max_bodies=4, max_colliders=4, max_contacts=16, max_joints=2, **kw), (mid, tip)


def aligned_world(builder, **kw):
    """``test_angular_align_custom``: two free bodies, the second turned 0.4
    rad about z, no colliders and no joint slots. Returns ``(world, (a1,
    a2))``; check: their y axes within 0.999 after 90 steps."""
    b = builder()
    a1 = b.add_body(gravity_scale=0.0, mass=1.0, inertia=(1, 1, 1))
    half = math.sin(0.4 / 2)
    a2 = b.add_body(pos=(3.0, 0, 0), gravity_scale=0.0, mass=1.0, inertia=(1, 1, 1),
                    quat=(0.0, 0.0, half, math.cos(0.4 / 2)))
    return b.finalize(max_bodies=4, max_colliders=4, max_contacts=16, **kw), (a1, a2)
