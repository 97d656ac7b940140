"""Host-side scene construction (port of ``avian_tpu/core/builder.py``).

The subset the ported scenes need: ``add_body``, ``add_body_2d``, ``sphere``,
``capsule``, ``box``, ``cylinder``, ``cone``, ``half_space``, ``add_joint``,
``revolute_joint`` and ``finalize``. Everything is numpy until ``finalize``,
with the reference's mass properties and padding, so a scene built here
equals the reference's leaf for leaf.
"""

import math

import numpy as np
import torch

from avian_tpu_torch.core import types
from avian_tpu_torch.core.device import resolve
from avian_tpu_torch.core.state import World
from avian_tpu_torch.core.types import BodyType, JointType, ShapeType

_INF = float("inf")
_SUPPORTED = (ShapeType.SPHERE, ShapeType.CAPSULE, ShapeType.BOX, ShapeType.PLANE,
              ShapeType.CYLINDER, ShapeType.CONE)
_PI = float(np.pi)


def _quat_np(q):
    q = np.asarray(q, np.float32)
    return q / max(float(np.linalg.norm(q)), 1e-12)


def _mass_properties_np(st, pr, dens):
    """(mass, sym6 inertia about the shape's COM, local COM) per collider;
    half-spaces carry none (reference ``_mass_properties_np``, the branches
    of the shapes the port supports, in its order and arithmetic)."""
    r = pr[:, 0]
    hx, hy, hz = pr[:, 0], pr[:, 1], pr[:, 2]
    ch, cr = pr[:, 0], pr[:, 1]
    H = 2.0 * ch

    mass = np.zeros_like(r)
    i3 = np.zeros((r.shape[0], 3), np.float32)

    sph = st == ShapeType.SPHERE
    m = dens * (4.0 / 3.0) * _PI * r**3
    mass = np.where(sph, m, mass)
    i3 = np.where(sph[:, None], (0.4 * m * r * r)[:, None] * np.ones(3, np.float32), i3)

    box = st == ShapeType.BOX
    m = dens * 8.0 * hx * hy * hz
    ib = np.stack([hy * hy + hz * hz, hx * hx + hz * hz, hx * hx + hy * hy], -1) * (m / 3.0)[:, None]
    mass = np.where(box, m, mass)
    i3 = np.where(box[:, None], ib, i3)

    cap = st == ShapeType.CAPSULE
    m_cyl = dens * _PI * cr * cr * H
    m_hem = dens * (4.0 / 3.0) * _PI * cr**3
    m = m_cyl + m_hem
    iy = m_cyl * cr * cr * 0.5 + m_hem * 0.4 * cr * cr
    ix = m_cyl * (H * H / 12.0 + cr * cr / 4.0) + m_hem * (0.4 * cr * cr + H * H / 4.0 + 0.375 * H * cr)
    mass = np.where(cap, m, mass)
    i3 = np.where(cap[:, None], np.stack([ix, iy, ix], -1), i3)

    cyl = st == ShapeType.CYLINDER
    m = dens * _PI * cr * cr * H
    iy = 0.5 * m * cr * cr
    ix = m * (3.0 * cr * cr + H * H) / 12.0
    mass = np.where(cyl, m, mass)
    i3 = np.where(cyl[:, None], np.stack([ix, iy, ix], -1), i3)

    cone = st == ShapeType.CONE
    m = dens * _PI * cr * cr * H / 3.0
    iy = 0.3 * m * cr * cr
    ix = m * (3.0 / 20.0 * cr * cr + 3.0 / 80.0 * H * H)
    mass = np.where(cone, m, mass)
    i3 = np.where(cone[:, None], np.stack([ix, iy, ix], -1), i3)

    i6 = np.concatenate([i3, np.zeros_like(i3)], -1).astype(np.float32)
    com = np.zeros((r.shape[0], 3), np.float32)
    com[:, 1] = np.where(cone, -0.5 * pr[:, 0], 0.0)
    return mass.astype(np.float32), i6, com


def _shift_inertia_np(i6, mass, d):
    d2 = np.sum(d * d, axis=-1)
    shift = np.stack(
        [
            d2 - d[:, 0] * d[:, 0],
            d2 - d[:, 1] * d[:, 1],
            d2 - d[:, 2] * d[:, 2],
            -d[:, 0] * d[:, 1],
            -d[:, 0] * d[:, 2],
            -d[:, 1] * d[:, 2],
        ],
        -1,
    )
    return i6 + shift * mass[:, None]


def _sym3_inverse_np(s):
    a, b, c = s[:, 0], s[:, 1], s[:, 2]
    d, e, f = s[:, 3], s[:, 4], s[:, 5]
    ca = b * c - f * f
    cb = a * c - e * e
    cc = a * b - d * d
    cd = e * f - d * c
    ce = d * f - e * b
    cf = d * e - a * f
    det = a * ca + d * cd + e * ce
    inv_det = np.where(det != 0.0, 1.0 / np.where(det == 0.0, 1.0, det), 0.0)
    return np.stack([ca, cb, cc, cd, ce, cf], -1) * inv_det[:, None]


def _pad(arr, total, fill=0.0):
    a = np.asarray(arr)
    pad_shape = (total - a.shape[0],) + a.shape[1:]
    return np.concatenate([a, np.full(pad_shape, fill, a.dtype)], 0)


_BODY_KEYS = (
    "gravity_scale", "lin_damping", "ang_damping", "max_lin_speed",
    "max_ang_speed", "dominance", "body_type", "locked_axes", "gyroscopic",
    "swept_ccd", "swept_ccd_nonlinear", "sleep_disabled",
)
_COLLIDER_KEYS = (
    "friction", "static_friction", "restitution", "friction_combine",
    "restitution_combine", "density", "layer_members", "layer_filter",
    "is_sensor", "collision_margin", "speculative_margin",
)


class SceneBuilder:
    """Accumulates bodies and colliders, then ``finalize()``s to a World."""

    def __init__(self):
        self._bodies = []
        self._colliders = []
        self._joints = []
        self.gravity = (0.0, -9.81, 0.0)

    def add_body(
        self,
        body_type: BodyType = BodyType.DYNAMIC,
        pos=(0.0, 0.0, 0.0),
        quat=(0.0, 0.0, 0.0, 1.0),
        lin_vel=(0.0, 0.0, 0.0),
        ang_vel=(0.0, 0.0, 0.0),
        mass: float | None = None,
        inertia=None,
        com=None,
        gravity_scale: float = 1.0,
        lin_damping: float = 0.0,
        ang_damping: float = 0.0,
        max_lin_speed: float = _INF,
        max_ang_speed: float = _INF,
        dominance: int = 0,
        locked_axes: int = 0,
        gyroscopic: bool = False,
        swept_ccd: bool = False,
        swept_ccd_nonlinear: bool = False,
        sleep_disabled: bool = False,
    ) -> int:
        """Returns the body index."""
        self._bodies.append(
            dict(
                body_type=int(body_type),
                pos=np.asarray(pos, np.float32),
                quat=_quat_np(quat),
                lin_vel=np.asarray(lin_vel, np.float32),
                ang_vel=np.asarray(ang_vel, np.float32),
                mass=mass, inertia=inertia, com=com,
                gravity_scale=gravity_scale, lin_damping=lin_damping,
                ang_damping=ang_damping, max_lin_speed=max_lin_speed,
                max_ang_speed=max_ang_speed, dominance=dominance,
                locked_axes=locked_axes, gyroscopic=gyroscopic,
                swept_ccd=swept_ccd, swept_ccd_nonlinear=swept_ccd_nonlinear,
                sleep_disabled=sleep_disabled,
            )
        )
        return len(self._bodies) - 1

    def add_body_2d(self, pos=(0.0, 0.0), angle: float = 0.0, **kw) -> int:
        """A body constrained to the XY plane: translation Z and rotation
        X/Y locked. ``pos`` is (x, y), ``angle`` the rotation about Z."""
        locked = kw.pop("locked_axes", 0) | types.LOCK_TZ | types.LOCK_RX | types.LOCK_RY
        q = (0.0, 0.0, math.sin(angle / 2), math.cos(angle / 2))
        return self.add_body(
            pos=(pos[0], pos[1], 0.0), quat=q, locked_axes=locked, **kw
        )

    def add_collider(
        self,
        body: int,
        shape: ShapeType,
        params,
        local_pos=(0.0, 0.0, 0.0),
        local_quat=(0.0, 0.0, 0.0, 1.0),
        friction: float = 0.5,
        static_friction: float | None = None,
        restitution: float = 0.0,
        friction_combine: int = 0,
        restitution_combine: int = 0,
        density: float = 1.0,
        layer_members: int = 0xFFFFFFFF,
        layer_filter: int = 0xFFFFFFFF,
        is_sensor: bool = False,
        collision_margin: float = 0.0,
        speculative_margin: float = _INF,
    ) -> int:
        if int(shape) not in _SUPPORTED:
            raise NotImplementedError(
                f"shape {ShapeType(int(shape)).name} is not ported yet; "
                f"supported: {', '.join(s.name for s in _SUPPORTED)}"
            )
        p = np.zeros(8, np.float32)
        pa = np.asarray(params, np.float32).reshape(-1)
        p[: pa.shape[0]] = pa
        self._colliders.append(
            dict(
                body=body, shape=int(shape), params=p,
                local_pos=np.asarray(local_pos, np.float32),
                local_quat=_quat_np(local_quat),
                friction=friction,
                static_friction=(
                    friction if static_friction is None else static_friction
                ),
                restitution=restitution, friction_combine=friction_combine,
                restitution_combine=restitution_combine, density=density,
                layer_members=layer_members, layer_filter=layer_filter,
                is_sensor=is_sensor, collision_margin=collision_margin,
                speculative_margin=speculative_margin,
            )
        )
        return len(self._colliders) - 1

    def sphere(self, body, radius, **kw):
        return self.add_collider(body, ShapeType.SPHERE, (radius,), **kw)

    def box(self, body, hx, hy, hz, **kw):
        return self.add_collider(body, ShapeType.BOX, (hx, hy, hz), **kw)

    def capsule(self, body, radius, length, **kw):
        """Capsule along local Y; stores ``(length / 2, radius)``."""
        return self.add_collider(body, ShapeType.CAPSULE, (length / 2, radius), **kw)

    def cylinder(self, body, radius, height, **kw):
        """Cylinder along local Y; stores ``(height / 2, radius)``."""
        return self.add_collider(body, ShapeType.CYLINDER, (height / 2, radius), **kw)

    def cone(self, body, radius, height, **kw):
        """Cone with its base disc at local y = -height/2 and its apex at
        +height/2; stores ``(height / 2, radius)``."""
        return self.add_collider(body, ShapeType.CONE, (height / 2, radius), **kw)

    def half_space(self, body, normal=(0.0, 1.0, 0.0), **kw):
        n = np.asarray(normal, np.float32)
        n = n / max(float(np.linalg.norm(n)), 1e-12)
        return self.add_collider(body, ShapeType.PLANE, tuple(n), **kw)

    def add_joint(
        self,
        jtype: JointType,
        body_a: int,
        body_b: int,
        anchor_a=(0.0, 0.0, 0.0),
        anchor_b=(0.0, 0.0, 0.0),
        basis_a=(0.0, 0.0, 0.0, 1.0),
        basis_b=(0.0, 0.0, 0.0, 1.0),
        compliance=(0.0, 0.0, 0.0, 0.0),
        limit_min: float = 0.0,
        limit_max: float = 0.0,
        limit_enabled: bool = False,
        twist_min: float = 0.0,
        twist_max: float = 0.0,
        twist_enabled: bool = False,
        lin_damping: float = 0.0,
        ang_damping: float = 0.0,
        collision_disabled: bool = True,
    ) -> int:
        """Returns the joint index. The joint's frame on each body is
        ``anchor_*`` (local position) and ``basis_*`` (local rotation, whose
        Z is the primary axis and X the secondary)."""
        self._joints.append(
            dict(
                jtype=int(jtype), body_a=body_a, body_b=body_b,
                anchor_a=np.asarray(anchor_a, np.float32),
                anchor_b=np.asarray(anchor_b, np.float32),
                basis_a=_quat_np(basis_a), basis_b=_quat_np(basis_b),
                compliance=np.asarray(compliance, np.float32),
                limit_min=limit_min, limit_max=limit_max,
                limit_enabled=limit_enabled, twist_min=twist_min,
                twist_max=twist_max, twist_enabled=twist_enabled,
                lin_damping=lin_damping, ang_damping=ang_damping,
                collision_disabled=collision_disabled,
            )
        )
        return len(self._joints) - 1

    def revolute_joint(self, body_a, body_b, axis=(0.0, 0.0, 1.0), **kw):
        """Hinge about ``axis``: unless bases are given, both are the
        rotation taking local Z onto ``axis``."""
        basis = _quat_from_z_to(np.asarray(axis, np.float32))
        kw.setdefault("basis_a", basis)
        kw.setdefault("basis_b", basis)
        return self.add_joint(JointType.REVOLUTE, body_a, body_b, **kw)

    def shape_pairs(self):
        """Canonical (type_a, type_b) combinations this scene can produce."""
        present = sorted({cd["shape"] for cd in self._colliders})
        return tuple(
            (a, b) for i, a in enumerate(present) for b in present[i:]
        )

    def finalize(
        self,
        max_bodies: int | None = None,
        max_colliders: int | None = None,
        max_contacts: int | None = None,
        max_joints: int | None = None,
        device=None,
    ) -> World:
        nb = len(self._bodies)
        nc = len(self._colliders)
        nj = len(self._joints)
        n = max_bodies or max(nb, 1)
        m = max_colliders or max(nc, 1)
        c = max_contacts or max(8 * m, 64)
        j = max_joints if max_joints is not None else nj
        if nb > n or nc > m or nj > j:
            raise ValueError("capacity below the number of bodies/colliders/joints")
        device = resolve(device)

        # Assembled from numpy on the host, then moved to ``device`` once.
        world = World.zeros(n, m, c, j, device="cpu")
        t = torch.from_numpy

        col = {k: [cd[k] for cd in self._colliders] for k in _COLLIDER_KEYS}
        if nc:
            colliders = world.colliders.replace(
                shape_type=t(_pad(np.asarray([cd["shape"] for cd in self._colliders], np.int32), m)),
                params=t(_pad(np.asarray([cd["params"] for cd in self._colliders], np.float32), m)),
                body_idx=t(_pad(np.asarray([cd["body"] for cd in self._colliders], np.int32), m)),
                local_pos=t(_pad(np.asarray([cd["local_pos"] for cd in self._colliders], np.float32), m)),
                local_quat=t(_pad(np.asarray([cd["local_quat"] for cd in self._colliders], np.float32), m)),
                friction=t(_pad(np.asarray(col["friction"], np.float32), m)),
                static_friction=t(_pad(np.asarray(col["static_friction"], np.float32), m)),
                restitution=t(_pad(np.asarray(col["restitution"], np.float32), m)),
                friction_combine=t(_pad(np.asarray(col["friction_combine"], np.int32), m)),
                restitution_combine=t(_pad(np.asarray(col["restitution_combine"], np.int32), m)),
                density=t(_pad(np.asarray(col["density"], np.float32), m, 1.0)),
                layer_members=t(_pad(np.asarray(col["layer_members"], np.uint32), m).view(np.int32)),
                layer_filter=t(_pad(np.asarray(col["layer_filter"], np.uint32), m).view(np.int32)),
                is_sensor=t(_pad(np.asarray(col["is_sensor"], bool), m, False)),
                active=t(np.arange(m) < nc),
                collision_margin=t(_pad(np.asarray(col["collision_margin"], np.float32), m)),
                speculative_margin=t(_pad(np.asarray(col["speculative_margin"], np.float32), m, _INF)),
            )
        else:
            colliders = world.colliders

        # Auto mass properties, accumulated per body (reference finalize).
        auto_mass = np.zeros(n, np.float32)
        auto_first_moment = np.zeros((n, 3), np.float32)
        auto_inertia = np.zeros((n, 6), np.float32)
        if nc:
            st = np.asarray([cd["shape"] for cd in self._colliders], np.int32)
            pr = np.asarray([cd["params"] for cd in self._colliders], np.float32)
            dens = np.asarray(col["density"], np.float32)
            cm, ci6, ccom = _mass_properties_np(st, pr, dens)
            lp = np.asarray(
                [cd["local_pos"] for cd in self._colliders], np.float32
            ).reshape(nc, 3)
            shape_com = lp + ccom
            i6 = _shift_inertia_np(ci6, cm, shape_com)
            body_of = np.asarray([cd["body"] for cd in self._colliders], np.int64)
            np.add.at(auto_mass, body_of, cm)
            np.add.at(auto_first_moment, body_of, cm[:, None] * shape_com)
            np.add.at(auto_inertia, body_of, i6)

        masses = np.zeros(nb, np.float32)
        coms = np.zeros((nb, 3), np.float32)
        i6s = np.zeros((nb, 6), np.float32)
        dyn = np.zeros(nb, bool)
        explicit_i = np.zeros(nb, bool)
        for i, bd in enumerate(self._bodies):
            dyn[i] = bd["body_type"] == BodyType.DYNAMIC
            masses[i] = bd["mass"] if bd["mass"] is not None else auto_mass[i]
            if bd["com"] is not None:
                coms[i] = np.asarray(bd["com"], np.float32)
            elif auto_mass[i] > 0:
                coms[i] = auto_first_moment[i] / auto_mass[i]
            if bd["inertia"] is not None:
                it = np.asarray(bd["inertia"], np.float32)
                i6s[i] = (
                    np.concatenate([it, np.zeros(3, np.float32)])
                    if it.shape == (3,)
                    else it
                )
                explicit_i[i] = True

        shifted = _shift_inertia_np(auto_inertia[:nb], -auto_mass[:nb], coms)
        i6s = np.where(explicit_i[:, None], i6s, shifted)
        invertible = dyn & (masses > 0)
        inv_mass = np.where(invertible, 1.0 / np.maximum(masses, 1e-30), 0.0)
        inv_i6 = _sym3_inverse_np(i6s.astype(np.float32))
        inv_i6 = np.where(invertible[:, None], inv_i6, 0.0).astype(np.float32)

        if nb:
            arr = {k: [bd[k] for bd in self._bodies] for k in _BODY_KEYS}
            quat = _pad(np.asarray([bd["quat"] for bd in self._bodies], np.float32), n)
            quat[nb:, 3] = 1.0
            bodies = world.bodies.replace(
                pos=t(_pad(np.asarray([bd["pos"] for bd in self._bodies], np.float32), n)),
                quat=t(quat),
                lin_vel=t(_pad(np.asarray([bd["lin_vel"] for bd in self._bodies], np.float32), n)),
                ang_vel=t(_pad(np.asarray([bd["ang_vel"] for bd in self._bodies], np.float32), n)),
                inv_mass=t(_pad(inv_mass.astype(np.float32), n)),
                inv_inertia=t(_pad(inv_i6, n)),
                com=t(_pad(coms, n)),
                gravity_scale=t(_pad(np.asarray(arr["gravity_scale"], np.float32), n, 1.0)),
                lin_damping=t(_pad(np.asarray(arr["lin_damping"], np.float32), n)),
                ang_damping=t(_pad(np.asarray(arr["ang_damping"], np.float32), n)),
                max_lin_speed=t(_pad(np.asarray(arr["max_lin_speed"], np.float32), n, _INF)),
                max_ang_speed=t(_pad(np.asarray(arr["max_ang_speed"], np.float32), n, _INF)),
                dominance=t(_pad(np.asarray(arr["dominance"], np.int32), n)),
                body_type=t(_pad(np.asarray(arr["body_type"], np.int32), n)),
                active=t(np.arange(n) < nb),
                locked_axes=t(_pad(np.asarray(arr["locked_axes"], np.int32), n)),
                gyroscopic=t(_pad(np.asarray(arr["gyroscopic"], bool), n, False)),
                swept_ccd=t(_pad(np.asarray(arr["swept_ccd"], bool), n, False)),
                swept_ccd_nonlinear=t(_pad(np.asarray(arr["swept_ccd_nonlinear"], bool), n, False)),
                sleep_disabled=t(_pad(np.asarray(arr["sleep_disabled"], bool), n, False)),
            )
        else:
            bodies = world.bodies

        joints = world.joints
        if nj:
            def jcol(key, dtype, fill=0.0):
                return t(_pad(np.asarray([jd[key] for jd in self._joints], dtype), j, fill))

            quat_a, quat_b = jcol("basis_a", np.float32), jcol("basis_b", np.float32)
            quat_a[nj:, 3] = 1.0
            quat_b[nj:, 3] = 1.0
            joints = joints.replace(
                jtype=jcol("jtype", np.int32),
                body_a=jcol("body_a", np.int32),
                body_b=jcol("body_b", np.int32),
                active=t(np.arange(j) < nj),
                frame_pos_a=jcol("anchor_a", np.float32),
                frame_pos_b=jcol("anchor_b", np.float32),
                frame_quat_a=quat_a,
                frame_quat_b=quat_b,
                compliance=jcol("compliance", np.float32),
                limit_min=jcol("limit_min", np.float32),
                limit_max=jcol("limit_max", np.float32),
                limit_enabled=jcol("limit_enabled", bool, False),
                twist_min=jcol("twist_min", np.float32),
                twist_max=jcol("twist_max", np.float32),
                twist_enabled=jcol("twist_enabled", bool, False),
                lin_damping=jcol("lin_damping", np.float32),
                ang_damping=jcol("ang_damping", np.float32),
                collision_disabled=jcol("collision_disabled", bool, False),
            )

        world = world.replace(
            bodies=bodies,
            colliders=colliders,
            joints=joints,
            gravity=torch.tensor(self.gravity, dtype=torch.float32),
            shape_pairs=self.shape_pairs(),
        )
        return world.to(device)


def _quat_from_z_to(axis):
    """Quaternion rotating local +Z onto ``axis`` (reference
    ``_quat_from_z_to``)."""
    axis = axis / max(float(np.linalg.norm(axis)), 1e-12)
    z = np.array([0.0, 0.0, 1.0], np.float32)
    c = float(np.dot(z, axis))
    if c > 1.0 - 1e-8:
        return np.array([0.0, 0.0, 0.0, 1.0], np.float32)
    if c < -1.0 + 1e-8:
        return np.array([1.0, 0.0, 0.0, 0.0], np.float32)  # 180 degrees about X
    v = np.cross(z, axis)
    s = math.sqrt((1.0 + c) * 2.0)
    return np.array([v[0] / s, v[1] / s, v[2] / s, s / 2.0], np.float32)
