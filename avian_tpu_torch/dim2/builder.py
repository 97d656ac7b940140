"""2D host-side scene builder (port of ``avian_tpu/dim2/builder.py``).

Every 2D shape of the reference lowers to a rounded convex polygon of at most
8 CCW vertices: circle, rectangle/box, round_rectangle, capsule (and
capsule_endpoints), segment, polyline, triangle, regular_polygon,
convex_hull, convex_polyline, ellipse (the inscribed 8-gon, with the exact
ellipse's mass properties) and half_space. Mass properties, padding and
defaults are the reference's, computed in numpy on the host, so a world built
here equals the reference's leaf for leaf. ``add_joint`` fills the joint
columns; the port's 2D step refuses a world with an active joint.
``finalize`` builds on the card unless ``device="cpu"`` is passed.
"""

import math as _math

import numpy as np
import torch

from avian_tpu_torch.core.device import resolve
from avian_tpu_torch.core.types import BodyType, JointType
from avian_tpu_torch.dim2.state import (
    MAX_POLY_VERTS,
    Bodies2D,
    Colliders2D,
    Contacts2D,
    Joints2D,
    World2D,
)

_INF = float("inf")

# Shape tags (API/debug; the pipeline only reads verts/radius/is_plane).
TAG_CIRCLE = 0
TAG_RECTANGLE = 1
TAG_CAPSULE = 2
TAG_SEGMENT = 3
TAG_TRIANGLE = 4
TAG_REGULAR_POLYGON = 5
TAG_CONVEX = 6
TAG_ELLIPSE = 7
TAG_ROUND_RECTANGLE = 8
TAG_HALF_SPACE = 9


def _ccw(points):
    """Ensure CCW winding (outward normals in the narrowphase)."""
    p = np.asarray(points, np.float32)
    area2 = 0.0
    for i in range(len(p)):
        j = (i + 1) % len(p)
        area2 += p[i][0] * p[j][1] - p[j][0] * p[i][1]
    return p if area2 >= 0 else p[::-1].copy()


def _poly_mass_props(verts, density):
    """(mass, inertia_about_origin, centroid) for a solid CCW polygon."""
    v = np.asarray(verts, np.float64)
    n = len(v)
    a2 = 0.0
    cx = cy = 0.0
    inertia = 0.0
    for i in range(n):
        j = (i + 1) % n
        cr = v[i][0] * v[j][1] - v[j][0] * v[i][1]
        a2 += cr
        cx += (v[i][0] + v[j][0]) * cr
        cy += (v[i][1] + v[j][1]) * cr
        inertia += cr * (
            v[i] @ v[i] + v[i] @ v[j] + v[j] @ v[j]
        )
    area = 0.5 * a2
    if area <= 1e-12:
        return 0.0, 0.0, np.zeros(2, np.float32)
    centroid = np.asarray([cx, cy], np.float64) / (6.0 * area)
    mass = density * area
    inertia = density * inertia / 12.0  # about origin
    return float(mass), float(inertia), centroid.astype(np.float32)


def convex_hull_2d(points):
    """Andrew's monotone chain; returns CCW hull vertices."""
    pts = sorted({(float(x), float(y)) for x, y in np.asarray(points)})
    if len(pts) <= 2:
        return np.asarray(pts, np.float32)

    def half(seq):
        out = []
        for p in seq:
            while len(out) >= 2:
                o, a = out[-2], out[-1]
                if (a[0] - o[0]) * (p[1] - o[1]) - (a[1] - o[1]) * (
                    p[0] - o[0]
                ) <= 0:
                    out.pop()
                else:
                    break
            out.append(p)
        return out

    lower = half(pts)
    upper = half(reversed(pts))
    return np.asarray(lower[:-1] + upper[:-1], np.float32)


class SceneBuilder2D:
    def __init__(self):
        self._bodies = []
        self._colliders = []
        self._joints = []

    # ------------------------------------------------------------------
    def add_body(
        self,
        pos=(0.0, 0.0),
        angle: float = 0.0,
        lin_vel=(0.0, 0.0),
        ang_vel: float = 0.0,
        body_type: int = BodyType.DYNAMIC,
        mass: float | None = None,
        inertia: float | None = None,
        com=None,
        gravity_scale: float = 1.0,
        lin_damping: float = 0.0,
        ang_damping: float = 0.0,
        max_lin_speed: float = _INF,
        max_ang_speed: float = _INF,
        dominance: int = 0,
        locked_axes: int = 0,
        sleep_disabled: bool = False,
        swept_ccd: bool = False,
        swept_ccd_nonlinear: bool = False,
    ) -> int:
        self._bodies.append(
            dict(
                pos=np.asarray(pos, np.float32),
                angle=float(angle),
                lin_vel=np.asarray(lin_vel, np.float32),
                ang_vel=float(ang_vel),
                body_type=int(body_type),
                mass=mass,
                inertia=inertia,
                com=com,
                gravity_scale=gravity_scale,
                lin_damping=lin_damping,
                ang_damping=ang_damping,
                max_lin_speed=max_lin_speed,
                max_ang_speed=max_ang_speed,
                dominance=dominance,
                locked_axes=locked_axes,
                sleep_disabled=sleep_disabled,
                swept_ccd=swept_ccd,
                swept_ccd_nonlinear=swept_ccd_nonlinear,
            )
        )
        return len(self._bodies) - 1

    # ------------------------------------------------------------------
    def _add(self, body, verts, radius, tag, is_plane=False, **kw):
        verts = np.asarray(verts, np.float32).reshape(-1, 2)
        if verts.shape[0] > MAX_POLY_VERTS:
            raise ValueError(
                f"2D colliders support <= {MAX_POLY_VERTS} vertices, got "
                f"{verts.shape[0]} (decompose into multiple colliders)"
            )
        defaults = dict(
            local_pos=(0.0, 0.0),
            local_angle=0.0,
            friction=0.5,
            static_friction=None,
            restitution=0.0,
            friction_combine=0,
            restitution_combine=0,
            density=1.0,
            layer_members=0xFFFFFFFF,
            layer_filter=0xFFFFFFFF,
            is_sensor=False,
            collision_margin=0.0,
            speculative_margin=_INF,
            mass_override=None,
        )
        unknown = set(kw) - set(defaults)
        if unknown:
            raise TypeError(f"unknown collider kwargs: {unknown}")
        defaults.update(kw)
        if defaults["static_friction"] is None:
            defaults["static_friction"] = defaults["friction"]
        padded = np.zeros((MAX_POLY_VERTS, 2), np.float32)
        padded[: verts.shape[0]] = verts
        padded[verts.shape[0]:] = verts[-1] if verts.shape[0] else 0.0
        self._colliders.append(
            dict(
                verts=padded,
                count=max(verts.shape[0], 1),
                radius=float(radius),
                tag=tag,
                is_plane=is_plane,
                body=body,
                **defaults,
            )
        )
        return len(self._colliders) - 1

    def circle(self, body, radius, **kw):
        return self._add(body, [(0.0, 0.0)], radius, TAG_CIRCLE, **kw)

    def rectangle(self, body, x_len, y_len, **kw):
        hx, hy = x_len / 2, y_len / 2
        v = [(hx, -hy), (hx, hy), (-hx, hy), (-hx, -hy)]
        return self._add(body, v, 0.0, TAG_RECTANGLE, **kw)

    def box(self, body, hx, hy, **kw):
        return self.rectangle(body, 2 * hx, 2 * hy, **kw)

    def round_rectangle(self, body, x_len, y_len, radius, **kw):
        """Parry RoundCuboid semantics: core x_len x y_len rectangle with
        the border radius added OUTSIDE (``parry/mod.rs:759-765``)."""
        hx, hy = x_len / 2, y_len / 2
        v = [(hx, -hy), (hx, hy), (-hx, hy), (-hx, -hy)]
        return self._add(body, v, radius, TAG_ROUND_RECTANGLE, **kw)

    def capsule(self, body, radius, length, **kw):
        """Y-axis capsule: segment of ``length`` plus ``radius`` (2D
        ``Collider::capsule``, ``parry/mod.rs:773``)."""
        h = length / 2
        return self._add(
            body, [(0.0, -h), (0.0, h)], radius, TAG_CAPSULE, **kw
        )

    def capsule_endpoints(self, body, radius, a, b, **kw):
        return self._add(body, [a, b], radius, TAG_CAPSULE, **kw)

    def segment(self, body, a, b, **kw):
        """Zero-thickness segment (``parry/mod.rs:817``). Massless, like
        Parry's; meant for static geometry (use ``capsule_endpoints`` for
        a dynamic thick segment)."""
        return self._add(body, [a, b], 0.0, TAG_SEGMENT, **kw)

    def polyline(self, body, points, **kw):
        """Open polyline = one segment collider per consecutive pair
        (``parry/mod.rs:821``: static-geometry shape)."""
        pts = np.asarray(points, np.float32)
        return [
            self.segment(body, pts[i], pts[i + 1], **kw)
            for i in range(len(pts) - 1)
        ]

    def triangle(self, body, a, b, c, **kw):
        return self._add(body, _ccw([a, b, c]), 0.0, TAG_TRIANGLE, **kw)

    def regular_polygon(self, body, circumradius, sides, **kw):
        """``Collider::regular_polygon`` (``parry/mod.rs:833``); <= 8 sides
        (more sides: use convex_hull of your own points)."""
        if not 3 <= sides <= MAX_POLY_VERTS:
            raise ValueError(f"sides must be in [3, {MAX_POLY_VERTS}]")
        v = [
            (
                circumradius * _math.cos(2 * _math.pi * i / sides),
                circumradius * _math.sin(2 * _math.pi * i / sides),
            )
            for i in range(sides)
        ]
        return self._add(body, v, 0.0, TAG_REGULAR_POLYGON, **kw)

    def convex_hull(self, body, points, **kw):
        hull = convex_hull_2d(points)
        if hull.shape[0] < 3:
            raise ValueError("convex_hull needs >= 3 non-collinear points")
        return self._add(body, hull, 0.0, TAG_CONVEX, **kw)

    def convex_polyline(self, body, points, **kw):
        """``Collider::convex_polyline``: points are trusted to already be
        a convex CCW loop (``parry/mod.rs:845``)."""
        return self._add(body, _ccw(points), 0.0, TAG_CONVEX, **kw)

    def ellipse(self, body, half_width, half_height, **kw):
        """Inscribed 8-gon approximation of the ellipse boundary
        (``parry/mod.rs:741`` uses an exact support map; the polygon error
        is <= 1 - cos(pi/8) ~ 7.6% of the radius at the flattest point).
        Mass properties are the EXACT ellipse's."""
        v = [
            (
                half_width * _math.cos(2 * _math.pi * i / 8),
                half_height * _math.sin(2 * _math.pi * i / 8),
            )
            for i in range(8)
        ]
        a, b = half_width, half_height
        mass_fn = lambda rho: (
            rho * _math.pi * a * b,
            rho * _math.pi * a * b * (a * a + b * b) / 4.0,
            np.zeros(2, np.float32),
        )
        return self._add(
            body, v, 0.0, TAG_ELLIPSE, mass_override=mass_fn, **kw
        )

    def half_space(self, body, normal=(0.0, 1.0), **kw):
        n = np.asarray(normal, np.float32)
        n = n / max(float(np.linalg.norm(n)), 1e-12)
        return self._add(
            body, [tuple(n)], 0.0, TAG_HALF_SPACE, is_plane=True, **kw
        )

    # ------------------------------------------------------------------
    def add_joint(
        self,
        jtype: JointType,
        body_a: int,
        body_b: int,
        anchor_a=(0.0, 0.0),
        anchor_b=(0.0, 0.0),
        axis_angle: float = 0.0,
        reference_angle: float = 0.0,
        compliance=(0.0, 0.0, 0.0, 0.0),
        limit_min: float = 0.0,
        limit_max: float = 0.0,
        limit_enabled: bool = False,
        lin_damping: float = 0.0,
        ang_damping: float = 0.0,
        collision_disabled: bool = True,
    ) -> int:
        if int(jtype) == int(JointType.SPHERICAL):
            raise ValueError("spherical joints are 3D; use REVOLUTE in 2D")
        self._joints.append(
            dict(
                jtype=int(jtype),
                body_a=body_a,
                body_b=body_b,
                anchor_a=np.asarray(anchor_a, np.float32),
                anchor_b=np.asarray(anchor_b, np.float32),
                axis_angle=float(axis_angle),
                reference_angle=float(reference_angle),
                compliance=np.asarray(compliance, np.float32),
                limit_min=limit_min,
                limit_max=limit_max,
                limit_enabled=limit_enabled,
                lin_damping=lin_damping,
                ang_damping=ang_damping,
                collision_disabled=collision_disabled,
            )
        )
        return len(self._joints) - 1

    # ------------------------------------------------------------------
    def _collider_mass(self, cd):
        """(mass, inertia_about_body_origin, com) for one collider."""
        rho = cd["density"]
        if cd["is_plane"]:
            return 0.0, 0.0, np.zeros(2, np.float32)
        if cd["mass_override"] is not None:
            m, i_com, com = cd["mass_override"](rho)
        else:
            verts = cd["verts"][: cd["count"]]
            r = cd["radius"]
            tag = cd["tag"]
            if tag == TAG_CIRCLE:
                m = rho * _math.pi * r * r
                i_com = 0.5 * m * r * r
                com = verts[0].copy()
            elif tag in (TAG_CAPSULE, TAG_SEGMENT) and cd["count"] == 2:
                a, b = verts[0], verts[1]
                length = float(np.linalg.norm(b - a))
                mid = 0.5 * (a + b)
                m_rect = rho * 2 * r * length
                m_caps = rho * _math.pi * r * r
                m = m_rect + m_caps
                # Capsule inertia about its center (axis along the segment).
                i_rect = m_rect * (length**2 + (2 * r) ** 2) / 12.0
                d = length / 2
                i_circ = m_caps * (
                    0.5 * r * r + d * d + (8.0 / (3.0 * _math.pi)) * r * d
                )
                i_com = i_rect + i_circ
                com = mid
            else:
                m, i_origin, com = _poly_mass_props(verts, rho)
                if cd["radius"] > 0:
                    # Rounded polygon: approximate with the Minkowski-sum
                    # area (core + perimeter strip + corner disc).
                    perim = float(
                        sum(
                            np.linalg.norm(
                                verts[(i + 1) % len(verts)] - verts[i]
                            )
                            for i in range(len(verts))
                        )
                    )
                    extra = rho * (perim * r + _math.pi * r * r)
                    i_origin *= (m + extra) / max(m, 1e-9)
                    m += extra
                # Convert: inertia about own COM.
                i_com = i_origin - m * float(com @ com)
            # i_com currently about the shape's COM in shape frame.
        # Offset by the collider's local transform.
        ca, sa = _math.cos(cd["local_angle"]), _math.sin(cd["local_angle"])
        com_rot = np.asarray(
            [ca * com[0] - sa * com[1], sa * com[0] + ca * com[1]], np.float32
        )
        com_body = np.asarray(cd["local_pos"], np.float32) + com_rot
        i_body_origin = i_com + m * float(com_body @ com_body)
        return m, i_body_origin, com_body

    def finalize(
        self,
        max_bodies: int | None = None,
        max_colliders: int | None = None,
        max_contacts: int | None = None,
        max_joints: int | None = None,
        device=None,
    ) -> World2D:
        device = resolve(device)
        nb = len(self._bodies)
        nc = len(self._colliders)
        nj = len(self._joints)
        n = max_bodies or max(nb, 1)
        m = max_colliders or max(nc, 1)
        c = max_contacts or max(8 * m, 64)
        j = max_joints if max_joints is not None else max(nj, 1)
        if not (nb <= n and nc <= m and nj <= j):
            raise ValueError(f"capacities ({n}, {m}, {j}) below the scene's ({nb}, {nc}, {nj})")
        if m > 46340:
            raise ValueError("pair keys are i32 a * M + b in the reference; M must be <= 46340")

        def pad(arr, total, fill=0.0, dtype=None):
            a = np.asarray(arr)
            if dtype is not None:
                a = a.astype(dtype)
            pad_shape = (total - a.shape[0],) + a.shape[1:]
            return np.concatenate([a, np.full(pad_shape, fill, a.dtype)], 0)

        def columns(cls, empty, values):
            """``cls`` from the reference's ``zeros`` columns (``empty``)
            with ``values`` replacing some of them."""
            base = {k: v.numpy() for k, v in vars(empty).items()}
            base.update(values)
            return cls.from_numpy(_Tree(base), device)

        # ---- colliders -------------------------------------------------
        col = {}
        if nc:
            cget = lambda k, dt=np.float32: np.asarray(
                [cd[k] for cd in self._colliders], dt
            )
            col = dict(
                poly_verts=pad(np.stack([cd["verts"] for cd in self._colliders]), m),
                vert_count=pad(cget("count", np.int32), m, 1),
                radius=pad(cget("radius"), m),
                is_plane=pad(cget("is_plane", bool), m, False),
                shape_tag=pad(cget("tag", np.int32), m),
                body_idx=pad(cget("body", np.int32), m),
                local_pos=pad(cget("local_pos"), m),
                local_angle=pad(cget("local_angle"), m),
                friction=pad(cget("friction"), m),
                static_friction=pad(cget("static_friction"), m),
                restitution=pad(cget("restitution"), m),
                friction_combine=pad(cget("friction_combine", np.int32), m),
                restitution_combine=pad(cget("restitution_combine", np.int32), m),
                density=pad(cget("density"), m, 1.0),
                layer_members=pad(cget("layer_members", np.uint32), m),
                layer_filter=pad(cget("layer_filter", np.uint32), m),
                is_sensor=pad(cget("is_sensor", bool), m, False),
                active=np.arange(m) < nc,
                collision_margin=pad(cget("collision_margin"), m),
                speculative_margin=pad(cget("speculative_margin"), m, _INF),
            )
        colliders = columns(Colliders2D, Colliders2D.zeros(m, "cpu"), col)

        # ---- bodies: auto mass properties ------------------------------
        auto_mass = np.zeros(n, np.float32)
        auto_moment = np.zeros((n, 2), np.float32)
        auto_inertia = np.zeros(n, np.float32)  # about body origin
        for cd in self._colliders:
            mm, ii, com = self._collider_mass(cd)
            bidx = cd["body"]
            auto_mass[bidx] += mm
            auto_moment[bidx] += mm * com
            auto_inertia[bidx] += ii

        pos = np.zeros((n, 2), np.float32)
        angle = np.zeros(n, np.float32)
        lin_vel = np.zeros((n, 2), np.float32)
        ang_vel = np.zeros(n, np.float32)
        inv_mass = np.zeros(n, np.float32)
        inv_inertia = np.zeros(n, np.float32)
        com_arr = np.zeros((n, 2), np.float32)
        scal = {
            k: np.zeros(n, np.float32)
            for k in (
                "gravity_scale", "lin_damping", "ang_damping",
                "max_lin_speed", "max_ang_speed",
            )
        }
        dominance = np.zeros(n, np.int32)
        body_type = np.zeros(n, np.int32)
        locked = np.zeros(n, np.int32)
        sleep_dis = np.zeros(n, bool)
        swept = np.zeros(n, bool)
        swept_nl = np.zeros(n, bool)

        for i, bd in enumerate(self._bodies):
            pos[i] = bd["pos"]
            angle[i] = bd["angle"]
            lin_vel[i] = bd["lin_vel"]
            ang_vel[i] = bd["ang_vel"]
            body_type[i] = bd["body_type"]
            mass = bd["mass"] if bd["mass"] is not None else auto_mass[i]
            com = (
                np.asarray(bd["com"], np.float32)
                if bd["com"] is not None
                else (
                    auto_moment[i] / mass
                    if bd["mass"] is None and mass > 0
                    else np.zeros(2, np.float32)
                )
            )
            inertia = (
                bd["inertia"]
                if bd["inertia"] is not None
                else max(auto_inertia[i] - mass * float(com @ com), 0.0)
            )
            if bd["body_type"] == BodyType.DYNAMIC:
                inv_mass[i] = 1.0 / mass if mass > 0 else 0.0
                inv_inertia[i] = 1.0 / inertia if inertia > 0 else 0.0
            com_arr[i] = com
            for k in scal:
                scal[k][i] = bd[k]
            dominance[i] = bd["dominance"]
            locked[i] = bd["locked_axes"]
            sleep_dis[i] = bd["sleep_disabled"]
            swept[i] = bd["swept_ccd"]
            swept_nl[i] = bd["swept_ccd_nonlinear"]

        finite_or_inf = lambda x: np.where(np.isfinite(x), x, np.float32(_INF))
        bodies = columns(Bodies2D, Bodies2D.zeros(n, "cpu"), dict(
            pos=pos, angle=angle, lin_vel=lin_vel, ang_vel=ang_vel,
            inv_mass=inv_mass, inv_inertia=inv_inertia, com=com_arr,
            gravity_scale=scal["gravity_scale"], lin_damping=scal["lin_damping"],
            ang_damping=scal["ang_damping"],
            max_lin_speed=finite_or_inf(scal["max_lin_speed"]),
            max_ang_speed=finite_or_inf(scal["max_ang_speed"]),
            dominance=dominance, body_type=body_type, active=np.arange(n) < nb,
            locked_axes=locked, sleep_disabled=sleep_dis, swept_ccd=swept,
            swept_ccd_nonlinear=swept_nl,
        ))

        # ---- joints ----------------------------------------------------
        jnt = {}
        if nj:
            jget = lambda k, dt=np.float32: np.asarray(
                [jd[k] for jd in self._joints], dt
            )
            jnt = dict(
                jtype=pad(jget("jtype", np.int32), j),
                body_a=pad(jget("body_a", np.int32), j),
                body_b=pad(jget("body_b", np.int32), j),
                active=np.arange(j) < nj,
                anchor_a=pad(jget("anchor_a"), j),
                anchor_b=pad(jget("anchor_b"), j),
                axis_angle=pad(jget("axis_angle"), j),
                reference_angle=pad(jget("reference_angle"), j),
                compliance=pad(jget("compliance"), j),
                limit_min=pad(jget("limit_min"), j),
                limit_max=pad(jget("limit_max"), j),
                limit_enabled=pad(jget("limit_enabled", bool), j, False),
                lin_damping=pad(jget("lin_damping"), j),
                ang_damping=pad(jget("ang_damping"), j),
                collision_disabled=pad(jget("collision_disabled", bool), j, False),
            )
        joints = columns(Joints2D, Joints2D.zeros(j, "cpu"), jnt)

        empty = World2D.zeros(n, m, c, j, device=device)
        return empty.replace(
            bodies=bodies, colliders=colliders,
            contacts=Contacts2D.zeros(c, device), joints=joints,
        )


class _Tree:
    """Attribute access to a dict of numpy columns, as ``from_numpy`` reads."""

    def __init__(self, columns):
        self.__dict__.update(columns)
