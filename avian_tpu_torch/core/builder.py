"""Host-side scene construction (port of ``avian_tpu/core/builder.py``).

The subset the ported scenes need: ``add_body``, ``add_body_2d``, ``sphere``,
``capsule``, ``box``, ``cuboid``, ``cylinder``, ``cone``, ``half_space``,
``segment``, ``triangle``, ``trimesh``, ``heightfield``, ``voxels``,
``convex_hull``, ``round_cuboid``, ``add_joint``, ``revolute_joint`` and
``finalize``. Everything is numpy until ``finalize``, with the reference's
mass properties (the exact tetrahedron decomposition of a hull, the Steiner
volume of a round cuboid), vertex pool and padding, so a scene built here
equals the reference's leaf for leaf. ``convex_decomposition`` (it needs the
reference's host C++ decomposer) and ``custom_collider`` (user shapes) raise
``NotImplementedError``.
"""

import math

import numpy as np
import torch

from avian_tpu_torch.core import types
from avian_tpu_torch.core.device import resolve
from avian_tpu_torch.core.state import World
from avian_tpu_torch.core.types import CUSTOM_SHAPE_BASE, BodyType, JointType, ShapeType
from avian_tpu_torch.geometry.convex import MAX_HULL_VERTS

_INF = float("inf")
_SUPPORTED = (ShapeType.SPHERE, ShapeType.CAPSULE, ShapeType.BOX, ShapeType.PLANE,
              ShapeType.CYLINDER, ShapeType.CONE, ShapeType.SEGMENT, ShapeType.CONVEX)
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


def _hull_mass_props_np(pts, hull, density):
    """Exact convex-polyhedron mass properties by signed tetrahedron
    decomposition (reference ``_hull_mass_props_np``, its arithmetic).
    Returns (mass, inertia sym6 about the COM, com)."""
    C_can = np.full((3, 3), 1.0 / 120.0)
    np.fill_diagonal(C_can, 1.0 / 60.0)
    vol = 0.0
    first = np.zeros(3)
    C = np.zeros((3, 3))
    for fi, simplex in enumerate(hull.simplices):
        a, b, c = pts[simplex]
        # qhull does not orient simplices consistently: flip each so that its
        # winding matches the outward face normal of ``equations``.
        n_out = hull.equations[fi, :3]
        if np.dot(n_out, np.cross(b - a, c - a)) < 0.0:
            b, c = c, b
        A = np.stack([a, b, c], axis=1)
        det = np.linalg.det(A)
        vol += det / 6.0
        first += det / 6.0 * (a + b + c) / 4.0
        C += det * (A @ C_can @ A.T)
    vol = abs(vol) if vol != 0 else 1e-12
    com = first / vol
    mass = density * vol
    C = density * C - mass * np.outer(com, com)
    inertia = np.trace(C) * np.eye(3) - C
    i6 = np.asarray(
        [inertia[0, 0], inertia[1, 1], inertia[2, 2],
         inertia[0, 1], inertia[0, 2], inertia[1, 2]], np.float32
    )
    return np.float32(mass), i6, com.astype(np.float32)


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
        self._convex_verts = []  # np [k, 3] vertex blocks of the pool
        self._convex_verts_len = 0
        self._custom_shapes = []  # CustomShape instances; code = CUSTOM_SHAPE_BASE + index
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
        _hull_cache=None,
        _mass_cache=None,
    ) -> int:
        if int(shape) < CUSTOM_SHAPE_BASE and int(shape) not in _SUPPORTED:
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
                hull_cache=_hull_cache, mass_cache=_mass_cache,
            )
        )
        return len(self._colliders) - 1

    def _pool_append(self, verts):
        """Append a vertex block to the pool; returns its offset."""
        offset = self._convex_verts_len
        self._convex_verts.append(verts)
        self._convex_verts_len += verts.shape[0]
        return offset

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

    def cuboid(self, body, x_len, y_len, z_len, **kw):
        return self.box(body, x_len / 2, y_len / 2, z_len / 2, **kw)

    def half_space(self, body, normal=(0.0, 1.0, 0.0), **kw):
        n = np.asarray(normal, np.float32)
        n = n / max(float(np.linalg.norm(n)), 1e-12)
        return self.add_collider(body, ShapeType.PLANE, tuple(n), **kw)

    def segment(self, body, a, b, **kw):
        """Segment between the body-local points ``a`` and ``b``: massless,
        stored as a half length on local X, the collider's local pose
        carrying the midpoint and the rotation of +X onto ``b - a``."""
        a = np.asarray(a, np.float32)
        bb = np.asarray(b, np.float32)
        mid = (a + bb) / 2.0
        d = bb - a
        length = float(np.linalg.norm(d))
        if length < 1e-9:
            raise ValueError("segment endpoints coincide")
        dn = d / length
        x = np.asarray([1.0, 0.0, 0.0], np.float32)
        c = float(np.dot(x, dn))
        axis = np.cross(x, dn)
        s = float(np.linalg.norm(axis))
        if s < 1e-9:
            q = (
                np.asarray([0, 0, 0, 1], np.float32)
                if c > 0
                else np.asarray([0, 0, 1, 0], np.float32)  # 180 degrees about Z
            )
        else:
            axis = axis / s
            half = 0.5 * np.arctan2(s, c)
            q = np.asarray([*(np.sin(half) * axis), np.cos(half)], np.float32)
        lp = np.asarray(kw.pop("local_pos", (0.0, 0.0, 0.0)), np.float32)
        return self.add_collider(
            body, ShapeType.SEGMENT, (length / 2.0,),
            local_pos=tuple(lp + mid), local_quat=tuple(q), **kw,
        )

    def round_cuboid(self, body, x_len, y_len, z_len, border_radius, **kw):
        """Cuboid with rounded edges and corners: the inner box's 8 corners
        in the pool and the border radius in params lane 6 (a round hull).
        Mass from the Steiner volume of the rounded solid, inertia of the box
        of its outer extents (the reference's choice)."""
        hx, hy, hz = x_len / 2.0, y_len / 2.0, z_len / 2.0
        r = float(border_radius)
        if r < 0.0 or min(hx, hy, hz) <= 0.0:
            raise ValueError("round_cuboid needs positive extents, r >= 0")
        corners = np.asarray(
            [(sx * hx, sy * hy, sz * hz)
             for sx in (-1.0, 1.0) for sy in (-1.0, 1.0) for sz in (-1.0, 1.0)],
            np.float32,
        )
        offset = self._pool_append(corners)
        dens = float(kw.get("density", 1.0))
        vol = (
            8.0 * hx * hy * hz
            + 8.0 * (hx * hy + hy * hz + hz * hx) * r
            + 2.0 * _PI * (hx + hy + hz) * r * r
            + (4.0 / 3.0) * _PI * r**3
        )
        m = dens * vol
        ox, oy, oz = hx + r, hy + r, hz + r
        i3 = (
            np.asarray([oy * oy + oz * oz, ox * ox + oz * oz, ox * ox + oy * oy], np.float32)
            * (m / 3.0)
        )
        i6 = np.concatenate([i3, np.zeros(3, np.float32)]).astype(np.float32)
        return self.add_collider(
            body, ShapeType.CONVEX, (float(offset), 8.0, ox, oy, oz, 0.0, r),
            _mass_cache=(np.float32(m), i6, np.zeros(3, np.float32)), **kw,
        )

    def triangle(self, body, a, b, c, **kw):
        """One double-sided, massless triangle: 3 pool vertices about its
        centroid, which becomes the collider's local offset; lane 5 flags it
        flat (its face normal dominates a frontal contact's normal)."""
        tri = np.asarray([a, b, c], np.float32)
        centroid = tri.mean(axis=0)
        tri = tri - centroid
        lp = np.asarray(kw.pop("local_pos", (0.0, 0.0, 0.0)), np.float32)
        offset = self._pool_append(tri)
        h = np.abs(tri).max(axis=0)
        return self.add_collider(
            body, ShapeType.CONVEX,
            (float(offset), 3.0, float(h[0]), float(h[1]), float(h[2]), 1.0),
            local_pos=tuple(lp + centroid), **kw,
        )

    def trimesh(self, body, vertices, faces, **kw):
        """Triangle mesh: one triangle collider per face, all on ``body``
        (the broadphase's grid culls the triangles). Returns their indices."""
        verts = np.asarray(vertices, np.float32).reshape(-1, 3)
        faces = np.asarray(faces, np.int64).reshape(-1, 3)
        return [self.triangle(body, verts[f[0]], verts[f[1]], verts[f[2]], **kw)
                for f in faces]

    def heightfield(self, body, heights, x_extent, z_extent, **kw):
        """A regular ``[nx, nz]`` grid of heights over ``x_extent x
        z_extent`` centred on the body, two triangles a cell (the
        reference's triangulation). Returns the triangles' indices."""
        hf = np.asarray(heights, np.float32)
        nx, nz = hf.shape
        xs = np.linspace(-x_extent / 2.0, x_extent / 2.0, nx)
        zs = np.linspace(-z_extent / 2.0, z_extent / 2.0, nz)
        verts = np.stack(
            [np.repeat(xs, nz), hf.reshape(-1), np.tile(zs, nx)], axis=-1
        ).astype(np.float32)
        faces = []
        for i in range(nx - 1):
            for k in range(nz - 1):
                faces.append((i * nz + k, (i + 1) * nz + k, i * nz + k + 1))
                faces.append(((i + 1) * nz + k, (i + 1) * nz + k + 1, i * nz + k + 1))
        return self.trimesh(body, verts, faces, **kw)

    def voxels(self, body, occupancy, voxel_size=1.0, origin=(0.0, 0.0, 0.0), **kw):
        """One cube collider per surface voxel of a boolean ``[nx, ny, nz]``
        occupancy grid whose corner is ``origin`` in the body frame. Returns
        the collider indices."""
        occ = np.asarray(occupancy, bool)
        if occ.ndim != 3:
            raise ValueError("occupancy must be [nx, ny, nz] booleans")
        h = voxel_size / 2.0
        filled = np.pad(occ, 1, constant_values=False)
        interior = (
            filled[:-2, 1:-1, 1:-1] & filled[2:, 1:-1, 1:-1]
            & filled[1:-1, :-2, 1:-1] & filled[1:-1, 2:, 1:-1]
            & filled[1:-1, 1:-1, :-2] & filled[1:-1, 1:-1, 2:]
        )
        org = np.asarray(origin, np.float32)
        lp0 = np.asarray(kw.pop("local_pos", (0.0, 0.0, 0.0)), np.float32)
        out = []
        for ix, iy, iz in zip(*np.nonzero(occ & ~interior)):
            c = org + (np.asarray([ix, iy, iz], np.float32) + 0.5) * voxel_size
            out.append(self.box(body, h, h, h, local_pos=tuple(lp0 + c), **kw))
        return out

    def convex_hull(self, body, points, **kw):
        """Convex hull of a point cloud (scipy's qhull), at most
        ``MAX_HULL_VERTS`` vertices (farthest-point simplification beyond
        that), stored about the vertices' centroid, which becomes the
        collider's local offset. Mass properties are the hull's exact ones."""
        from scipy.spatial import ConvexHull

        pts = np.asarray(points, np.float32).reshape(-1, 3)
        if pts.shape[0] < 4:
            raise ValueError("convex_hull needs >= 4 non-coplanar points")
        hull = ConvexHull(pts)
        verts = pts[hull.vertices]
        if verts.shape[0] > MAX_HULL_VERTS:
            keep = [int(np.argmax(np.linalg.norm(verts - verts.mean(0), axis=1)))]
            d = np.linalg.norm(verts - verts[keep[0]], axis=1)
            for _ in range(MAX_HULL_VERTS - 1):
                nxt = int(np.argmax(d))
                keep.append(nxt)
                d = np.minimum(d, np.linalg.norm(verts - verts[nxt], axis=1))
            verts = verts[np.asarray(keep)]
        centroid = verts.mean(axis=0)
        verts = verts - centroid
        lp = np.asarray(kw.pop("local_pos", (0.0, 0.0, 0.0)), np.float32)
        offset = self._pool_append(verts)
        h = np.abs(verts).max(axis=0)
        return self.add_collider(
            body, ShapeType.CONVEX,
            (float(offset), float(verts.shape[0]), float(h[0]), float(h[1]), float(h[2])),
            local_pos=tuple(lp + centroid), _hull_cache=(pts - centroid, hull), **kw,
        )

    def convex_decomposition(self, body, vertices, faces, **kw):
        raise NotImplementedError(
            "convex_decomposition is not ported yet: it needs the reference's host C++ "
            "decomposer (avian_tpu/native)"
        )

    def custom_collider(self, body, shape=None, params=(), mass=None, inertia=None,
                        com=(0.0, 0.0, 0.0), index=None, **kw):
        """Attach a user-shape collider (``avian_tpu_torch.api.CustomShape``).

        Pass the ``CustomShape`` as ``shape`` (registered by identity;
        ``finalize`` stores the tuple on ``World.custom_shapes``), or a raw
        ``index`` into a ``custom_shapes=`` tuple given to ``physics_step``.
        The stored code is ``CUSTOM_SHAPE_BASE + index``. ``mass`` and
        ``inertia`` (diag-3 or sym-6 about the shape's COM) are required: the
        engine cannot derive them from a support function."""
        if (shape is None) == (index is None):
            raise ValueError("pass exactly one of shape= (a CustomShape) or index=")
        if shape is not None:
            for i, known in enumerate(self._custom_shapes):
                if known is shape:
                    index = i
                    break
            else:
                self._custom_shapes.append(shape)
                index = len(self._custom_shapes) - 1
        if mass is None or inertia is None:
            raise ValueError("custom_collider requires explicit mass= and inertia= "
                             "(the engine cannot integrate a support function)")
        i = np.asarray(inertia, np.float32).reshape(-1)
        if i.shape[0] == 3:
            i6 = np.concatenate([i, np.zeros(3, np.float32)])
        elif i.shape[0] == 6:
            i6 = i
        else:
            raise ValueError("inertia must be diag-3 or sym-6")
        kw["_mass_cache"] = (np.float32(mass), i6, np.asarray(com, np.float32))
        return self.add_collider(body, CUSTOM_SHAPE_BASE + int(index), params, **kw)

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
            # Hulls: exact tetrahedron-decomposition properties; round
            # cuboids: their precomputed ones.
            for ci, cd in enumerate(self._colliders):
                if cd["hull_cache"] is not None:
                    pts_h, hull_h = cd["hull_cache"]
                    cm[ci], ci6[ci], ccom[ci] = _hull_mass_props_np(pts_h, hull_h, cd["density"])
                if cd["mass_cache"] is not None:
                    cm[ci], ci6[ci], ccom[ci] = cd["mass_cache"]
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

        if self._convex_verts:
            # 32 zero rows after the last block: a hull's fixed 32-row window
            # stays inside the pool (reference finalize).
            pool = np.concatenate(
                self._convex_verts + [np.zeros((MAX_HULL_VERTS, 3), np.float32)], axis=0
            )
        else:
            pool = np.zeros((1, 3), np.float32)

        world = world.replace(
            bodies=bodies,
            colliders=colliders,
            joints=joints,
            gravity=torch.tensor(self.gravity, dtype=torch.float32),
            convex_verts=t(pool),
            shape_pairs=self.shape_pairs(),
            custom_shapes=tuple(self._custom_shapes),
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
