"""2D world state: fixed-capacity SoA tensors with scalar rotations.

Port of ``avian_tpu/dim2/state.py``. Bodies keep a position f32[N, 2] and an
angle f32[N] in radians; every collider is a rounded convex polygon of at
most ``MAX_POLY_VERTS`` local vertices plus a radius (a half-space sets
``is_plane`` and keeps its outward normal in ``poly_verts[0]``). Every column
keeps the reference's name, shape and dtype, with the two exceptions of the
3D state (``core/state.py``): the u32 layer masks are int32 bit patterns, and
``Contacts2D.pair_key`` is int64.

``World2D.from_numpy`` / ``World2D.to_numpy`` convert from and to a tree of
numpy arrays with the reference's dtypes, so the two packages can be held
leaf by leaf.
"""

from dataclasses import dataclass, replace

import numpy as np
import torch

from avian_tpu_torch.core.device import resolve
from avian_tpu_torch.core.state import _b, _Columns, _f, _i

_INF = float("inf")

MAX_POLY_VERTS = 8
MAX_POINTS_2D = 2  # manifold points per pair

# Locked-axes bits (the 2D subset of ``core.types.LOCK_*``).
LOCK_TX = 1
LOCK_TY = 2
LOCK_ROT = 4


@dataclass(frozen=True)
class Bodies2D(_Columns):
    """Rigid-body columns; see ``avian_tpu/dim2/state.py::Bodies2D``."""

    pos: torch.Tensor            # f32[N, 2]
    angle: torch.Tensor          # f32[N]
    lin_vel: torch.Tensor        # f32[N, 2]
    ang_vel: torch.Tensor        # f32[N]
    inv_mass: torch.Tensor       # f32[N]
    inv_inertia: torch.Tensor    # f32[N]
    com: torch.Tensor            # f32[N, 2] local centre of mass
    gravity_scale: torch.Tensor
    lin_damping: torch.Tensor
    ang_damping: torch.Tensor
    max_lin_speed: torch.Tensor
    max_ang_speed: torch.Tensor
    dominance: torch.Tensor      # i32[N]
    body_type: torch.Tensor      # i32[N]
    active: torch.Tensor         # bool[N]
    locked_axes: torch.Tensor    # i32[N] LOCK_TX/TY/ROT bits
    force: torch.Tensor          # f32[N, 2]
    torque: torch.Tensor         # f32[N]
    const_force: torch.Tensor    # f32[N, 2]
    const_torque: torch.Tensor   # f32[N]
    sleeping: torch.Tensor       # bool[N]
    sleep_timer: torch.Tensor    # f32[N]
    sleep_disabled: torch.Tensor  # bool[N]
    island: torch.Tensor         # i32[N]
    swept_ccd: torch.Tensor      # bool[N]
    swept_ccd_nonlinear: torch.Tensor  # bool[N]

    @property
    def capacity(self) -> int:
        return self.pos.shape[-2]

    @staticmethod
    def zeros(n: int, device=None) -> "Bodies2D":
        device = resolve(device)
        return Bodies2D(
            pos=_f((n, 2), 0.0, device), angle=_f((n,), 0.0, device),
            lin_vel=_f((n, 2), 0.0, device), ang_vel=_f((n,), 0.0, device),
            inv_mass=_f((n,), 0.0, device), inv_inertia=_f((n,), 0.0, device),
            com=_f((n, 2), 0.0, device), gravity_scale=_f((n,), 1.0, device),
            lin_damping=_f((n,), 0.0, device), ang_damping=_f((n,), 0.0, device),
            max_lin_speed=_f((n,), _INF, device), max_ang_speed=_f((n,), _INF, device),
            dominance=_i((n,), 0, device), body_type=_i((n,), 0, device),
            active=_b((n,), device), locked_axes=_i((n,), 0, device),
            force=_f((n, 2), 0.0, device), torque=_f((n,), 0.0, device),
            const_force=_f((n, 2), 0.0, device), const_torque=_f((n,), 0.0, device),
            sleeping=_b((n,), device), sleep_timer=_f((n,), 0.0, device),
            sleep_disabled=_b((n,), device), island=_i((n,), 0, device),
            swept_ccd=_b((n,), device), swept_ccd_nonlinear=_b((n,), device),
        )


@dataclass(frozen=True)
class Colliders2D(_Columns):
    """Collider columns; see ``avian_tpu/dim2/state.py::Colliders2D``."""

    poly_verts: torch.Tensor     # f32[M, V, 2] local vertices (plane: [0] = normal)
    vert_count: torch.Tensor     # i32[M]
    radius: torch.Tensor         # f32[M]
    is_plane: torch.Tensor       # bool[M]
    shape_tag: torch.Tensor      # i32[M]
    body_idx: torch.Tensor       # i32[M]
    local_pos: torch.Tensor      # f32[M, 2]
    local_angle: torch.Tensor    # f32[M]
    friction: torch.Tensor
    static_friction: torch.Tensor
    restitution: torch.Tensor
    friction_combine: torch.Tensor
    restitution_combine: torch.Tensor
    density: torch.Tensor
    layer_members: torch.Tensor  # int32 bit pattern of the u32 mask
    layer_filter: torch.Tensor   # int32 bit pattern of the u32 mask
    is_sensor: torch.Tensor
    active: torch.Tensor
    collision_margin: torch.Tensor
    speculative_margin: torch.Tensor
    aabb_min: torch.Tensor       # f32[M, 2]
    aabb_max: torch.Tensor       # f32[M, 2]

    @property
    def capacity(self) -> int:
        return self.vert_count.shape[-1]

    @staticmethod
    def zeros(m: int, device=None) -> "Colliders2D":
        device = resolve(device)
        return Colliders2D(
            poly_verts=_f((m, MAX_POLY_VERTS, 2), 0.0, device),
            vert_count=_i((m,), 1, device), radius=_f((m,), 0.0, device),
            is_plane=_b((m,), device), shape_tag=_i((m,), 0, device),
            body_idx=_i((m,), 0, device), local_pos=_f((m, 2), 0.0, device),
            local_angle=_f((m,), 0.0, device), friction=_f((m,), 0.5, device),
            static_friction=_f((m,), 0.5, device), restitution=_f((m,), 0.0, device),
            friction_combine=_i((m,), 0, device), restitution_combine=_i((m,), 0, device),
            density=_f((m,), 1.0, device), layer_members=_i((m,), -1, device),
            layer_filter=_i((m,), -1, device), is_sensor=_b((m,), device),
            active=_b((m,), device), collision_margin=_f((m,), 0.0, device),
            speculative_margin=_f((m,), _INF, device),
            aabb_min=_f((m, 2), 0.0, device), aabb_max=_f((m, 2), 0.0, device),
        )


@dataclass(frozen=True)
class Contacts2D(_Columns):
    """Persistent 2D contact buffer, at most 2 points a pair; see
    ``avian_tpu/dim2/state.py::Contacts2D``."""

    pair_key: torch.Tensor       # i64[C] lo * M + hi; -1 empty
    collider_a: torch.Tensor
    collider_b: torch.Tensor
    body_a: torch.Tensor
    body_b: torch.Tensor
    active: torch.Tensor
    touching: torch.Tensor
    was_touching: torch.Tensor
    is_sensor: torch.Tensor
    normal: torch.Tensor         # f32[C, 2] world, a -> b
    num_points: torch.Tensor
    anchor_a: torch.Tensor       # f32[C, P, 2] world offsets from COM a
    anchor_b: torch.Tensor
    penetration: torch.Tensor    # f32[C, P]
    feature_id: torch.Tensor     # i32[C, P]
    normal_impulse: torch.Tensor
    tangent_impulse: torch.Tensor  # f32[C, P] scalar in 2D
    max_normal_impulse: torch.Tensor
    friction: torch.Tensor
    static_friction: torch.Tensor
    restitution: torch.Tensor
    surface_speed: torch.Tensor  # f32[C]
    color: torch.Tensor
    contact_id: torch.Tensor
    next_contact_id: torch.Tensor  # i32[]
    evicted: torch.Tensor
    evicted_contact_id: torch.Tensor
    evicted_body_a: torch.Tensor
    evicted_body_b: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.pair_key.shape[-1]

    @classmethod
    def from_numpy(cls, tree, device=None, n_colliders=None):
        out = super().from_numpy(tree, device)
        lo = torch.minimum(out.collider_a, out.collider_b).long()
        hi = torch.maximum(out.collider_a, out.collider_b).long()
        return out.replace(pair_key=torch.where(out.active, lo * n_colliders + hi, -1))

    def to_numpy(self) -> dict:
        out = super().to_numpy()
        out["pair_key"] = out["pair_key"].astype(np.int32)
        return out

    @staticmethod
    def zeros(c: int, device=None) -> "Contacts2D":
        device = resolve(device)
        p = MAX_POINTS_2D

        def f(shape):
            return _f(shape, 0.0, device)

        def i(shape, value=0):
            return _i(shape, value, device)

        return Contacts2D(
            pair_key=_i((c,), -1, device, torch.int64), collider_a=i((c,)),
            collider_b=i((c,)), body_a=i((c,)), body_b=i((c,)), active=_b((c,), device),
            touching=_b((c,), device), was_touching=_b((c,), device),
            is_sensor=_b((c,), device), normal=f((c, 2)), num_points=i((c,)),
            anchor_a=f((c, p, 2)), anchor_b=f((c, p, 2)), penetration=f((c, p)),
            feature_id=i((c, p)), normal_impulse=f((c, p)), tangent_impulse=f((c, p)),
            max_normal_impulse=f((c, p)), friction=f((c,)), static_friction=f((c,)),
            restitution=f((c,)), surface_speed=f((c,)), color=i((c,), -1),
            contact_id=i((c,)), next_contact_id=i((), 1), evicted=_b((c,), device),
            evicted_contact_id=i((c,)), evicted_body_a=i((c,)), evicted_body_b=i((c,)),
        )


@dataclass(frozen=True)
class Joints2D(_Columns):
    """2D joint columns; see ``avian_tpu/dim2/state.py::Joints2D``. The 2D
    step solves them with Kernel AA (``dim2/xpbd.py``) and writes back
    ``total_lambda`` and ``color``."""

    jtype: torch.Tensor
    body_a: torch.Tensor
    body_b: torch.Tensor
    active: torch.Tensor
    anchor_a: torch.Tensor       # f32[J, 2]
    anchor_b: torch.Tensor
    axis_angle: torch.Tensor
    reference_angle: torch.Tensor
    compliance: torch.Tensor     # f32[J, 4]
    limit_min: torch.Tensor
    limit_max: torch.Tensor
    limit_enabled: torch.Tensor
    lin_damping: torch.Tensor
    ang_damping: torch.Tensor
    collision_disabled: torch.Tensor
    total_lambda: torch.Tensor   # f32[J, 3]
    color: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.jtype.shape[-1]

    @staticmethod
    def zeros(j: int, device=None) -> "Joints2D":
        device = resolve(device)
        return Joints2D(
            jtype=_i((j,), 0, device), body_a=_i((j,), 0, device),
            body_b=_i((j,), 0, device), active=_b((j,), device),
            anchor_a=_f((j, 2), 0.0, device), anchor_b=_f((j, 2), 0.0, device),
            axis_angle=_f((j,), 0.0, device), reference_angle=_f((j,), 0.0, device),
            compliance=_f((j, 4), 0.0, device), limit_min=_f((j,), 0.0, device),
            limit_max=_f((j,), 0.0, device), limit_enabled=_b((j,), device),
            lin_damping=_f((j,), 0.0, device), ang_damping=_f((j,), 0.0, device),
            collision_disabled=_b((j,), device), total_lambda=_f((j, 3), 0.0, device),
            color=_i((j,), -1, device),
        )


_WORLD_LEAVES = ("gravity", "time", "diverged")


@dataclass(frozen=True)
class World2D:
    """Everything dynamic of a 2D world."""

    bodies: Bodies2D
    colliders: Colliders2D
    contacts: Contacts2D
    joints: Joints2D
    gravity: torch.Tensor   # f32[2]
    time: torch.Tensor      # f32[]
    diverged: torch.Tensor  # bool[]

    def replace(self, **kw):
        return replace(self, **kw)

    @property
    def device(self) -> torch.device:
        return self.bodies.pos.device

    @staticmethod
    def zeros(n_bodies, n_colliders=None, n_contacts=None, n_joints=8,
              device=None) -> "World2D":
        device = resolve(device)
        m = n_colliders if n_colliders is not None else n_bodies
        c = n_contacts if n_contacts is not None else 8 * m
        return World2D(
            bodies=Bodies2D.zeros(n_bodies, device),
            colliders=Colliders2D.zeros(m, device),
            contacts=Contacts2D.zeros(c, device),
            joints=Joints2D.zeros(n_joints, device),
            gravity=torch.tensor([0.0, -9.81], device=device),
            time=torch.zeros((), dtype=torch.float32, device=device),
            diverged=torch.zeros((), dtype=torch.bool, device=device),
        )

    @staticmethod
    def from_numpy(tree, device=None) -> "World2D":
        """Build from any object with the reference World2D's attributes whose
        leaves are numpy arrays (e.g. ``jax.tree.map(np.asarray, world)``)."""
        device = resolve(device)
        m = np.asarray(tree.colliders.vert_count).shape[-1]
        return World2D(
            bodies=Bodies2D.from_numpy(tree.bodies, device),
            colliders=Colliders2D.from_numpy(tree.colliders, device),
            contacts=Contacts2D.from_numpy(tree.contacts, device, n_colliders=m),
            joints=Joints2D.from_numpy(tree.joints, device),
            **{k: torch.from_numpy(np.array(getattr(tree, k))).to(device)
               for k in _WORLD_LEAVES},
        )

    def to_numpy(self) -> dict:
        """Nested dict of numpy arrays with the reference's dtypes."""
        out = {g: getattr(self, g).to_numpy()
               for g in ("bodies", "colliders", "contacts", "joints")}
        for k in _WORLD_LEAVES:
            out[k] = getattr(self, k).detach().cpu().numpy()
        return out
