"""The world state: frozen dataclasses of fixed-capacity SoA tensors.

Port of ``avian_tpu/core/state.py``. Every column keeps the reference's
name and shape, and its dtype with two exceptions:

- the u32 layer masks (``Colliders.layer_members/layer_filter``) are stored
  as int32 bit patterns and tested with ``!= 0``; torch has no arithmetic
  uint32;
- ``Contacts.pair_key`` is int64 (``lo * M + hi`` never overflows, so the
  reference's lexicographic fallback above 46,340 colliders is not needed).

``World.from_numpy`` / ``World.to_numpy`` convert from and to a tree of
numpy arrays with the reference's exact dtypes (e.g. the JAX world mapped
through ``np.asarray``), so the two packages can be held leaf by leaf.

Index 0..N-1 are valid body slots; padded/invalid references use index 0
with an inactive mask (never -1, so gathers stay in bounds).
"""

from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from avian_tpu_torch.core.device import resolve

_INF = float("inf")
MAX_POINTS = 4  # manifold points per contact pair

# Reference KEY_M_MAX: above it the JAX engine stores pair_key as a
# validity marker (0 valid, -1 empty) instead of lo * M + hi.
_REF_KEY_M_MAX = 46340
_U32_FIELDS = ("layer_members", "layer_filter")


class _Columns:
    """Shared conversions of an SoA dataclass whose fields are tensors."""

    def replace(self, **kw):
        return replace(self, **kw)

    def to(self, device):
        return replace(
            self, **{f.name: getattr(self, f.name).to(device) for f in fields(self)}
        )

    @classmethod
    def from_numpy(cls, tree, device=None):
        device = resolve(device)
        out = {}
        for f in fields(cls):
            a = np.asarray(getattr(tree, f.name))
            if a.dtype == np.uint32:
                a = a.view(np.int32)
            out[f.name] = torch.from_numpy(np.array(a)).to(device)
        return cls(**out)

    def to_numpy(self) -> dict:
        out = {}
        for f in fields(self):
            a = getattr(self, f.name).detach().cpu().numpy()
            if f.name in _U32_FIELDS:
                a = a.view(np.uint32)
            out[f.name] = a
        return out


def _f(shape, value, device):
    return torch.full(shape, value, dtype=torch.float32, device=device)


def _i(shape, value, device, dtype=torch.int32):
    return torch.full(shape, value, dtype=dtype, device=device)


def _b(shape, device):
    return torch.zeros(shape, dtype=torch.bool, device=device)


def _quat_id(n, device):
    q = torch.zeros((n, 4), dtype=torch.float32, device=device)
    q[:, 3] = 1.0
    return q


@dataclass(frozen=True)
class Bodies(_Columns):
    """Rigid-body SoA columns; see ``avian_tpu/core/state.py::Bodies``."""

    pos: torch.Tensor
    quat: torch.Tensor
    lin_vel: torch.Tensor
    ang_vel: torch.Tensor
    inv_mass: torch.Tensor
    inv_inertia: torch.Tensor
    com: torch.Tensor
    gravity_scale: torch.Tensor
    lin_damping: torch.Tensor
    ang_damping: torch.Tensor
    max_lin_speed: torch.Tensor
    max_ang_speed: torch.Tensor
    dominance: torch.Tensor
    body_type: torch.Tensor
    active: torch.Tensor
    locked_axes: torch.Tensor
    gyroscopic: torch.Tensor
    swept_ccd: torch.Tensor
    swept_ccd_nonlinear: torch.Tensor
    force: torch.Tensor
    torque: torch.Tensor
    const_force: torch.Tensor
    const_torque: torch.Tensor
    const_lin_acc: torch.Tensor
    const_ang_acc: torch.Tensor
    const_local_force: torch.Tensor
    const_local_torque: torch.Tensor
    const_local_lin_acc: torch.Tensor
    const_local_ang_acc: torch.Tensor
    sleeping: torch.Tensor
    sleep_timer: torch.Tensor
    sleep_disabled: torch.Tensor
    island: torch.Tensor
    sleep_pos: torch.Tensor
    sleep_quat: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.pos.shape[-2]

    @staticmethod
    def zeros(n: int, device=None) -> "Bodies":
        device = resolve(device)

        def f3():
            return _f((n, 3), 0.0, device)

        return Bodies(
            pos=f3(), quat=_quat_id(n, device), lin_vel=f3(), ang_vel=f3(),
            inv_mass=_f((n,), 0.0, device),
            inv_inertia=_f((n, 6), 0.0, device),
            com=f3(),
            gravity_scale=_f((n,), 1.0, device),
            lin_damping=_f((n,), 0.0, device),
            ang_damping=_f((n,), 0.0, device),
            max_lin_speed=_f((n,), _INF, device),
            max_ang_speed=_f((n,), _INF, device),
            dominance=_i((n,), 0, device),
            body_type=_i((n,), 0, device),
            active=_b((n,), device),
            locked_axes=_i((n,), 0, device),
            gyroscopic=_b((n,), device),
            swept_ccd=_b((n,), device),
            swept_ccd_nonlinear=_b((n,), device),
            force=f3(), torque=f3(), const_force=f3(), const_torque=f3(),
            const_lin_acc=f3(), const_ang_acc=f3(), const_local_force=f3(),
            const_local_torque=f3(), const_local_lin_acc=f3(),
            const_local_ang_acc=f3(),
            sleeping=_b((n,), device),
            sleep_timer=_f((n,), 0.0, device),
            sleep_disabled=_b((n,), device),
            island=_i((n,), 0, device),
            sleep_pos=f3(),
            sleep_quat=_quat_id(n, device),
        )


@dataclass(frozen=True)
class Colliders(_Columns):
    """Collider SoA columns; see ``avian_tpu/core/state.py::Colliders``."""

    shape_type: torch.Tensor
    params: torch.Tensor
    body_idx: torch.Tensor
    local_pos: torch.Tensor
    local_quat: torch.Tensor
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
    aabb_min: torch.Tensor
    aabb_max: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.shape_type.shape[-1]

    @staticmethod
    def zeros(m: int, device=None) -> "Colliders":
        device = resolve(device)
        return Colliders(
            shape_type=_i((m,), 0, device),
            params=_f((m, 8), 0.0, device),
            body_idx=_i((m,), 0, device),
            local_pos=_f((m, 3), 0.0, device),
            local_quat=_quat_id(m, device),
            friction=_f((m,), 0.5, device),
            static_friction=_f((m,), 0.5, device),
            restitution=_f((m,), 0.0, device),
            friction_combine=_i((m,), 0, device),
            restitution_combine=_i((m,), 0, device),
            density=_f((m,), 1.0, device),
            layer_members=_i((m,), -1, device),
            layer_filter=_i((m,), -1, device),
            is_sensor=_b((m,), device),
            active=_b((m,), device),
            collision_margin=_f((m,), 0.0, device),
            speculative_margin=_f((m,), _INF, device),
            aabb_min=_f((m, 3), 0.0, device),
            aabb_max=_f((m, 3), 0.0, device),
        )


@dataclass(frozen=True)
class Contacts(_Columns):
    """Persistent contact-pair buffer; see
    ``avian_tpu/core/state.py::Contacts``."""

    pair_key: torch.Tensor  # int64 lo * M + hi; -1 empty
    collider_a: torch.Tensor
    collider_b: torch.Tensor
    body_a: torch.Tensor
    body_b: torch.Tensor
    active: torch.Tensor
    touching: torch.Tensor
    was_touching: torch.Tensor
    is_sensor: torch.Tensor
    normal: torch.Tensor
    num_points: torch.Tensor
    anchor_a: torch.Tensor
    anchor_b: torch.Tensor
    penetration: torch.Tensor
    feature_id: torch.Tensor
    normal_impulse: torch.Tensor
    tangent_impulse: torch.Tensor
    max_normal_impulse: torch.Tensor
    friction: torch.Tensor
    static_friction: torch.Tensor
    restitution: torch.Tensor
    surface_velocity: torch.Tensor
    color: torch.Tensor
    contact_id: torch.Tensor
    next_contact_id: torch.Tensor
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
        # Rebuild the int64 keys from the pair itself: the reference's i32
        # key is only a validity marker above its KEY_M_MAX.
        lo = torch.minimum(out.collider_a, out.collider_b).long()
        hi = torch.maximum(out.collider_a, out.collider_b).long()
        key = torch.where(out.active, lo * n_colliders + hi, -1)
        return out.replace(pair_key=key)

    def to_numpy(self, n_colliders=None) -> dict:
        out = super().to_numpy()
        key = out["pair_key"]
        if n_colliders is not None and n_colliders > _REF_KEY_M_MAX:
            key = np.where(key >= 0, 0, -1)
        out["pair_key"] = key.astype(np.int32)
        return out

    @staticmethod
    def zeros(c: int, device=None) -> "Contacts":
        device = resolve(device)
        p = MAX_POINTS
        return Contacts(
            pair_key=_i((c,), -1, device, torch.int64),
            collider_a=_i((c,), 0, device),
            collider_b=_i((c,), 0, device),
            body_a=_i((c,), 0, device),
            body_b=_i((c,), 0, device),
            active=_b((c,), device),
            touching=_b((c,), device),
            was_touching=_b((c,), device),
            is_sensor=_b((c,), device),
            normal=_f((c, 3), 0.0, device),
            num_points=_i((c,), 0, device),
            anchor_a=_f((c, p, 3), 0.0, device),
            anchor_b=_f((c, p, 3), 0.0, device),
            penetration=_f((c, p), 0.0, device),
            feature_id=_i((c, p), 0, device),
            normal_impulse=_f((c, p), 0.0, device),
            tangent_impulse=_f((c, p, 2), 0.0, device),
            max_normal_impulse=_f((c, p), 0.0, device),
            friction=_f((c,), 0.0, device),
            static_friction=_f((c,), 0.0, device),
            restitution=_f((c,), 0.0, device),
            surface_velocity=_f((c, 3), 0.0, device),
            color=_i((c,), -1, device),
            contact_id=_i((c,), 0, device),
            next_contact_id=_i((), 1, device),
            evicted=_b((c,), device),
            evicted_contact_id=_i((c,), 0, device),
            evicted_body_a=_i((c,), 0, device),
            evicted_body_b=_i((c,), 0, device),
        )


@dataclass(frozen=True)
class Joints(_Columns):
    """Joint SoA columns; see ``avian_tpu/core/state.py::Joints``. The
    step solves all five joint types (``pipeline/xpbd.py``)."""

    jtype: torch.Tensor
    body_a: torch.Tensor
    body_b: torch.Tensor
    active: torch.Tensor
    frame_pos_a: torch.Tensor
    frame_pos_b: torch.Tensor
    frame_quat_a: torch.Tensor
    frame_quat_b: torch.Tensor
    compliance: torch.Tensor
    limit_min: torch.Tensor
    limit_max: torch.Tensor
    limit_enabled: torch.Tensor
    twist_min: torch.Tensor
    twist_max: torch.Tensor
    twist_enabled: torch.Tensor
    lin_damping: torch.Tensor
    ang_damping: torch.Tensor
    collision_disabled: torch.Tensor
    total_lambda: torch.Tensor
    color: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.jtype.shape[-1]

    @staticmethod
    def zeros(j: int, device=None) -> "Joints":
        device = resolve(device)
        return Joints(
            jtype=_i((j,), 0, device),
            body_a=_i((j,), 0, device),
            body_b=_i((j,), 0, device),
            active=_b((j,), device),
            frame_pos_a=_f((j, 3), 0.0, device),
            frame_pos_b=_f((j, 3), 0.0, device),
            frame_quat_a=_quat_id(j, device),
            frame_quat_b=_quat_id(j, device),
            compliance=_f((j, 4), 0.0, device),
            limit_min=_f((j,), 0.0, device),
            limit_max=_f((j,), 0.0, device),
            limit_enabled=_b((j,), device),
            twist_min=_f((j,), 0.0, device),
            twist_max=_f((j,), 0.0, device),
            twist_enabled=_b((j,), device),
            lin_damping=_f((j,), 0.0, device),
            ang_damping=_f((j,), 0.0, device),
            collision_disabled=_b((j,), device),
            total_lambda=_f((j, 6), 0.0, device),
            color=_i((j,), -1, device),
        )


_WORLD_LEAVES = ("gravity", "time", "diverged", "convex_verts")


@dataclass(frozen=True)
class World:
    """Everything dynamic. ``shape_pairs`` is static metadata: the canonical
    (type_a <= type_b) shape pairs the scene can produce."""

    bodies: Bodies
    colliders: Colliders
    contacts: Contacts
    joints: Joints
    gravity: torch.Tensor       # f32[3]
    time: torch.Tensor          # f32[]
    diverged: torch.Tensor      # bool[]
    convex_verts: torch.Tensor  # f32[V, 3] (unused by the port's shapes)
    shape_pairs: tuple | None = None
    # The user shapes (api/custom_shapes.py) of codes CUSTOM_SHAPE_BASE + i.
    custom_shapes: tuple = ()

    def replace(self, **kw):
        return replace(self, **kw)

    @property
    def device(self) -> torch.device:
        return self.bodies.pos.device

    def to(self, device) -> "World":
        return self.replace(
            bodies=self.bodies.to(device),
            colliders=self.colliders.to(device),
            contacts=self.contacts.to(device),
            joints=self.joints.to(device),
            **{k: getattr(self, k).to(device) for k in _WORLD_LEAVES},
        )

    @staticmethod
    def zeros(n_bodies, n_colliders=None, n_contacts=None, n_joints=8,
              device=None) -> "World":
        device = resolve(device)
        m = n_colliders if n_colliders is not None else n_bodies
        c = n_contacts if n_contacts is not None else 8 * m
        return World(
            bodies=Bodies.zeros(n_bodies, device),
            colliders=Colliders.zeros(m, device),
            contacts=Contacts.zeros(c, device),
            joints=Joints.zeros(n_joints, device),
            gravity=torch.tensor([0.0, -9.81, 0.0], device=device),
            time=torch.zeros((), dtype=torch.float32, device=device),
            diverged=torch.zeros((), dtype=torch.bool, device=device),
            convex_verts=torch.zeros((1, 3), dtype=torch.float32, device=device),
        )

    @staticmethod
    def from_numpy(tree, device=None, custom_shapes=()) -> "World":
        """Build from any object with the reference World's attributes whose
        leaves are numpy arrays (e.g. ``jax.tree.map(np.asarray, world)``).
        A tree that carries custom shapes needs the port's own
        ``CustomShape`` of each, in its order, as ``custom_shapes``."""
        theirs = tuple(getattr(tree, "custom_shapes", ()) or ())
        if len(theirs) != len(custom_shapes):
            raise ValueError(
                f"the world carries {len(theirs)} custom shapes and {len(custom_shapes)} were "
                "given: pass the port's CustomShape of each as custom_shapes=")
        device = resolve(device)
        m = np.asarray(tree.colliders.shape_type).shape[-1]
        leaves = {
            k: torch.from_numpy(np.array(getattr(tree, k))).to(device)
            for k in _WORLD_LEAVES
        }
        pairs = getattr(tree, "shape_pairs", None)
        return World(
            bodies=Bodies.from_numpy(tree.bodies, device),
            colliders=Colliders.from_numpy(tree.colliders, device),
            contacts=Contacts.from_numpy(tree.contacts, device, n_colliders=m),
            joints=Joints.from_numpy(tree.joints, device),
            shape_pairs=(
                None if pairs is None
                else tuple((int(a), int(b)) for a, b in pairs)
            ),
            custom_shapes=tuple(custom_shapes),
            **leaves,
        )

    def to_numpy(self) -> dict:
        """Nested dict of numpy arrays with the reference's dtypes."""
        out = {
            "bodies": self.bodies.to_numpy(),
            "colliders": self.colliders.to_numpy(),
            "contacts": self.contacts.to_numpy(
                n_colliders=self.colliders.capacity
            ),
            "joints": self.joints.to_numpy(),
        }
        for k in _WORLD_LEAVES:
            out[k] = getattr(self, k).detach().cpu().numpy()
        return out
