"""Integer enums stored in the SoA state arrays.

Counterparts of the reference's ``RigidBody`` enum
(``src/dynamics/rigid_body/mod.rs:284``), Parry shape types
(``src/collision/collider/parry/mod.rs:704-1170``) and
``CoefficientCombine`` (``src/collision/collider/physics_material.rs:13``).
"""

from enum import IntEnum


class BodyType(IntEnum):
    """Matches RigidBody::{Static, Dynamic, Kinematic}."""

    STATIC = 0
    DYNAMIC = 1
    KINEMATIC = 2


# Shape codes of user shapes (api/custom_shapes.py) start here, above every
# built-in code: code = CUSTOM_SHAPE_BASE + index into the world's tuple.
CUSTOM_SHAPE_BASE = 16


class ShapeType(IntEnum):
    """Collider shape tags. Params layout (``colliders.params[:, 4]``):

    - SPHERE:    (radius, -, -, -)
    - CAPSULE:   (half_length, radius, -, -)   axis = local Y (like Avian/Parry)
    - BOX:       (hx, hy, hz, -)               half extents
    - PLANE:     (nx, ny, nz, -)               half-space with local normal n
    - CYLINDER:  (half_height, radius, -, -)   axis = local Y
    - CONE:      (half_height, radius, -, -)   axis = local Y
    - SEGMENT:   (hx, -, -, -)                 segment on local X, half-length
    - TRIANGLE / CONVEX / TRIMESH / HEIGHTFIELD reference vertex pools (later).
    """

    SPHERE = 0
    CAPSULE = 1
    BOX = 2
    PLANE = 3
    CYLINDER = 4
    CONE = 5
    SEGMENT = 6
    TRIANGLE = 7
    CONVEX = 8
    TRIMESH = 9
    HEIGHTFIELD = 10


NUM_SHAPE_TYPES = 11


class CoefficientCombine(IntEnum):
    """How friction/restitution of two colliders combine.

    Same semantics and precedence as the reference
    (``physics_material.rs:13-46``): the rule with the higher value wins.
    """

    AVERAGE = 0
    GEOMETRIC_MEAN = 1
    MIN = 2
    MULTIPLY = 3
    MAX = 4


class JointType(IntEnum):
    """Matches the reference joint set (``src/dynamics/joints/``)."""

    FIXED = 0
    DISTANCE = 1
    REVOLUTE = 2
    PRISMATIC = 3
    SPHERICAL = 4


# LockedAxes bit layout (matches semantics of
# ``src/dynamics/rigid_body/locked_axes.rs``): low 3 bits lock translation
# x/y/z, next 3 bits lock rotation x/y/z.
LOCK_TX = 1 << 0
LOCK_TY = 1 << 1
LOCK_TZ = 1 << 2
LOCK_RX = 1 << 3
LOCK_RY = 1 << 4
LOCK_RZ = 1 << 5
LOCK_TRANSLATION = LOCK_TX | LOCK_TY | LOCK_TZ
LOCK_ROTATION = LOCK_RX | LOCK_RY | LOCK_RZ
