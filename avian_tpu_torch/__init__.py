"""avian_tpu_torch: the PyTorch + CUDA port of ``avian_tpu`` for one NVIDIA H100.

The module layout mirrors ``avian_tpu/``. The world is frozen dataclasses of
tensors on an explicit device; ``physics_step(world, config)`` advances it.
The ported paths step worlds of spheres, capsules, boxes, cylinders, cones,
segments, half-spaces, pool-backed convex shapes (hulls, round cuboids,
the triangles of trimeshes and heightfields) and user shapes
(``api.CustomShape``), with joints of all five types, user constraints
(``api.custom``), collision hooks and the opt-in swept CCD; ``queries`` casts
rays and shapes into a world and
projects points and intersects shapes there; ``contact_query`` holds the
standalone pair queries and the time of impact, ``character`` the kinematic
move-and-slide controller, ``picking`` the pointer picks; ``dim2`` is the
native 2D engine (``physics_step_2d``). Thirty-six hand-written Hopper
kernels (A-Z, AA-AJ, with Kernel S's overlap and manifold modes and the
custom-shape instances of E, M, O, P and AF) carry the hot paths (see
``avian_tpu_torch.kernels``); on CPU tensors their plain PyTorch twins run.
"""

from avian_tpu_torch.core.config import NarrowPhaseConfig, PhysicsConfig, SolverConfig
from avian_tpu_torch.core.types import BodyType, CoefficientCombine, JointType, ShapeType
from avian_tpu_torch.core.state import Bodies, Colliders, Contacts, Joints, World
from avian_tpu_torch.core.builder import SceneBuilder
from avian_tpu_torch.pipeline.step import physics_step, rollout
from avian_tpu_torch import api, character, dim2, kernels, picking, queries, scenes
from avian_tpu_torch.api import CUSTOM_SHAPE_BASE, CustomShape
from avian_tpu_torch.geometry import contact_query
from avian_tpu_torch.queries import (QueryFilter, RayHit, ShapeHit, cast_ray,
                                     cast_ray_predicate, cast_shape, cast_shape_predicate,
                                     ray_hits, shape_hits)

__all__ = [
    "PhysicsConfig", "SolverConfig", "NarrowPhaseConfig",
    "BodyType", "ShapeType", "CoefficientCombine", "JointType",
    "Bodies", "Colliders", "Contacts", "Joints", "World",
    "SceneBuilder", "physics_step", "rollout", "kernels", "scenes", "queries", "dim2",
    "cast_ray", "ray_hits", "RayHit", "cast_shape", "shape_hits", "ShapeHit", "QueryFilter",
    "cast_ray_predicate", "cast_shape_predicate", "contact_query", "character", "picking",
    "api", "CustomShape", "CUSTOM_SHAPE_BASE",
]
