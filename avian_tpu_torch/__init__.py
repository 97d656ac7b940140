"""avian_tpu_torch: the PyTorch + CUDA port of ``avian_tpu`` for one NVIDIA H100.

The module layout mirrors ``avian_tpu/``. The world is frozen dataclasses of
tensors on an explicit device; ``physics_step(world, config)`` advances it.
The ported paths step worlds of spheres, capsules, boxes, cylinders and
cones on half-spaces, with joints of all five types. Fifteen hand-written
Hopper kernels carry the hot path (see ``avian_tpu_torch.kernels``); on CPU
tensors their plain PyTorch twins run.
"""

from avian_tpu_torch.core.config import NarrowPhaseConfig, PhysicsConfig, SolverConfig
from avian_tpu_torch.core.types import BodyType, CoefficientCombine, JointType, ShapeType
from avian_tpu_torch.core.state import Bodies, Colliders, Contacts, Joints, World
from avian_tpu_torch.core.builder import SceneBuilder
from avian_tpu_torch.pipeline.step import physics_step, rollout
from avian_tpu_torch import kernels, scenes

__all__ = [
    "PhysicsConfig", "SolverConfig", "NarrowPhaseConfig",
    "BodyType", "ShapeType", "CoefficientCombine", "JointType",
    "Bodies", "Colliders", "Contacts", "Joints", "World",
    "SceneBuilder", "physics_step", "rollout", "kernels", "scenes",
]
