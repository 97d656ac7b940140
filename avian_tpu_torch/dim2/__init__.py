"""The port's native 2D engine (port of ``avian_tpu/dim2``).

Bodies carry a position f32[N, 2] and a scalar angle; every collider is a
rounded convex polygon of at most 8 vertices (circle, rectangle,
round_rectangle, capsule, segment, triangle, regular polygon, convex hull,
the ellipse's inscribed 8-gon) or a half-space. The step runs six
hand-written Hopper kernels of its own (U grid pairs, V manifolds, W contact
rows, X packed rows, Y the solver's colours, Z integration) beside the 3D
port's colouring (G), key join (F) and island labels (J); on CPU tensors
their plain PyTorch twins run. Entry points build on the card unless
``device="cpu"`` is passed. The step refuses active joints, swept CCD,
hooks and custom joints (``NotImplementedError``); 2D queries are not
ported yet.
"""

from avian_tpu_torch.dim2 import scenes
from avian_tpu_torch.dim2.builder import SceneBuilder2D
from avian_tpu_torch.dim2.state import Bodies2D, Colliders2D, Contacts2D, Joints2D, World2D
from avian_tpu_torch.dim2.step import physics_step_2d, rollout_2d

__all__ = [
    "SceneBuilder2D", "Bodies2D", "Colliders2D", "Contacts2D", "Joints2D", "World2D",
    "physics_step_2d", "rollout_2d", "scenes",
]
