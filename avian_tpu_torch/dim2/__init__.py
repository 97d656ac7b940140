"""The port's native 2D engine (port of ``avian_tpu/dim2``).

Bodies carry a position f32[N, 2] and a scalar angle; every collider is a
rounded convex polygon of at most 8 vertices (circle, rectangle,
round_rectangle, capsule, segment, triangle, regular polygon, convex hull,
the ellipse's inscribed 8-gon) or a half-space. The step runs eight
hand-written Hopper kernels of its own (U grid pairs, V manifolds, W contact
rows, X packed rows, Y the solver's colours, Z integration, AA the XPBD
joints, AB the swept CCD's times of impact) beside the 3D port's colouring
(G), key join (F) and island labels (J); on CPU tensors their plain PyTorch
twins run. Entry points build on the card unless ``device="cpu"`` is
passed. It steps every world the reference's 2D step steps: joints of the
four 2D types, ``config.swept_ccd``, collision ``hooks`` and
``custom_joints`` (``dim2.custom``); ``dim2.forces`` is the forces API.
``dim2.queries`` casts rays (Kernel AC), projects points (AD) and casts
shapes (AE) into a 2D world, with intersections, filters and predicates;
``dim2.character`` is the kinematic move-and-slide controller on them.
"""

from avian_tpu_torch.dim2 import character, custom, forces, queries, scenes
from avian_tpu_torch.dim2.builder import SceneBuilder2D
from avian_tpu_torch.dim2.state import Bodies2D, Colliders2D, Contacts2D, Joints2D, World2D
from avian_tpu_torch.dim2.step import physics_step_2d, rollout_2d

__all__ = [
    "SceneBuilder2D", "Bodies2D", "Colliders2D", "Contacts2D", "Joints2D", "World2D",
    "physics_step_2d", "rollout_2d", "scenes", "forces", "custom", "queries", "character",
]
