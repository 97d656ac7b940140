"""Smoke run of the PyTorch/CUDA port (``avian_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written kernels from ``avian_tpu_torch/csrc`` (and, beside
them, the generated unit of the extensions phase's custom shape), holds each of
the 36 kernels (A-Z, AA-AJ) and S's overlap and manifold modes against its
plain PyTorch twin at the main paths' shapes (the 10,000-cube pile after 60 steps; the
base-100 box pyramid after 2 steps, when most of its constraints sit in the
overflow colour, and after 30; the hinged boxes, ``hinge_blocks(84)``, after 30 steps; every
shape-pair bucket of 10,000 mixed shapes after 40 steps; every bucket of
10,000 mixed shapes, rocks and round cuboids on a heightfield of 8,192
triangles after 40 steps, and 4,096 random pairs of each of the 15 pairs that
segments and pool-backed convex shapes add), steps the ``stack3`` and
``falling_hinges`` golden scenes against ``tests/golden/``, drives the main
paths through ``physics_step`` (the pile with 160,000 contact slots for 180
steps; the 5,050-box pyramid for 120 steps, then 30 steps each of its free
3D variant and of 10 x 10 pyramids of base 10; the 10,080 hinged boxes with
7,560 revolute joints for 120 steps; 10,000 spheres, capsules, boxes,
cylinders and cones for 120 steps, and the cylinder stack for 240; the
10,000-body terrain with 240,000 contact slots for 120 steps, every body
held above the field's surface and inside its footprint) and checks that
every kernel carried them, runs the reference's trimesh, voxel, hull and
round-cuboid scenes with their own checks, fires 32 swept bullets into the
terrain for 120 steps (``terrain_ccd``: Kernel R against its twin, no bullet
below the field, what the sweep's repairs of the reference did), runs the
reference's swept-CCD scenes, casts five shapes and 1,024 rays into the
terrain (Kernels S and T against their twins), makes the point, intersection
and grid queries and the persistent casters a user makes on that terrain
(Kernels AF, AG, AH and S's overlap mode counted over those calls, held to
their twins, AG to T's brute force), makes the contact queries, drives the
character and picks on that terrain (``time_of_impact``, Kernel AI, and
``contact`` on 65,536 pairs of its broadphase; a capsule walked by
``move_and_slide`` for 120 frames into the pile, S and its manifold mode,
above the field and out of the colliders, one host read a frame; AI and the
manifold mode held to their twins, the first frames on a small terrain to
the plain versions; the character and picking examples; ``pick_batch`` and
``pick_2d`` held to the ray casts), drives the 3D extension points (phase
``extensions``: the terrain with every fourth body the example's ellipsoid,
60 steps, every custom bucket launched, Kernel E's custom pass, the custom
instances of M, O, P and AF and Kernel AJ held to their plain versions, 1,024
rays, their picks and 1,024 points; the custom-collider examples with their
checks; collision hooks on the 10,000-cube pile, the one-way platform and the
conveyor belt; 1,024 custom pendulums with no joint slots and the custom
constraint example), drives the batched step (phase ``batched``: 4,096
``cube_pile(27)`` scenes with seeded gravity jitter through
``parallel.make_batched_step`` for 60 steps and on until every scene sleeps, with
no drop in any scene, no host read more than a single world's step, Kernels
E, B, L and K held to their plain versions at the flat world's shapes, 16
seeded scenes stepped alone bit for bit their batched copies, and 64 scenes
on the plain versions), steps the pyramid, the hinged
boxes, 2,000 mixed shapes, a 2,000-body terrain and a 2,000-body
``terrain_ccd`` once more with every kernel replaced by its plain version
and holds the kernels' trajectories to those, and checks that two runs are
bitwise equal. The native 2D engine's phases hold Kernels U-Z to their twins
at the base-100 2D pyramid's shapes (after 2 and 30 steps, and on a bouncing
copy) and V on 4,096 random pairs of each kind, step the
``pyramid2d_native`` golden, drive ``box_pyramid_2d(100)`` for 120 steps
(its apex held to the reference's curve, ``tests/torch_cases/
pyramid2d_curve.npz``) and ``many_pyramids_2d(10, 10)`` for 30, both at 24
contact slots a box, run the 2D pyramid on the plain versions, hold Kernel
AA to its twins on ``hinge_blocks_2d(84)`` (10,080 boxes, 7,560 revolute
joints) and drive it for 120 steps with every hinge's anchors within 2 cm,
run 8 of its blocks on the plain versions, hold Kernel AB to its twin on
the whole grid of ``pyramid_ccd_2d(100, 32)`` (the pyramid and 32 swept
bullets) and drive it for 60 steps with no bullet centre below the ground
or inside a box, run the five 2D joint examples with their own checks, make
the 2D queries a user makes on ``box_pyramid_2d(100)`` (rays, points, shape
casts and intersections; Kernels AC, AD and AE counted over those calls,
then held to their twins on 1,024 rays both ways, 1,024 points and five
casts, and rerun bitwise), drive a capsule with ``move_and_slide`` for 120
frames across ``many_pyramids_2d(10, 10)``'s floor into a pyramid (never
below the floor or inside a box, rerun bitwise, and equal to the same frames
on the plain versions), run ``examples/native_2d_showcase.py``'s checks up
to its render, and rerun the 2D pyramid, hinges and bullets bitwise. Each
phase prints one line; the line before the last is a JSON object with each
kernel's launches, error, times and bound, and the last line is ``{"ok":
true, "device": {...}}``. Any failure raises, and the script exits non-zero without that
line. It takes no arguments, needs a CUDA card and imports nothing of JAX.
"""

import collections
import contextlib
import itertools
import json
import math
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from avian_tpu_torch import kernels, scenes
from avian_tpu_torch.core.builder import SceneBuilder
from avian_tpu_torch.core.config import PhysicsConfig
from avian_tpu_torch.core.types import CUSTOM_SHAPE_BASE, BodyType, ShapeType
from avian_tpu_torch.kernels import body_pass as kk
from avian_tpu_torch.kernels import box_manifold as ka
from avian_tpu_torch.kernels import build
from avian_tpu_torch.kernels import compact_pairs as kl
from avian_tpu_torch.kernels import grid_sweep as kb
from avian_tpu_torch.kernels import hull_manifold as kpq
from avian_tpu_torch.kernels import collider_aabbs as ke
from avian_tpu_torch.kernels import color_edges as kg
from avian_tpu_torch.kernels import contact_rows as kf
from avian_tpu_torch.kernels import convex_manifold as km
from avian_tpu_torch.kernels import integrate_bodies as kc
from avian_tpu_torch.kernels import islands as kj
from avian_tpu_torch.kernels import pack_constraints as kh
from avian_tpu_torch.kernels import round_manifold as kn
from avian_tpu_torch.kernels import run_rank as kr
from avian_tpu_torch.kernels import solve_color as kd
from avian_tpu_torch.kernels import solve_joints as ki
from avian_tpu_torch.kernels import shape_cast as ks
from avian_tpu_torch.kernels import ray_cast as kt
from avian_tpu_torch.kernels import swept_toi as kccd
from avian_tpu_torch.pipeline import broadphase as bp_m
from avian_tpu_torch.pipeline import ccd as ccd_m
from avian_tpu_torch.pipeline import contacts as np_m
from avian_tpu_torch.pipeline import sleeping as sleep_m
from avian_tpu_torch.pipeline import solver as sol_m
from avian_tpu_torch.pipeline import solver_body as sb_m
from avian_tpu_torch.pipeline import xpbd as xpbd_m
from avian_tpu_torch.pipeline.step import physics_step, prepare_step, run_substeps
from avian_tpu_torch.queries import (QueryFilter, cast_ray, cast_shape, ray_hits, raycast,
                                     shape_hits, shapecast)
from avian_tpu_torch.geometry.narrowphase import (PAIR_KERNELS, POOL_KERNELS,
                                                  compute_manifolds, manifold_buckets,
                                                  pair_manifold_twin)
from avian_tpu_torch.math import quat as quat_m
from avian_tpu_torch.math import vec
from avian_tpu_torch.dim2 import broadphase as bp2
from avian_tpu_torch.dim2 import contacts as nc2
from avian_tpu_torch.dim2 import dynamics as dyn2
from avian_tpu_torch.dim2 import physics_step_2d
from avian_tpu_torch.dim2 import scenes as scenes2d
from avian_tpu_torch.dim2 import solver as sol2
from avian_tpu_torch.kernels import contact_rows_2d as kw
from avian_tpu_torch.kernels import grid_pairs_2d as ku
from avian_tpu_torch.kernels import integrate_2d as kz
from avian_tpu_torch.kernels import manifold_2d as kv
from avian_tpu_torch.kernels import pack_2d as kx
from avian_tpu_torch.kernels import solve_2d as ky
from avian_tpu_torch.dim2 import ccd as ccd2
from avian_tpu_torch.dim2 import step as step2
from avian_tpu_torch.dim2 import xpbd as xpbd2
from avian_tpu_torch.dim2.builder import SceneBuilder2D
from avian_tpu_torch.kernels import solve_joints_2d as kaa
from avian_tpu_torch.kernels import swept_toi_2d as kab
from avian_tpu_torch.dim2 import character as char2d
from avian_tpu_torch.dim2 import forces as forces2d
from avian_tpu_torch.dim2 import queries as q2d
from avian_tpu_torch.kernels import point_2d as kad
from avian_tpu_torch.kernels import ray_cast_2d as kac
from avian_tpu_torch.kernels import shape_cast_2d as kae
from avian_tpu_torch.kernels import aabb_overlap as kah
from avian_tpu_torch.kernels import point_3d as kaf
from avian_tpu_torch.kernels import ray_cast_grid as kag
from avian_tpu_torch.queries import (RayCasters, ShapeCasters, aabb_intersections,
                                     build_query_grid, cast_ray_grid, point_intersections,
                                     project_point, project_point_predicate, shape_intersections,
                                     update_ray_casters, update_shape_casters)
from avian_tpu_torch.queries import accel
from avian_tpu_torch.queries import intersect as qintersect
from avian_tpu_torch.queries import point as qpoint
from avian_tpu_torch import character as char3d
from avian_tpu_torch import contact_query as cq
from avian_tpu_torch import picking
from avian_tpu_torch.geometry.narrowphase import canonical_spans
from avian_tpu_torch.kernels import toi_pair as kai
from avian_tpu_torch.kernels import custom_build
from avian_tpu_torch.kernels import custom_shapes as kcs
from avian_tpu_torch.parallel import make_batched_step, replicate_world
from avian_tpu_torch.parallel.sharding import flatten

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "tests", "torch_cases"))
import random_pairs_2d  # noqa: E402  (Kernel V's seeded random pairs)
import shared_2d  # noqa: E402  (the 2D joint examples, AA's and AB's checks)
import shared_ext  # noqa: E402  (the ellipsoid, the extension points' worlds and user code)

N_CUBES = 10_000
CONTACTS_PER_CUBE = 16
SETTLE_STEPS = 60
TIMED_STEPS = 120
DETERMINISM_CUBES, DETERMINISM_STEPS = 1000, 60
PILE_CONFIG = PhysicsConfig(
    substeps=4, shape_pairs=((ShapeType.BOX, ShapeType.BOX), (ShapeType.BOX, ShapeType.PLANE))
)
GOLDEN_CONFIG = PhysicsConfig(dt=1.0 / 64.0, max_colors=8)
GOLDEN_STEPS, GOLDEN_STRIDE, GOLDEN_TOL = 500, 10, 1e-3
# The hinged golden parts from the reference's trajectory after step 40 on
# the CPU too: the boxes land at step 37 and the impacts amplify last-bit
# differences about twofold a step, as they amplify a 1-ulp nudge of the
# reference's own start (ROADMAP 3a). Its frames up to step 40 are held.
HINGE_GOLDEN_HELD_STEPS = 40
TOL_A, TOL_C_REL, TOL_D = 1e-5, 1e-6, 1e-5
# E, F, H: every integer and boolean output equal to the twin's, floats within
# 1e-6 (they come out bit-equal: the kernels spell the twins' operation order
# and are compiled without fused multiply-adds). G is all integer: equal.
TOL_E = TOL_F = TOL_H = 1e-6

# The box pyramid (the reference's "Large Pyramid" bench scene).
PYRAMID_BASE = 100
# Contact slots per body. The reference's scenes take 8; no pair is dropped
# there, but every contact of a pyramid appears in the first step, the 4
# proposal rounds colour only a few of them, and the rest (most of them) must
# fit the overflow colour's bucket of 2 C / 12 rows until the carried
# colours settle over the next few steps. 24 holds them; the probe in phase
# ``pyramid`` prints what 8 and 16 drop.
PYRAMID_CONTACTS_PER_BOX = 24
PROBE_CONTACTS_PER_BOX, PROBE_STEPS = (8, 16, 24), 4
PYRAMID_OVERFLOW_STEPS, PYRAMID_KERNEL_STEPS = 2, 30
PYRAMID_STEPS = 120
# The pyramid on the kernels against the pyramid on their plain versions: the
# same rows in the overflow colour for the first 8 steps, every box within
# 2 mm for the first 10, and the apex within 5 cm for all 20. The falling
# pyramid amplifies Kernel D's last-bit differences (1e-6 m at step 5, 6e-4 m
# at step 10 and 0.1 m for the worst box at step 40 in the run these limits
# were set from). Past step 25 the apexes part by what the plain versions'
# unordered index_add_ sums happen to give (0.009, 0.018 and 0.069 m at step
# 40 in three runs), so the path stops at step 20, which also makes room for
# the hinged boxes' plain path.
PLAIN_STEPS, PLAIN_EXACT_STEPS, PLAIN_TIGHT_STEPS = 20, 8, 10
PLAIN_TOL, PLAIN_APEX_TOL = 2e-3, 0.05
VARIANT_STEPS = 30
MANY_GRID, MANY_BASE = 10, 10
# Standing gates: farthest sideways move of any box and the apex's move in y,
# in metres, set from what the H100 runs showed (x 1.3). The base-100 pyramid
# does not rest under this config. The overflow colour takes about base / 4
# steps to empty (30 here), and while most constraints sit in it,
# under-relaxed, the upper rows are nearly in free fall: the apex is 0.82 m
# down at step 25 (free fall: 0.85 m), and the 100 rows then swing like a
# spring (+-0.8 m) and spread by 1.1 m. So these gates hold the pyramid only
# to "still a pyramid". What holds the kernels is phase ``plain path``: the
# same pyramid stepped on the plain versions alone sags the same way, and the
# two trajectories must agree. The JAX package sags the same way at the
# depths a CPU can run (``tests/torch_cases/cases_pyramid.py``: base 20 in a
# test, base 40 as a script); whether it does at base 100 is not known.
PYRAMID_MAX_DX, PYRAMID_MAX_APEX_DY = 1.5, 1.1
PYRAMID3D_MAX_DX, PYRAMID3D_MAX_APEX_DY = 0.15, 1.25
# The field's pyramids are tiled in the XY plane, each row of pyramids 1 m
# above the apexes of the row below, so all but the ground row fall for the
# 30 steps (0.5 s, at most 1.23 m of free fall) and land at the end. Gates:
# the ground row's base-10 pyramids keep their place (their apexes sag by
# 0.11 m in those first steps, for the same reason), and no box drops farther
# than free fall.
MANY_MAX_DX, MANY_MAX_APEX_DY = 0.1, 0.15
MANY_MAX_DROP = 1.3

# The hinged-box path: 84 copies side by side of the reference's FallingHinges
# (30 rows of 4 boxes, its spacing and its neighbourhood per box): 10,080
# boxes, 7,560 revolute joints, 16 contact slots a box. One scene of 30 rows
# 334 boxes wide flies apart in the reference itself: every hinge starts 2.5
# cm stretched, and a row of 40 already throws its boxes 1.2 m apart by step
# 3 on the CPU (ROADMAP 3b); phase ``hinges`` prints what that layout does
# on the card.
HINGE_BLOCKS, HINGE_ROWS, HINGE_COLS, HINGE_SLOTS_PER_BOX = 84, 30, 4, 16
WIDE_ROW_COLS, WIDE_ROW_STEPS = 334, 10
HINGE_KERNEL_STEPS, HINGE_STEPS = 30, 120
# Every joint's two world anchors within this of each other (m), the
# tolerance tests/test_e2e.py holds a hinge to.
HINGE_ANCHOR_TOL = 0.02
# The hinged boxes on the kernels against their plain versions: the rows in
# the overflow colour (contacts and joints) equal for 8 steps, every box
# within 2 mm for 10 steps (the pyramid's gates, set before the first run).
HINGE_PLAIN_STEPS = 20
DETERMINISM_HINGE_ROWS, DETERMINISM_HINGE_COLS = 30, 4
TOL_I_REL = 1e-6  # the overflow colour's and the damping's sums reordered

# The mixed-shape path: examples/many_shapes.py's layout 48 x 48 wide, five
# layers (10,000 spheres, boxes, capsules, cylinders and cones in turn), 16
# contact slots a body, the pile's config with the scene's 20 shape pairs.
# Kernels M, N and O are held against their plain versions on every bucket
# after SHAPES_KERNEL_STEPS, when the layers have landed on each other.
SHAPES_N, SHAPES_PER_ROW, SHAPES_SLOTS_PER_BODY = 10_000, 48, 16
SHAPE_PAIRS = tuple((a, b) for a in range(6) for b in range(a, 6) if (a, b) != (3, 3))
SHAPES_CONFIG = PhysicsConfig(substeps=4, shape_pairs=SHAPE_PAIRS)
SHAPES_KERNEL_STEPS, SHAPES_STEPS = 40, 120
SHAPES_PLAIN_N, SHAPES_PLAIN_PER_ROW = 2_000, 24
# One step of the landed pile on the kernels against one on the plain
# versions, from the same state: they differ only by Kernel D's last bits.
# Three single steps each, cut from six to keep the smoke's time as its
# phases grow (in the runs before the cut, the largest difference of the six
# came within the first three).
SHAPES_ONE_STEPS, SHAPES_ONE_STEP_TOL = 3, 1e-4
# Kernels M, N, O against their plain versions. They are compiled without
# fused multiply-adds and spell the plain versions' operations out, so the
# aim is bit-equality; this is the most any float may differ.
TOL_MNO = 1e-5
# Operations a pair: M runs 24 Frank-Wolfe and 20 subgradient steps (two
# support functions under two rotations each), two rounds of patches, up to
# 8 clips of 16 points and a lift of 16; O one patch and a reduction of 8; N
# a closed form. P is M's pipeline plus, for each pool-backed shape of the
# pair, a scan of its vertices in each of its ~48 support calls (6
# operations a vertex) and two hull patches (some 60 a vertex and 500 more
# each); Q is one hull patch and a reduction of 8. The vertices are this
# launch's own (params lane 1).
OPS_PER_PAIR = {"convex_manifold": 15_000, "plane_patch_manifold": 700, "round_manifold": 150,
                "hull_manifold": 15_000, "plane_hull_manifold": 700}
OPS_PER_HULL = {"hull_manifold": 1_000, "plane_hull_manifold": 500}
OPS_PER_HULL_VERTEX = {"hull_manifold": 408, "plane_hull_manifold": 60}
# tests/test_shapes_convex.py's cylinder stack: config, steps and bounds.
CYLINDER_CONFIG = PhysicsConfig(max_colors=4, shape_pairs=((3, 4), (4, 4), (3, 5)))
CYLINDER_STEPS, CYLINDER_HEIGHT_TOL, CYLINDER_TILT_TOL, CONE_TOL = 240, 0.08, 0.05, 0.05
# examples/many_shapes.py: its scene and config, 300 steps (5 x 60) twice.
EXAMPLE_SHAPES_STEPS = 300

# The hull-and-terrain path: scenes.terrain_shapes, examples/many_shapes.py's
# layout 48 wide (10,000 bodies: its five shapes, rocks of 12 hull points and
# round cuboids in turn) over a 65 x 65 heightfield (8,192 triangles over
# 64 m x 64 m), 24 contact slots a body, the 21 canonical pairs of spheres,
# capsules, boxes, cylinders, cones and pool-backed convex shapes. Kernel P
# (and A-N again) is held against its plain version on every bucket after
# TERRAIN_KERNEL_STEPS, when the first layers have landed.
TERRAIN_N, TERRAIN_PER_ROW, TERRAIN_SEED, TERRAIN_FIELD = 10_000, 48, 7, 65
TERRAIN_SLOTS_PER_BODY = 24
_TERRAIN_SHAPES = (0, 1, 2, 4, 5, 8)
TERRAIN_PAIRS = tuple((a, b) for i, a in enumerate(_TERRAIN_SHAPES) for b in _TERRAIN_SHAPES[i:])
# Kernel B's window at 64: the landed layers and the triangles beneath them
# fill grid cells past the reference's 32-entry window (ROADMAP 3b), which
# drops pairs; the port's 64-bit candidate mask takes a cell run of 65.
TERRAIN_WINDOW = 64
TERRAIN_CONFIG = PhysicsConfig(substeps=4, shape_pairs=TERRAIN_PAIRS, sap_window=TERRAIN_WINDOW)
TERRAIN_KERNEL_STEPS, TERRAIN_STEPS = 40, 120
# No body's centre more than this below the field's surface at its (x, z).
TERRAIN_BELOW_TOL = 0.05
TERRAIN_PLAIN_N, TERRAIN_PLAIN_PER_ROW = 2_000, 24
DETERMINISM_TERRAIN = dict(n=300, per_row=12, field=17)
DETERMINISM_TERRAIN_STEPS = 60
# Random pairs of each of the 15 canonical pairs of segments and pool-backed
# convex shapes (Kernels M and O's segment instances, P and Q).
RANDOM_PAIRS = 4096
# The reference's own scenes, configs, steps and checks:
# examples/trimesh_shapes_3d.py, examples/voxels_3d.py,
# tests/test_convex_hull.py:54-88 and tests/test_round_shapes.py:34.
SCENE_CONFIG = PhysicsConfig(max_colors=4)
HULL_CONFIG = PhysicsConfig(max_colors=4, shape_pairs=((3, 8), (8, 8), (2, 8)))
ROUND_CONFIG = PhysicsConfig(max_colors=4, shape_pairs=((3, 8), (8, 8)))

# The swept-CCD path: scenes.terrain_ccd, the terrain's world and 32 bullets
# (16 linear spheres, 16 spinning capsules swept nonlinearly) fired down into
# it at 300 m/s, K = 32 swept colliders against its 18,224; the terrain's
# config with swept CCD. Kernel R is held against its plain version on the
# state after CCD_KERNEL_STEPS steps, on every collider whose swept AABB meets
# a bullet's and CCD_TWIN_COLUMNS seeded ones (the whole grid's 583k pairs
# take the plain version minutes); the nonlinear rows within
# TOL_R_NONLINEAR (the rotation at t comes from sinf/cosf, which may round
# apart from PyTorch's), the rest bit for bit.
CCD_BULLETS, CCD_STEPS, CCD_CONTROL_STEPS, CCD_KERNEL_STEPS = 32, 120, 30, 2
CCD_CONFIG = TERRAIN_CONFIG.replace(swept_ccd=True)
CCD_TWIN_COLUMNS, TOL_R_NONLINEAR = 2048, 1e-5
# One step of CCD_PLAIN_N bodies and bullets on the kernels against one on
# the plain versions, from the same state, as the mixed shapes' plain path.
CCD_PLAIN_N, CCD_PLAIN_BULLETS, CCD_ONE_STEPS, CCD_ONE_STEP_TOL = 2_000, 8, 2, 1e-4
DETERMINISM_CCD = dict(n=300, per_row=12, bullets=8, field=17)
DETERMINISM_CCD_STEPS = 60
# tests/test_scenes.py's swept-CCD config (its TEST_SHAPE_PAIRS).
SWEPT_CONFIG = PhysicsConfig(max_colors=4, swept_ccd=True, shape_pairs=(
    (0, 0), (0, 1), (0, 2), (0, 3), (1, 1), (1, 3), (2, 2), (2, 3)))
# The queries: casts into the terrain after TERRAIN_KERNEL_STEPS steps, one of
# each shape (params as the builder stores them), S held to its plain version
# on each cast's colliders whose AABB, widened by QUERY_AABB_PAD, meets the
# cast's swept box, and CCD_TWIN_COLUMNS seeded ones; QUERY_RAYS rays in one
# call, T held to its plain version on the first QUERY_TWIN_RAYS of them.
QUERY_SHAPES = ((int(ShapeType.SPHERE), (0.3,)), (int(ShapeType.CAPSULE), (0.3, 0.15)),
                (int(ShapeType.BOX), (0.3, 0.2, 0.4)), (int(ShapeType.CYLINDER), (0.3, 0.25)),
                (int(ShapeType.CONE), (0.35, 0.3)))
QUERY_MAX_DISTANCE, QUERY_RAYS, QUERY_TWIN_RAYS, QUERY_AABB_PAD = 40.0, 1024, 64, 0.5
# S and T against their plain versions: the aim is bit-equality (the kernels
# spell the plain versions' operations out); this is the most a float may
# differ.
TOL_ST = 1e-5
# Operations of one manifold of each pair kernel's pairs (OPS_PER_PAIR's,
# box/box's SAT and clip as Kernel A's bound counts it), and of the rest of a
# round of R or S (two rotations at t, the advancement); of one (ray,
# analytic collider) of T, and of one vertex of one scan of a hull's
# vertices (a dot product and a compare).
MANIFOLD_OPS = dict(OPS_PER_PAIR, box_manifold=2500)
ROUND_OPS, RAY_OPS, HULL_SCAN_OPS = 100, 60, 6

# The card's peaks for the bounds (NVIDIA H100 SXM data sheet): device memory
# 3.35 TB/s; 67 TFLOP/s float32 outside the tensor cores, taken for the
# integer work as well.
PEAK_BYTES_PER_S, PEAK_OPS_PER_S = 3.35e12, 67e12

REPLACES = {
    "box_manifold": ("cuda", "avian_tpu_torch/csrc/box_manifold.cu",
                     "avian_tpu/geometry/box_box.py:28"),
    "grid_sweep": ("cuda", "avian_tpu_torch/csrc/grid_sweep.cu",
                   "avian_tpu/pipeline/broadphase.py:179"),
    "integrate_bodies": ("triton", "avian_tpu_torch/kernels/integrate_bodies_triton.py",
                         "avian_tpu/pipeline/integrator.py:97"),
    "solve_color": ("cuda", "avian_tpu_torch/csrc/solve_color.cu",
                    "avian_tpu/pipeline/solver.py:451"),
    "collider_aabbs": ("cuda", "avian_tpu_torch/csrc/collider_aabbs.cu",
                       "avian_tpu/pipeline/broadphase.py:96"),
    "contact_rows": ("cuda", "avian_tpu_torch/csrc/contact_rows.cu",
                     "avian_tpu/pipeline/contacts.py:54"),
    "color_edges": ("cuda", "avian_tpu_torch/csrc/color_edges.cu",
                    "avian_tpu/pipeline/coloring.py:41"),
    "pack_constraints": ("cuda", "avian_tpu_torch/csrc/pack_constraints.cu",
                         "avian_tpu/pipeline/solver.py:158"),
    "solve_joints": ("cuda", "avian_tpu_torch/csrc/solve_joints.cu",
                     "avian_tpu/pipeline/xpbd.py:283"),
    "islands": ("cuda", "avian_tpu_torch/csrc/islands.cu",
                "avian_tpu/pipeline/sleeping.py:33"),
    "body_pass": ("cuda", "avian_tpu_torch/csrc/body_pass.cu",
                  "avian_tpu/pipeline/solver_body.py:85"),
    "compact_pairs": ("cuda", "avian_tpu_torch/csrc/compact_pairs.cu",
                      "avian_tpu/pipeline/broadphase.py:347"),
    "convex_manifold": ("cuda", "avian_tpu_torch/csrc/convex_manifold.cu",
                        "avian_tpu/geometry/convex.py:468"),
    "round_manifold": ("cuda", "avian_tpu_torch/csrc/round_manifold.cu",
                       "avian_tpu/geometry/narrowphase.py:88"),
    "plane_patch_manifold": ("cuda", "avian_tpu_torch/csrc/convex_manifold.cu",
                             "avian_tpu/geometry/convex.py:702"),
    "hull_manifold": ("cuda", "avian_tpu_torch/csrc/hull_manifold.cu",
                      "avian_tpu/geometry/convex.py:881"),
    "plane_hull_manifold": ("cuda", "avian_tpu_torch/csrc/hull_manifold.cu",
                            "avian_tpu/geometry/convex.py:902"),
    "swept_toi": ("cuda", "avian_tpu_torch/csrc/swept_toi.cuh",
                  "avian_tpu/pipeline/ccd.py:40"),
    "shape_cast": ("cuda", "avian_tpu_torch/csrc/shape_cast.cuh",
                   "avian_tpu/queries/shapecast.py:59"),
    "ray_cast": ("cuda", "avian_tpu_torch/csrc/ray_cast.cu",
                 "avian_tpu/queries/raycast.py:372"),
    "grid_pairs_2d": ("cuda", "avian_tpu_torch/csrc/grid_pairs_2d.cu",
                      "avian_tpu/dim2/broadphase_impl.py:23"),
    "manifold_2d": ("cuda", "avian_tpu_torch/csrc/manifold_2d.cu",
                    "avian_tpu/dim2/narrowphase.py:339"),
    "contact_rows_2d": ("cuda", "avian_tpu_torch/csrc/contact_rows_2d.cu",
                        "avian_tpu/dim2/contacts.py:18"),
    "pack_2d": ("cuda", "avian_tpu_torch/csrc/pack_2d.cu", "avian_tpu/dim2/solver.py:87"),
    "solve_2d": ("cuda", "avian_tpu_torch/csrc/solve_2d.cu", "avian_tpu/dim2/solver.py:314"),
    "integrate_2d": ("cuda", "avian_tpu_torch/csrc/integrate_2d.cu",
                     "avian_tpu/dim2/dynamics.py:141"),
    "prepare_2d": ("cuda", "avian_tpu_torch/csrc/integrate_2d.cu",
                   "avian_tpu/dim2/dynamics.py:46"),
    "writeback_2d": ("cuda", "avian_tpu_torch/csrc/body_pass.cu",
                     "avian_tpu/dim2/dynamics.py:80"),
    "sleep_update_2d": ("cuda", "avian_tpu_torch/csrc/islands.cu",
                        "avian_tpu/dim2/step.py:160"),
    "solve_joints_2d": ("cuda", "avian_tpu_torch/csrc/solve_joints_2d.cu",
                        "avian_tpu/dim2/xpbd.py:197"),
    "swept_toi_2d": ("cuda", "avian_tpu_torch/csrc/swept_toi_2d.cu",
                     "avian_tpu/dim2/ccd.py:28"),
    "ray_cast_2d": ("cuda", "avian_tpu_torch/csrc/ray_cast_2d.cu",
                    "avian_tpu/dim2/queries.py:164"),
    "point_2d": ("cuda", "avian_tpu_torch/csrc/point_2d.cu", "avian_tpu/dim2/queries.py:356"),
    "shape_cast_2d": ("cuda", "avian_tpu_torch/csrc/shape_cast_2d.cu",
                      "avian_tpu/dim2/queries.py:500"),
    "point_3d": ("cuda", "avian_tpu_torch/csrc/point_3d.cu", "avian_tpu/queries/point.py:17"),
    "ray_cast_grid": ("cuda", "avian_tpu_torch/csrc/ray_cast_grid.cu",
                      "avian_tpu/queries/accel.py:118"),
    "aabb_overlap": ("cuda", "avian_tpu_torch/csrc/aabb_overlap.cu",
                     "avian_tpu/queries/intersect.py:14"),
    "shape_overlap": ("cuda", "avian_tpu_torch/csrc/shape_cast.cuh",
                      "avian_tpu/queries/intersect.py:27"),
    "shape_manifold": ("cuda", "avian_tpu_torch/csrc/shape_cast.cuh",
                       "avian_tpu/character/move_and_slide.py:57"),
    "toi_pair": ("cuda", "avian_tpu_torch/csrc/toi_pair.cuh",
                 "avian_tpu/geometry/contact_query.py:81"),
}
# Launches of each kernel in one full step of a world with (``j``) or
# without joint slots (Kernels A, M, N, O: one per shape pair present,
# counted from the step's diagnostics). G: 13 of the contacts' coloring (and 13 more of the
# joints'), 1 of the bucketing, 1 run rank of the island table. I: the
# joint rows, then one per joint colour and one for the velocities, every
# substep.
STEP_LAUNCHES = {
    "grid_sweep": lambda cfg, j: 1,
    "integrate_bodies": lambda cfg, j: 2 * cfg.substeps,
    "solve_color": lambda cfg, j: (cfg.substeps * 3 + cfg.solver.restitution_iterations)
    * cfg.max_colors,
    "collider_aabbs": lambda cfg, j: 2,
    "contact_rows": lambda cfg, j: 2,
    "color_edges": lambda cfg, j: (5 + 2 * kg.ASSIGN_ROUNDS) * (2 if j else 1) + 1 + 1,
    "pack_constraints": lambda cfg, j: 3,
    "solve_joints": lambda cfg, j: 1 + cfg.substeps * (cfg.max_colors + 1) if j else 0,
    "islands": lambda cfg, j: 3,
    "body_pass": lambda cfg, j: 2,
    "compact_pairs": lambda cfg, j: 3,
}


def say(phase, text):
    print(f"[{phase}] {text}", flush=True)


def cuda_ms(fn, reps=10):
    """Mean milliseconds of ``fn()`` on the card, by CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def once_ms(fn):
    """``(fn(), milliseconds)`` of one call, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(read_write_bytes, operations):
    """(bound_ms, bound_by): the least time the card could take."""
    t_bytes = read_write_bytes / PEAK_BYTES_PER_S
    t_ops = operations / PEAK_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def measured(err, kernel_fn, twin_fn, read_write_bytes, operations):
    b_ms, b_by = bound(read_write_bytes, operations)
    return dict(max_abs_err=err, ms=cuda_ms(kernel_fn), plain_ms=cuda_ms(twin_fn),
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def compare(what, got, want, tol=0.0):
    """Max abs difference of two tensors; raises beyond ``tol`` (integer and
    boolean tensors: on any difference)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.dtype}{tuple(got.shape)} against "
                             f"{want.dtype}{tuple(want.shape)}")
    if got.dtype.is_floating_point:
        same = (got == want) | (got.isnan() & want.isnan())
        diff = torch.where(same, 0.0, (got - want).abs())
        err = float(diff.max()) if diff.numel() else 0.0
        bad = int((~(diff <= tol)).sum())
    else:
        bad = int((got != want).sum())
        err = float(bad > 0)
    if bad:
        where = torch.nonzero((got != want).reshape(got.shape[0], -1).any(-1))[:5, 0].tolist()
        raise AssertionError(f"{what}: {bad} of {got.numel()} entries differ from the "
                             f"twin (max abs {err}, tolerance {tol}); first rows {where}")
    return err


def pile(n_cubes, device):
    world, _ = scenes.cube_pile(
        n_cubes, max_contacts=CONTACTS_PER_CUBE * n_cubes, device=device
    )
    return world


def bouncing(world):
    """The same world with restitution 0.7 on every collider and every
    dynamic body awake and moving down at 3 m/s, so that Kernel D's
    restitution mode acts (the pile's colliders have restitution 0)."""
    b = world.bodies
    down = torch.tensor([0.0, -3.0, 0.0], device=b.lin_vel.device)
    dyn = (b.body_type == BodyType.DYNAMIC)[:, None]
    return world.replace(
        bodies=b.replace(lin_vel=b.lin_vel + down * dyn, sleeping=torch.zeros_like(b.sleeping)),
        colliders=world.colliders.replace(
            restitution=torch.full_like(world.colliders.restitution, 0.7)
        ),
    )


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("device", f"{smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    return smi


def phase_build():
    """Build the kernel library and, beside it (its ``nvcc`` runs started
    together with the library's), the generated unit of the extensions
    phase's custom shape."""
    import threading

    t0 = time.perf_counter()
    custom = {}
    thread = threading.Thread(target=lambda: custom.update(
        lib=custom_build.library((shared_ext.ELLIPSOID,))))
    thread.start()
    build.library()
    main_s = time.perf_counter() - t0
    thread.join()
    if "lib" not in custom:
        raise AssertionError("build: the custom shape's unit did not build")
    seconds = time.perf_counter() - t0
    log = build.lib_path().with_suffix(".log")
    regs = [ln.split(":", 1)[1].strip() for ln in log.read_text().splitlines()
            if "registers" in ln] if log.exists() else []
    say("build", f"{seconds:.1f} s ({main_s:.1f} s the library, {custom['lib'].build_s:.1f} s "
        f"the custom unit beside it), {build.lib_path().name}, {custom['lib'].path.name}; "
        f"ptxas: {' | '.join(regs)}")


def solve_all_modes(p, config):
    """Kernel D and its twin through one pass of every color in each mode,
    each mode from the same state; returns the max abs difference and the
    kernel's impulses before and after the restitution pass."""
    con = p.con
    params = sol_m.solve_params(config)
    state_k = kc.integrate_bodies(p.s.state, p.table, config.substep_dt, kc.VELOCITIES).clone()
    imp_k = con.imp.clone()
    err = 0.0
    for mode in (kd.WARM, kd.BIAS, kd.RELAX, kd.RESTITUTION):
        state_t, imp_t, before = state_k.clone(), imp_k.clone(), imp_k.clone()
        for c in range(con.data.shape[0]):
            kd.solve_color(mode, c, state_k, con.data, imp_k, con.bucket_a, con.bucket_b,
                           con.bucket_valid, con.relax, con.ovf_order, con.ovf_key, params)
            kd.solve_color_twin(mode, c, state_t, con.data, imp_t, con.bucket_a,
                                con.bucket_b, con.bucket_valid, con.relax, params)
        err = max(err, float((state_k[:, :6] - state_t[:, :6]).abs().max()),
                  float((imp_k - imp_t).abs().max()))
    return err, before, imp_k


def sweep_tests(skey, w):
    """How many (entry, later entry of the same cell within the window)
    tests Kernel B makes on these sorted keys."""
    keys, runs = torch.unique_consecutive(skey, return_counts=True)
    runs = runs[kb.cell_bits(keys) != kb.SENTINEL].double()
    short = runs * (runs - 1) / 2
    long = w * (w + 1) / 2 + (runs - w - 1) * w
    return float(torch.where(runs <= w + 1, short, long).sum())


def kernels_abcd(world, config, bounce):
    """Kernels A-D against their twins on ``world``; {name: measurements}.
    With ``bounce``, D's restitution mode is also held on the bouncing copy
    of the world."""
    out = {}

    # --- B: grid sweep ----------------------------------------------------
    w2, pos, quat = bp_m.update_aabbs_and_poses(world, config)
    g = bp_m.grid_entries(w2, config)
    args = (g.skey, g.sf, g.si, g.window)
    bk, rk = kb.grid_sweep(*args)
    bt, rt = kb.grid_sweep_twin(*args)
    compare("grid_sweep bits", bk, bt)
    compare("grid_sweep rank", rk, rt)
    out["grid_sweep"] = measured(
        0.0, lambda: kb.grid_sweep(*args), lambda: kb.grid_sweep_twin(*args),
        nbytes(g.skey, g.sf, g.si, bk, rk),
        16 * sweep_tests(g.skey, g.window) + 4 * g.skey.numel(),
    )

    # --- A: box manifolds -------------------------------------------------
    bp = bp_m.broad_phase(w2, config)
    col = w2.colliders
    buckets = [b for b in manifold_buckets(col.shape_type, col.params, pos, quat,
                                           bp.collider_a, bp.collider_b, bp.valid,
                                           config.shape_pairs, w2.convex_verts)
               if b.name == "box_manifold"]
    err_a, bytes_a, ops_a = 0.0, 0, 0
    for bkt in buckets:
        rk_ = ka.box_manifold(bkt.kind, *bkt.inputs)
        rt_ = ka.box_manifold_twin(bkt.kind, *bkt.inputs)
        compare(f"box_manifold kind {bkt.kind} feature ids", rk_[4], rt_[4])
        compare(f"box_manifold kind {bkt.kind} counts", rk_[5], rt_[5])
        for x, y in zip(rk_[:4], rt_[:4]):
            err_a = max(err_a, compare(f"box_manifold kind {bkt.kind}", x, y, TOL_A))
        bytes_a += nbytes(*bkt.inputs, *rk_)
        # SAT over 15 axes and clipping against picking 4 of 8 corners.
        ops_a += bkt.slots.shape[0] * (2500 if bkt.kind == ka.BOX_BOX else 200)

    def run_a(fn):
        for bkt in buckets:
            fn(bkt.kind, *bkt.inputs)

    out["box_manifold"] = measured(
        err_a, lambda: run_a(ka.box_manifold), lambda: run_a(ka.box_manifold_twin),
        bytes_a, ops_a,
    )

    # --- C and D on this step's prepared solver inputs --------------------
    p = prepare_step(world, config)
    h = config.substep_dt
    st = p.s.state
    err_c = rel_c = 0.0
    for mode in (kc.VELOCITIES, kc.POSITIONS):
        k_out = kc.integrate_bodies(st, p.table, h, mode)
        t_out = kc.integrate_bodies_twin(st, p.table, h, mode)
        # Relative to the largest magnitude of each quantity (velocities,
        # angular velocities, delta positions, delta rotations).
        for lo, hi in ((0, 3), (3, 6), (6, 9), (9, 13)):
            ref = t_out[:, lo:hi]
            diff = float((k_out[:, lo:hi] - ref).abs().max())
            err_c = max(err_c, diff)
            rel_c = max(rel_c, diff / max(float(ref.abs().max()), 1e-30))
        st = k_out
    if rel_c > TOL_C_REL:
        raise AssertionError(f"integrate_bodies: relative err {rel_c} > {TOL_C_REL}")

    def run_c(fn):
        s1 = fn(p.s.state, p.table, h, kc.VELOCITIES)
        fn(s1, p.table, h, kc.POSITIONS)

    n_bodies = p.s.state.shape[0]
    out["integrate_bodies"] = measured(
        err_c, lambda: run_c(kc.integrate_bodies), lambda: run_c(kc.integrate_bodies_twin),
        2 * (2 * nbytes(p.s.state) + nbytes(p.table)), 2 * 150 * n_bodies,
    )

    err_d, _, _ = solve_all_modes(p, config)
    bounced = 0
    if bounce:
        # Restitution acts only where it is on and contacts approach fast.
        err_bounce, before, after = solve_all_modes(
            prepare_step(bouncing(world), config), config)
        bounced = int((after[..., :4] != before[..., :4]).any(-1).sum())
        if bounced == 0:
            raise AssertionError(
                "solve_color: restitution changed no impulse on the bouncing pile")
        err_d = max(err_d, err_bounce)
    if err_d > TOL_D:
        raise AssertionError(f"solve_color: max abs err {err_d} > {TOL_D}")

    con = p.con
    params = sol_m.solve_params(config)
    colors = con.data.shape[0]
    state_k = kc.integrate_bodies(p.s.state, p.table, h, kc.VELOCITIES)
    imp_k = con.imp

    def run_d(fn, twin):
        s1, i1 = state_k.clone(), imp_k.clone()

        def go():
            for c in range(colors):
                if twin:
                    fn(kd.BIAS, c, s1, con.data, i1, con.bucket_a, con.bucket_b,
                       con.bucket_valid, con.relax, params)
                else:
                    fn(kd.BIAS, c, s1, con.data, i1, con.bucket_a, con.bucket_b,
                       con.bucket_valid, con.relax, con.ovf_order, con.ovf_key, params)
        return go

    # A valid row: its data and impulses in, impulses out, relax, two body
    # indices, two body rows in and two velocity rows out, in 4-byte words.
    rows_d = int(con.bucket_valid.sum())
    out["solve_color"] = measured(
        err_d, run_d(kd.solve_color, False), run_d(kd.solve_color_twin, True),
        4 * rows_d * (kd.D + 2 * kd.IMP + 3 + 2 * 13 + 2 * 6), 600 * rows_d,
    )
    locked = int((world.bodies.locked_axes != 0).sum())
    note = (f"{int(bp.num_pairs)} pairs, {rows_d} rows solved, "
            f"{int(con.bucket_valid[-1].sum())} of them in the overflow colour, "
            f"{locked} bodies with locked axes"
            + (f", restitution changed {bounced} rows of the bouncing copy" if bounce else ""))
    return out, note


def kernels_efgh(world, config):
    """Kernels E-H against their twins on the prepare stage of ``world``'s
    next step; {name: measurements}."""
    out = {}
    b, col = world.bodies, world.colliders
    dt = config.dt
    spec = config.narrow_phase.default_speculative_margin
    tol = config.narrow_phase.contact_tolerance * config.length_unit

    # --- E: poses, AABBs, cell keys ---------------------------------------
    e_in = (b, col, dt, spec, tol)
    got = ke.collider_aabbs(*e_in)
    want = ke.collider_aabbs_twin(*e_in)
    err_e = 0.0
    for name, x, y in zip(("aabb_min", "aabb_max", "pos", "quat"), got, want):
        err_e = max(err_e, compare(f"collider_aabbs {name}", x, y, TOL_E))
    w2, pos, quat = bp_m.update_aabbs_and_poses(world, config)
    col2 = w2.colliders
    cell, in_sweep, _ = bp_m.sweep_cell(col2)
    k_in = (b, col2, cell, in_sweep)
    got_k = ke.cell_keys(*k_in)
    want_k = ke.cell_keys_twin(*k_in)
    compare("cell_keys ckey", got_k[0], want_k[0])
    err_e = max(err_e, compare("cell_keys fpack", got_k[1], want_k[1], TOL_E))
    compare("cell_keys ipack", got_k[2], want_k[2])
    if int((got_k[0] != kb.SENTINEL).sum()) == 0:
        raise AssertionError("cell_keys: no collider entered the grid")

    def run_e(f_aabb, f_keys):
        f_aabb(*e_in)
        f_keys(*k_in)

    m = col.capacity
    out["collider_aabbs"] = measured(
        err_e, lambda: run_e(ke.collider_aabbs, ke.cell_keys),
        lambda: run_e(ke.collider_aabbs_twin, ke.cell_keys_twin),
        nbytes(col.body_idx, col.shape_type, col.params, col.local_pos, col.local_quat,
               col.speculative_margin, col.collision_margin, b.pos, b.quat, b.lin_vel,
               *got)
        + nbytes(cell, in_sweep, col.layer_members, col.layer_filter, b.body_type,
                 b.active, *got_k),
        180 * m,
    )

    # --- F: contact persistence -------------------------------------------
    bp = bp_m.broad_phase(w2, config)
    old = w2.contacts
    c_cap = old.capacity
    man, _ = compute_manifolds(col.shape_type, col.params, pos, quat, bp.collider_a.long(),
                               bp.collider_b.long(), bp.valid, config.shape_pairs,
                               w2.convex_verts)
    ks, s = torch.sort(torch.cat([old.pair_key, bp.pair_key]), stable=True)
    hit, survives = kf.contact_join(ks, s, c_cap)
    hit_t, survives_t = kf.contact_join_twin(ks, s, c_cap)
    compare("contact_join hit", hit, hit_t)
    compare("contact_join survives", survives, survives_t)
    minted = torch.cumsum((bp.valid & (hit == 0)).to(torch.int32), dim=0, dtype=torch.int32)
    f_in = (b, col, old, bp.valid, bp.collider_a, bp.collider_b, man, hit, survives,
            old.next_contact_id + (minted - 1), np_m.row_params(config))
    rows = kf.contact_rows(*f_in)
    rows_t = kf.contact_rows_twin(*f_in)
    err_f = 0.0
    for name in kf.ROW_COLUMNS:
        err_f = max(err_f, compare(f"contact_rows {name}", rows[name], rows_t[name], TOL_F))
    matched = int((hit > 0).sum())

    def run_f(f_join, f_rows):
        f_join(ks, s, c_cap)
        f_rows(*f_in)

    # hit, survives and the minted ids pass between F's own two launches.
    out["contact_rows"] = measured(
        err_f, lambda: run_f(kf.contact_join, kf.contact_rows),
        lambda: run_f(kf.contact_join_twin, kf.contact_rows_twin),
        nbytes(ks, s)
        + nbytes(bp.valid, bp.collider_a, bp.collider_b, man.point_a, man.point_b,
                 man.separation, man.feature_id, man.count, col.body_idx,
                 col.speculative_margin, col.collision_margin, col.friction,
                 col.static_friction, col.restitution, col.friction_combine,
                 col.restitution_combine, col.is_sensor, b.pos, b.quat, b.com, b.lin_vel,
                 old.active, old.touching, old.color, old.contact_id,
                 old.feature_id, old.anchor_a, old.normal_impulse, old.tangent_impulse,
                 old.num_points, old.body_a, old.body_b, *rows.values()),
        500 * c_cap,
    )

    # --- G: coloring and bucketing ----------------------------------------
    contacts, _ = np_m.narrow_phase(w2, bp, config, poses=(pos, quat))
    sbody = sb_m.prepare(w2.bodies)
    n_bodies = b.capacity
    flags = kh.constraint_flags(contacts, sbody.solve_mask)
    flags_t = kh.constraint_flags_twin(contacts, sbody.solve_mask)
    for name, x, y in zip(("dyn_a", "dyn_b", "solve", "base_imp"), flags, flags_t):
        compare(f"constraint_flags {name}", x, y)
    dyn_a, dyn_b, solve, base_imp = flags
    colors = config.max_colors
    g_in = (contacts.body_a, contacts.body_b, dyn_a, dyn_b, solve, n_bodies, colors,
            contacts.color)
    color, ovf = kg.color_edges(*g_in)
    color_t, ovf_t = kg.color_edges_twin(*g_in)
    compare("color_edges color", color, color_t)
    compare("color_edges is_overflow", ovf, ovf_t)
    cap = max(1, int(config.color_bucket_factor * c_cap + colors - 1) // colors)
    bk_in = (color, solve, colors, cap)
    bk = kg.bucket_edges(*bk_in)
    bk_t = kg.bucket_edges_twin(*bk_in)
    for name, x, y in zip(("buckets", "valid", "dropped", "num_overflow"), bk, bk_t):
        compare(f"bucket_edges {name}", x.reshape(-1), y.reshape(-1))
    carried = int((solve & (contacts.color >= 0) & (contacts.color == color)).sum())
    # The run rank, on the keys the island table ranks every step.
    island_key = sleep_m.island_incidences(w2.bodies, contacts, w2.joints)[1]
    rank = kr.run_rank(island_key)
    compare("run_rank", rank, kr.run_rank_twin(island_key))
    if int(rank.max()) == 0:
        raise AssertionError("run_rank: no body of the island table has two neighbours")

    def run_g(f_color, f_bucket, f_rank):
        f_color(*g_in)
        f_bucket(*bk_in)
        f_rank(island_key)

    out["color_edges"] = measured(
        0.0, lambda: run_g(kg.color_edges, kg.bucket_edges, kr.run_rank),
        lambda: run_g(kg.color_edges_twin, kg.bucket_edges_twin, kr.run_rank_twin),
        nbytes(contacts.body_a, contacts.body_b, dyn_a, dyn_b, solve, contacts.color, color,
               ovf, bk[0], bk[1], island_key, rank),
        400 * c_cap,
    )

    # --- H: packing -------------------------------------------------------
    buckets, bucket_valid = bk[0], bk[1]
    dyn_soft, non_dyn_soft = sol_m.contact_softness(config)
    h_in = (w2.bodies, contacts, sbody, dyn_a, dyn_b, solve, base_imp, buckets, bucket_valid,
            dyn_soft, non_dyn_soft)
    packed = kh.pack_constraints(*h_in)
    packed_t = kh.pack_constraints_twin(*h_in)
    err_h = 0.0
    for name, x, y in zip(packed._fields, packed, packed_t):
        err_h = max(err_h, compare(f"pack_constraints {name}", x, y, TOL_H))

    def run_h(f_flags, f_pack):
        f_flags(contacts, sbody.solve_mask)
        f_pack(*h_in)

    # The flags pass between H's own launches; body_a/b are read once.
    wb = w2.bodies
    out["pack_constraints"] = measured(
        err_h, lambda: run_h(kh.constraint_flags, kh.pack_constraints),
        lambda: run_h(kh.constraint_flags_twin, kh.pack_constraints_twin),
        nbytes(contacts.body_a, contacts.body_b, contacts.active, contacts.touching,
               contacts.is_sensor, sbody.solve_mask, contacts.normal_impulse,
               contacts.tangent_impulse)
        + nbytes(buckets, bucket_valid, contacts.normal, contacts.anchor_a, contacts.anchor_b, contacts.penetration,
                 contacts.num_points, contacts.friction, contacts.restitution,
                 contacts.static_friction, contacts.surface_velocity,
                 wb.body_type, wb.sleeping, wb.dominance, wb.lin_vel, sbody.state,
                 sbody.inv_mass, sbody.inv_inertia, *packed),
        800 * buckets.numel(),
    )
    note = (f"{int(bp.num_pairs)} pairs, {matched} continued, {int(solve.sum())} solved, "
            f"{carried} colours kept, {int(ovf.sum())} in the overflow colour")
    return out, note


def island_rounds_to_converge(neighbors, label):
    """How many more Jacobi rounds the labels need to stop changing, and how
    many bodies' labels the 10 rounds left short of that."""
    n = neighbors.shape[0]
    pad = torch.full((1,), n, dtype=torch.int32, device=neighbors.device)
    nb = neighbors.long()
    lab, rounds = label.clone(), 0
    while rounds < 10_000:
        step = torch.minimum(lab, torch.cat([lab, pad])[nb].amin(dim=1))
        step = torch.minimum(step, step[step.long()])
        if torch.equal(step, lab):
            break
        lab, rounds = step, rounds + 1
    return rounds, int((lab != label).sum())


def joint_substep(jc, colors, h, twin, state, lam, upto=None, velocities=True):
    """Kernel I (or its twin) through the joint colours ``0 .. upto - 1`` and
    the velocities of one substep, on ``state`` and ``lam`` in place."""
    pre = state[:, 6:13].clone()
    for c in range(colors if upto is None else upto):
        if twin:
            ki.joint_color_twin(c, state, jc.data, lam, jc.jtype, jc.body_a, jc.body_b, jc.color,
                                jc.mask, h * h)
        else:
            ki.joint_color(c, c == colors - 1, state, jc.data, lam, jc.jtype, jc.body_a,
                           jc.body_b, jc.color, jc.mask, jc.ovf_order, jc.ovf_key, h * h)
    if velocities and twin:
        ki.joint_velocities_twin(state, pre, jc.data, jc.body_a, jc.body_b, jc.mask, h)
    elif velocities:
        ki.joint_velocities(state, pre, jc.data, jc.body_a, jc.body_b, jc.mask, jc.damp_order,
                            jc.damp_key, h)
    return state, lam


def kernels_ijkl(world, config):
    """Kernels I (with joints), J, K and L against their twins on ``world``'s
    next step; ({name: measurements}, note)."""
    out, notes = {}, []
    b = world.bodies
    n = b.capacity
    h = config.substep_dt

    # --- K: solver-body prepare and writeback ------------------------------
    k_in = (b, world.gravity[None], h)
    got = kk.prepare_bodies(*k_in)
    err_k = 0.0
    for name, x, y in zip(("state", "inv_mass", "inv_inertia", "solve_mask", "table"), got,
                          kk.prepare_bodies_twin(*k_in)):
        err_k = max(err_k, compare(f"prepare_bodies {name}", x, y))
    moved_state = kc.integrate_bodies(
        kc.integrate_bodies(got[0], got[4], h, kc.VELOCITIES), got[4], h, kc.POSITIONS)
    wb_out = kk.writeback_bodies(b, moved_state)
    for name, x, y in zip(("pos", "quat", "lin_vel", "ang_vel", "force", "torque"), wb_out,
                          kk.writeback_bodies_twin(b, moved_state)):
        err_k = max(err_k, compare(f"writeback_bodies {name}", x, y))

    def run_k(f_prep, f_wb):
        f_prep(*k_in)
        f_wb(b, moved_state)

    out["body_pass"] = measured(
        err_k, lambda: run_k(kk.prepare_bodies, kk.writeback_bodies),
        lambda: run_k(kk.prepare_bodies_twin, kk.writeback_bodies_twin),
        nbytes(b.body_type, b.locked_axes, b.active, b.sleeping, b.gyroscopic, b.quat,
               b.inv_inertia, b.lin_vel, b.ang_vel, b.force, b.torque, b.const_force,
               b.const_local_force, b.const_torque, b.const_local_torque, b.const_lin_acc,
               b.const_local_lin_acc, b.const_ang_acc, b.const_local_ang_acc, b.inv_mass,
               b.gravity_scale, b.lin_damping, b.ang_damping, b.max_lin_speed, b.max_ang_speed,
               world.gravity, *got)
        + nbytes(moved_state, b.pos, b.quat, b.com, b.lin_vel, b.ang_vel, b.active, b.sleeping,
                 b.body_type, *wb_out),
        330 * n,
    )

    # --- L: compaction, global pass, joint probe, keys ---------------------
    w2 = bp_m.update_aabbs(world, config)
    g = bp_m.grid_entries(w2, config)
    bits, rank = kb.grid_sweep(g.skey, g.sf, g.si, g.window)
    l_in = bp_m.compaction_args(w2, g, bits, rank)
    pairs = kl.compact_pairs(*l_in)
    for name, x, y in zip(kl.Pairs._fields, pairs, kl.compact_pairs_twin(*l_in)):
        compare(f"compact_pairs {name}", x, y)
    c_cap, m = w2.contacts.capacity, w2.colliders.capacity
    g_cap, j_keys = l_in[6].shape[0], l_in[9]
    shifts = torch.arange(g.window, dtype=torch.int32, device=bits.device)
    cand = ((bits[:, None] >> shifts[None, :]) & 1) != 0
    out["compact_pairs"] = measured(
        0.0, lambda: kl.compact_pairs(*l_in), lambda: kl.compact_pairs_twin(*l_in),
        nbytes(bits, rank, g.skey, l_in[3], *l_in[5], l_in[6], l_in[7], l_in[8], j_keys, *pairs),
        bits.numel() + 20 * g_cap * m
        + c_cap * (4 + 2 * math.ceil(math.log2(j_keys.numel() + 1))),
    )
    # The call the kernel replaces: the nonzero of the candidate bit matrix.
    out["compact_pairs"]["nonzero_ms"] = cuda_ms(lambda: torch.nonzero(cand))
    notes.append(f"{int(pairs.num_pairs)} pairs, {int(cand.sum())} grid candidates, "
                 f"{int((j_keys != kl.NO_JOINT_KEY).sum())} disabled joint keys")

    # --- J: island table, labels, sleep update -----------------------------
    src, skey, order = sleep_m.island_incidences(b, world.contacts, world.joints)
    rank_i = kr.run_rank(skey)
    j_in = (src, skey, order, rank_i, n)
    table, overflow = kj.island_table(*j_in)
    table_t, overflow_t = kj.island_table_twin(*j_in)
    compare("island_table neighbors", table, table_t)
    compare("island_table overflow", overflow, overflow_t)
    label = kj.island_labels(table)
    compare("island_labels", label, kj.island_labels_twin(table))
    lin_t = config.sleep_linear_threshold * config.length_unit
    params = kj.SleepParams(lin_t * lin_t, config.sleep_angular_threshold ** 2, config.dt,
                            config.time_to_sleep)
    s_in = (b, label, overflow, params)
    slept = kj.sleep_update(*s_in)
    for name, x, y in zip(("sleeping", "sleep_timer", "lin_vel", "ang_vel"), slept,
                          kj.sleep_update_twin(*s_in)):
        compare(f"sleep_update {name}", x, y)
    more, short = island_rounds_to_converge(table, label)

    def run_j(f_table, f_labels, f_sleep):
        tab, ovf = f_table(*j_in)
        f_sleep(b, f_labels(tab), ovf, params)

    out["islands"] = measured(
        0.0, lambda: run_j(kj.island_table, kj.island_labels, kj.sleep_update),
        lambda: run_j(kj.island_table_twin, kj.island_labels_twin, kj.sleep_update_twin),
        nbytes(src, skey, order, rank_i, label, overflow, b.island, b.sleeping, b.active,
               b.body_type, b.sleep_disabled, b.pos, b.sleep_pos, b.quat, b.sleep_quat,
               b.lin_vel, b.ang_vel, b.sleep_timer, *slept),
        2 * src.numel() + kj.LABEL_ROUNDS * n * (kj.MAX_DEGREE + 2) + 40 * n,
    )
    notes.append(f"{len(torch.unique(label))} island labels, {int(overflow.sum())} table "
                 f"overflows; converged labels need {more} more rounds, {short} bodies short")

    # --- I: joint colours and velocities of one substep --------------------
    if world.joints.capacity > 0:
        p = prepare_step(world, config)
        jc, colors = p.jcon, config.max_colors
        r_in = (p.world.joints, p.world.bodies, p.s.inv_mass, p.s.inv_inertia, p.s.solve_mask)
        for name, x, y in zip(("data", "mask", "dyn_a", "dyn_b"), ki.joint_rows(*r_in),
                              ki.joint_rows_twin(*r_in)):
            compare(f"joint_rows {name}", x, y)
        state0 = kc.integrate_bodies(
            kc.integrate_bodies(p.s.state, p.table, h, kc.VELOCITIES), p.table, h, kc.POSITIONS)

        def substep(twin, upto=None, velocities=True, state=None, lam=None):
            return joint_substep(jc, colors, h, twin, state0.clone() if state is None else state,
                                 jc.lam.clone() if lam is None else lam, upto, velocities)

        proper_k = substep(False, upto=colors - 1, velocities=False)
        proper_t = substep(True, upto=colors - 1, velocities=False)
        compare("joint_color proper colours state", proper_k[0], proper_t[0])
        compare("joint_color proper colours lam", proper_k[1], proper_t[1])
        full_k, full_t = substep(False), substep(False)
        if not (torch.equal(full_k[0], full_t[0]) and torch.equal(full_k[1], full_t[1])):
            raise AssertionError("solve_joints: two runs of a substep differ")
        full_t = substep(True)
        err_i = 0.0
        for what, x, y in (("state", full_k[0], full_t[0]), ("lam", full_k[1], full_t[1])):
            err_i = max(err_i, compare(f"solve_joints {what}", x, y,
                                       TOL_I_REL * max(1.0, float(y.abs().max()))))
        scratch_k, scratch_t = state0.clone(), state0.clone()
        lam_k, lam_t = jc.lam.clone(), jc.lam.clone()
        active = int((jc.mask > 0).sum())
        j_n = jc.mask.shape[0]
        out["solve_joints"] = measured(
            err_i, lambda: substep(False, state=scratch_k, lam=lam_k),
            lambda: substep(True, state=scratch_t, lam=lam_t),
            # The state and the totals in and out, the rows, the orders and
            # the delta pose before the first colour (7 floats a body).
            2 * nbytes(state0, jc.lam) + nbytes(jc.data, jc.jtype, jc.body_a, jc.body_b,
                                                jc.color, jc.mask, jc.ovf_order, jc.ovf_key,
                                                jc.damp_order, jc.damp_key) + 4 * 7 * n,
            1500 * active + 60 * j_n + 40 * n,
        )
        notes.append(f"{active} joints solved, {int((jc.color_j == colors - 1).sum())} in the "
                     f"overflow colour")
        # Two colours: half of every chain's joints share bodies in the
        # overflow colour. Error only; the times are the path's.
        jc2 = xpbd_m.prepare_joints(p.world, p.s, config.replace(max_colors=2))
        got2, want2 = (joint_substep(jc2, 2, h, twin, state0.clone(), jc2.lam.clone())
                       for twin in (False, True))
        for what, x, y in zip(("state", "lam"), got2, want2):
            out["solve_joints"]["max_abs_err"] = max(
                out["solve_joints"]["max_abs_err"],
                compare(f"solve_joints 2 colours {what}", x, y,
                        TOL_I_REL * max(1.0, float(y.abs().max()))))
        notes.append(f"at 2 colours {int((jc2.color_j == 1).sum())} in the overflow colour")
    return out, "; ".join(notes)


def hold_manifold(tag, got, want):
    """A pair kernel's manifolds against its plain version's: feature ids and
    counts equal, floats within ``TOL_MNO``; returns the largest float
    difference."""
    compare(f"{tag} feature ids", got[4], want[4])
    compare(f"{tag} counts", got[5], want[5])
    return max(compare(tag, x, y, TOL_MNO) for x, y in zip(got[:4], want[:4]))


def pair_work(name, kind, inputs, out):
    """(bytes, operations) of one launch of pair kernel ``name``: each input
    and output once and each vertex a pool-backed shape reads (12 bytes);
    the operations of ``OPS_PER_PAIR`` and, for P and Q, of this launch's
    hull vertices."""
    k = inputs[0].shape[0]
    io = nbytes(*inputs[:6], *out)
    ops = OPS_PER_PAIR[name] * k
    if name in POOL_KERNELS:
        hulls = [inputs[5]] + ([inputs[2]] if name == "hull_manifold"
                               and kpq.HULL_PAIRS[kind][0] == ShapeType.CONVEX else [])
        verts = sum(int(h[:, 1].sum()) for h in hulls)
        io += 12 * verts
        ops += OPS_PER_HULL[name] * k * len(hulls) + OPS_PER_HULL_VERTEX[name] * verts
    return io, ops


def kernels_pairs(world, config, names, required=None):
    """The pair kernels ``names`` against their plain versions on every
    shape-pair bucket of ``world``'s next step; {name: measurements} of those
    with a bucket, and the bucket sizes. Fails if one of ``required``
    (default: all of ``names``) has none."""
    w2, pos, quat = bp_m.update_aabbs_and_poses(world, config)
    bp = bp_m.broad_phase(w2, config)
    col = w2.colliders
    buckets = [b for b in manifold_buckets(col.shape_type, col.params, pos, quat, bp.collider_a,
                                           bp.collider_b, bp.valid, config.shape_pairs,
                                           w2.convex_verts)
               if b.name in names]
    out = {}
    for name in names:
        mine = [b for b in buckets if b.name == name]
        if not mine and name in (names if required is None else required):
            raise AssertionError(f"{name}: no bucket of this world runs it")
        if not mine:
            continue
        err, io_bytes, ops = 0.0, 0, 0
        for b in mine:
            got = b.run()
            err = max(err, hold_manifold(f"{name} {b.pair}", got, b.run(twin=True)))
            work = pair_work(name, b.kind, b.inputs, got)
            io_bytes, ops = io_bytes + work[0], ops + work[1]

        def run_all(twin, mine=mine):
            for b in mine:
                b.run(twin=twin)

        out[name] = measured(err, lambda r=run_all: r(False), lambda r=run_all: r(True),
                             io_bytes, ops)
    sizes = {b.pair: b.slots.shape[0] for b in buckets}
    return out, sizes


def random_hulls(rng, k, blocks, start):
    """Params f32[k, 7] of ``k`` seeded pool-backed convex shapes whose
    vertices are appended to ``blocks`` from pool row ``start``: hulls of
    4-32 points on an ellipsoid, box hulls (round, radius 0.05, in half the
    cases), flat triangles and octahedra, in turn at random."""
    prm = np.zeros((k, 7), np.float32)
    row = start
    for i in range(k):
        kind, flat, r = int(rng.integers(0, 4)), 0.0, 0.0
        if kind == 0:
            p = rng.normal(size=(int(rng.integers(4, 33)), 3))
            p = p / np.linalg.norm(p, axis=1, keepdims=True) * rng.uniform(0.3, 0.7, 3)
        elif kind == 1:
            e = rng.uniform(0.25, 0.6, 3)
            p = np.asarray([(a * e[0], b * e[1], c * e[2])
                            for a in (-1, 1) for b in (-1, 1) for c in (-1, 1)])
            r = float(rng.choice([0.0, 0.05]))
        elif kind == 2:
            p = rng.uniform(-0.8, 0.8, (3, 3)) * np.asarray([1.0, 0.2, 1.0])
            flat = 1.0
        else:
            p = np.concatenate([np.eye(3), -np.eye(3)]) * rng.uniform(0.35, 0.6)
        p = (p - p.mean(0)).astype(np.float32)
        h = np.abs(p).max(0) + r
        prm[i] = (row, len(p), h[0], h[1], h[2], flat, r)
        blocks.append(p)
        row += len(p)
    return prm


def random_pair_inputs(pair, k, seed, device):
    """``k`` seeded random pairs of canonical ``pair`` on the card, as its
    bucket's kernel takes them: (pa, qa, prm_a, pb, qb, prm_b[, pool]), the
    params 3 lanes wide, or 7 with the vertex pool (32 zero rows at its
    end) for a pool-backed shape's pair. B lies 0.1-1.3 m from A in a random
    direction, or within 0.5 m above a half-space A."""
    rng = np.random.default_rng(seed + 10 * pair[0] + pair[1])
    wide = ShapeType.CONVEX in pair
    blocks = []

    def params(shape):
        if shape == ShapeType.CONVEX:
            return random_hulls(rng, k, blocks, sum(len(b) for b in blocks))
        p = np.zeros((k, 7 if wide else 3), np.float32)
        if shape == ShapeType.PLANE:
            p[:, 1] = 1.0
        elif shape == ShapeType.BOX:
            p[:, :3] = rng.uniform(0.2, 0.7, (k, 3))
        elif shape in (ShapeType.SPHERE, ShapeType.SEGMENT):
            p[:, 0] = rng.uniform(0.2, 0.8, k)
        else:
            p[:, 0], p[:, 1] = rng.uniform(0.2, 0.7, k), rng.uniform(0.2, 0.6, k)
        return p

    def quats(scale):
        q = rng.normal(size=(k, 4)) * scale
        q[:, 3] += 1.0
        return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)

    prm_a, prm_b = params(pair[0]), params(pair[1])
    pa = rng.uniform(-1.0, 1.0, (k, 3)).astype(np.float32)
    if pair[0] == ShapeType.PLANE:
        qa = quats(0.1)
        pb = pa + rng.uniform(0.0, 0.5, (k, 1)) * np.asarray([0.0, 1.0, 0.0])
    else:
        qa = quats(0.8)
        d = rng.normal(size=(k, 3))
        pb = pa + d / np.linalg.norm(d, axis=1, keepdims=True) * rng.uniform(0.1, 1.3, (k, 1))
    out = [torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
           for x in (pa, qa, prm_a, pb, quats(0.8), prm_b)]
    if wide:
        pool = np.concatenate(blocks + [np.zeros((32, 3), np.float32)])
        out.append(torch.from_numpy(pool).to(device))
    return out


def kernels_random_pairs(device):
    """Kernels M and O's segment instances, P and Q against their plain
    versions on ``RANDOM_PAIRS`` seeded random pairs of each of the 15
    canonical pairs of segments and pool-backed convex shapes. Returns
    {name: largest difference} and Q's measurements (Q's only inputs here
    and on the reference scenes' hull stack)."""
    errs = {}
    q_measured = None
    new_pairs = sorted(p for p in PAIR_KERNELS
                       if ShapeType.SEGMENT in p or ShapeType.CONVEX in p)
    for pair in new_pairs:
        module, name, kind = PAIR_KERNELS[pair]
        args = random_pair_inputs(pair, RANDOM_PAIRS, 0, device)
        kernel = getattr(module, name)
        twin = getattr(module, name + "_twin")
        got = kernel(kind, *args)
        err = hold_manifold(f"{name} {pair} random", got, twin(kind, *args))
        errs[name] = max(errs.get(name, 0.0), err)
        if name == "plane_hull_manifold":
            work = pair_work(name, kind, args, got)
            q_measured = measured(err, lambda: kernel(kind, *args), lambda: twin(kind, *args),
                                  *work)
    say("kernels", f"[random pairs, {RANDOM_PAIRS} of each of {len(new_pairs)} canonical pairs "
        f"{new_pairs}] largest difference from the plain versions: "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    return errs, q_measured


def show(tag, out):
    return f"[{tag}] " + "; ".join(
        f"{k} err {v['max_abs_err']:.3g} kernel {v['ms']:.4f} ms twin {v['plain_ms']:.4f} ms "
        f"bound {v['bound_ms']:.5f} ms ({v['bound_by']})" for k, v in out.items())


def pyramid(device, dim3_depth=False, per_box=PYRAMID_CONTACTS_PER_BOX):
    n = PYRAMID_BASE * (PYRAMID_BASE + 1) // 2 + 1
    return scenes.box_pyramid(
        PYRAMID_BASE, dim3_depth=dim3_depth, max_contacts=per_box * n, device=device,
    )


def hinges(device):
    n = HINGE_BLOCKS * HINGE_ROWS * HINGE_COLS + 1
    return scenes.hinge_blocks(HINGE_BLOCKS, HINGE_ROWS, HINGE_COLS,
                               max_contacts=HINGE_SLOTS_PER_BOX * n, device=device)


def anchor_gap(world):
    """The largest distance between the two world anchors of an active
    joint, in metres."""
    b, j = world.bodies, world.joints
    a, c = j.body_a.long(), j.body_b.long()
    pa = b.pos[a] + quat_m.rotate(b.quat[a], j.frame_pos_a)
    pb = b.pos[c] + quat_m.rotate(b.quat[c], j.frame_pos_b)
    gap = torch.where(j.active, (pa - pb).norm(dim=-1), 0.0)
    return float(gap.max())


def probe_capacity(device):
    """What the pyramid's first steps drop at each contact capacity: pairs
    (no slot) and constraints (no room in their colour's bucket)."""
    found = []
    for per_box in PROBE_CONTACTS_PER_BOX:
        world, _ = pyramid(device, per_box=per_box)
        pairs = rows = most = 0
        for _ in range(PROBE_STEPS):
            world, diag = physics_step(world, PILE_CONFIG, return_diagnostics=True)
            pairs = max(pairs, int(diag["dropped_pairs"]))
            rows = max(rows, int(diag["overflow_dropped"]))
            most = max(most, int(diag["num_overflow"]))
        found.append(f"{per_box} N = {world.contacts.capacity} slots: dropped pairs {pairs}, "
                     f"overflow drops {rows}, most rows in the overflow colour {most}")
    say("pyramid", f"first {PROBE_STEPS} steps at base {PYRAMID_BASE}: " + "; ".join(found))


def phase_kernels(device):
    """Each of A-H against its twin on the same inputs, at three states of
    the main paths: the pile after ``SETTLE_STEPS`` steps, the base-100
    pyramid (bodies with locked axes) after ``PYRAMID_OVERFLOW_STEPS`` steps,
    when its overflow colour is full, and after ``PYRAMID_KERNEL_STEPS``.
    J, K and L at the pile's state, I, J, K and L at the hinged boxes'
    after ``HINGE_KERNEL_STEPS``, and M, N and O on the mixed shapes' after
    ``SHAPES_KERNEL_STEPS``. Returns {name: measurements}; the error is
    the largest of all states; the times and the bound of A-H are the
    pile's, with the pyramid's beside them as ``pyramid_*``; those of I-L
    are the hinged boxes', with the pile's beside them as ``pile_*``."""
    config = PILE_CONFIG
    world = pile(N_CUBES, device)
    for _ in range(SETTLE_STEPS):
        world = physics_step(world, config)
    torch.cuda.synchronize()
    out, note = kernels_abcd(world, config, bounce=True)
    efgh, note2 = kernels_efgh(world, config)
    out.update(efgh)
    jkl, note3 = kernels_ijkl(world, config)
    out.update(jkl)
    torch.cuda.synchronize()
    say("kernels", show(f"pile {N_CUBES} after {SETTLE_STEPS} steps", out)
        + f" ({note}; {note2}; {note3})")

    world, _ = pyramid(device)
    steps = 0
    for upto in (PYRAMID_OVERFLOW_STEPS, PYRAMID_KERNEL_STEPS):
        for _ in range(upto - steps):
            world = physics_step(world, config)
        steps = upto
        torch.cuda.synchronize()
        pyr, note = kernels_abcd(world, config, bounce=False)
        efgh, note2 = kernels_efgh(world, config)
        pyr.update(efgh)
        torch.cuda.synchronize()
        say("kernels", show(f"pyramid base {PYRAMID_BASE} after {steps} steps", pyr)
            + f" ({note}; {note2})")
        for name, v in pyr.items():
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"], v["max_abs_err"])
            for key in ("ms", "plain_ms", "bound_ms"):
                out[name]["pyramid_" + key] = v[key]

    # The hinged boxes: I, J, K, L at this path's shapes, which the line's
    # times are for; the pile's stand beside them as pile_*.
    world, _ = hinges(device)
    for _ in range(HINGE_KERNEL_STEPS):
        world = physics_step(world, config)
    torch.cuda.synchronize()
    ijkl, note = kernels_ijkl(world, config)
    torch.cuda.synchronize()
    say("kernels", show(f"hinges {HINGE_BLOCKS} x {HINGE_ROWS} x {HINGE_COLS} after {HINGE_KERNEL_STEPS} steps",
                        ijkl) + f" ({note})")
    for name, v in ijkl.items():
        if name in out:
            v["max_abs_err"] = max(v["max_abs_err"], out[name]["max_abs_err"])
            for key in ("ms", "plain_ms", "bound_ms", "nonzero_ms"):
                if key in out[name]:
                    v["pile_" + key] = out[name][key]
        out[name] = v

    # The mixed shapes: M, N, O on every bucket of their pairs.
    world, _ = mixed_shapes(device)
    for _ in range(SHAPES_KERNEL_STEPS):
        world = physics_step(world, SHAPES_CONFIG)
    torch.cuda.synchronize()
    mno, sizes = kernels_pairs(world, SHAPES_CONFIG,
                               ("convex_manifold", "round_manifold", "plane_patch_manifold"))
    torch.cuda.synchronize()
    say("kernels", show(f"mixed shapes {SHAPES_N} after {SHAPES_KERNEL_STEPS} steps", mno)
        + f" (pairs per bucket: {sizes})")
    # A-L on the same state: the first with a centre of mass off the body's
    # origin (the cones) and unequal principal inertia. Errors only; their
    # times are the other paths'.
    al, note = kernels_abcd(world, SHAPES_CONFIG, bounce=False)
    efgh, note2 = kernels_efgh(world, SHAPES_CONFIG)
    al.update(efgh)
    jkl, _ = kernels_ijkl(world, SHAPES_CONFIG)
    al.update(jkl)
    torch.cuda.synchronize()
    say("kernels", f"[mixed shapes {SHAPES_N} after {SHAPES_KERNEL_STEPS} steps] A-L against "
        "their twins: " + ", ".join(f"{k} err {v['max_abs_err']:.3g}" for k, v in al.items())
        + f" ({note}; {note2})")
    for name, v in al.items():
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], v["max_abs_err"])
    out.update(mno)

    # The terrain: P on every X/CONVEX bucket (its times are this state's),
    # and A-N on the same state, errors only.
    world, _ = terrain(device)
    for _ in range(TERRAIN_KERNEL_STEPS):
        world = physics_step(world, TERRAIN_CONFIG)
    torch.cuda.synchronize()
    mnp, sizes = kernels_pairs(world, TERRAIN_CONFIG,
                               ("convex_manifold", "round_manifold", "hull_manifold"),
                               required=("hull_manifold",))
    torch.cuda.synchronize()
    say("kernels", show(f"terrain {TERRAIN_N} after {TERRAIN_KERNEL_STEPS} steps", mnp)
        + f" (pairs per bucket: {sizes})")
    al, note = kernels_abcd(world, TERRAIN_CONFIG, bounce=False)
    efgh, note2 = kernels_efgh(world, TERRAIN_CONFIG)
    al.update(efgh)
    jkl, _ = kernels_ijkl(world, TERRAIN_CONFIG)
    al.update(jkl)
    al.update({k: mnp[k] for k in ("convex_manifold", "round_manifold") if k in mnp})
    torch.cuda.synchronize()
    say("kernels", f"[terrain {TERRAIN_N} after {TERRAIN_KERNEL_STEPS} steps] A-N against "
        "their twins: " + ", ".join(f"{k} err {v['max_abs_err']:.3g}" for k, v in al.items())
        + f" ({note}; {note2})")
    for name, v in al.items():
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], v["max_abs_err"])
    out["hull_manifold"] = mnp["hull_manifold"]

    # 4,096 random pairs of each new canonical pair: M's and O's segment
    # instances, P, and Q, whose times are these pairs'.
    errs, q_measured = kernels_random_pairs(device)
    for name, err in errs.items():
        out.setdefault(name, q_measured if name == "plane_hull_manifold" else {})
        out[name]["max_abs_err"] = max(out[name].get("max_abs_err", 0.0), err)
    return out


def golden_drift(name, world):
    """Drift f64[frames] of ``world``'s positions from ``tests/golden/name``
    over ``GOLDEN_STEPS`` steps, one value every ``GOLDEN_STRIDE``."""
    golden = np.load(os.path.join(ROOT, "tests", "golden", f"{name}.npz"))["pos"]
    drift = []
    for i in range(GOLDEN_STEPS):
        world = physics_step(world, GOLDEN_CONFIG)
        if (i + 1) % GOLDEN_STRIDE == 0:
            frame = golden[len(drift)]
            drift.append(float(np.abs(world.bodies.pos.cpu().numpy() - frame).max()))
    return np.asarray(drift)


def phase_golden(device):
    drift = golden_drift("stack3", scenes.stack3(device=device)[0])
    if not drift.max() <= GOLDEN_TOL:
        raise AssertionError(f"stack3: drift {drift.max()} > {GOLDEN_TOL} from the golden")
    say("golden", f"stack3 {GOLDEN_STEPS} steps, {drift.shape[0]} frames, max drift "
        f"{drift.max():.3g} (limit {GOLDEN_TOL})")
    drift = golden_drift("falling_hinges", scenes.falling_hinges(10, 4, device=device)[0])
    held = drift[:HINGE_GOLDEN_HELD_STEPS // GOLDEN_STRIDE]
    parted = np.nonzero(drift > GOLDEN_TOL)[0]
    say("golden", f"falling_hinges 10 x 4, {GOLDEN_STEPS} steps: max drift {held.max():.3g} "
        f"over the frames to step {HINGE_GOLDEN_HELD_STEPS} (limit {GOLDEN_TOL}); first "
        f"frame beyond the limit: step "
        f"{(parted[0] + 1) * GOLDEN_STRIDE if parted.size else None}; drift every 50 steps: "
        + ", ".join(f"{d:.3g}" for d in drift[4::5]))
    if not held.max() <= GOLDEN_TOL:
        raise AssertionError(f"falling_hinges: drift {held.max()} > {GOLDEN_TOL} from the "
                             f"golden within {HINGE_GOLDEN_HELD_STEPS} steps")


def moved(start, world, ids):
    """(farthest sideways move of any box of ``ids`` in x or z, move of the
    highest box in y) since ``start``, in metres."""
    idx = torch.tensor(ids, device=start.device)
    p0, p1 = start[idx], world.bodies.pos[idx]
    apex = int(torch.argmax(p0[:, 1]))
    return (float((p1[:, [0, 2]] - p0[:, [0, 2]]).abs().max()),
            float((p1[apex, 1] - p0[apex, 1]).abs()))


def drive(what, world, config, steps, smi, n_boxes, timed_from=0, watch=None, every10=None,
          buckets=None, each_step=None):
    """``steps`` steps of ``world`` through ``physics_step`` with diagnostics.
    Fails on a dropped pair, an overflow drop, a non-finite state or launch
    counts other than what the full steps imply; prints the rates, and with
    ``watch=(start, ids, max sideways, max apex)`` how far the boxes have moved
    every 10 steps, held to those limits. ``every10(world)`` is called every
    10 steps, outside the timed steps, and ``each_step(i, world, diag)``
    after every step. ``buckets``, a dict, gathers each shape pair's bucket
    sizes, one per full step.
    Returns ``(world, launches)``."""
    series = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0_sim = float(world.time)
    max_dropped = max_overflow = max_num_overflow = 0
    expect = dict.fromkeys(kernels.WRAPPERS, 0)
    full_s, timed_s, timed_full = [], [], 0
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        world, diag = physics_step(world, config, return_diagnostics=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if i >= timed_from:
            timed_s.append(dt)
            timed_full += int(diag["stepped"])
        max_dropped = max(max_dropped, int(diag["dropped_pairs"]))
        max_overflow = max(max_overflow, int(diag["overflow_dropped"]))
        max_num_overflow = max(max_num_overflow, int(diag["num_overflow"]))
        if watch is not None and (i + 1) % 10 == 0:
            series.append((i + 1,) + moved(watch[0], world, watch[1]))
        if every10 is not None and (i + 1) % 10 == 0:
            every10(world)
        if each_step is not None:
            each_step(i, world, diag)
        if diag["stepped"]:
            full_s.append(dt)
            for pair, n in diag["manifold_pairs"].items():
                expect[PAIR_KERNELS[pair][1]] += int(n > 0)
                if buckets is not None:
                    buckets.setdefault(pair, []).append(n)
            expect["swept_toi"] += sum(int(n > 0) for n in diag["swept_pairs"].values())
            for name, per_step in STEP_LAUNCHES.items():
                expect[name] += per_step(config, world.joints.capacity > 0)
    got = kernels.launches()
    peak = torch.cuda.max_memory_allocated()

    b = world.bodies
    for name in ("pos", "quat", "lin_vel", "ang_vel"):
        if not bool(torch.isfinite(getattr(b, name)).all()):
            raise AssertionError(f"{what}: non-finite {name}")
    if bool(world.diverged):
        raise AssertionError(f"{what}: world diverged")
    if max_dropped or max_overflow:
        raise AssertionError(
            f"{what}: dropped pairs {max_dropped}, overflow drops {max_overflow}"
        )
    sim = float(world.time) - t0_sim
    if not math.isclose(sim, steps * config.dt, rel_tol=1e-4):
        raise AssertionError(f"{what}: sim time {sim} != {steps} * dt")
    if got != expect:
        raise AssertionError(f"{what}: launches {got} != expected {expect}")
    if any(got[name] == 0 for name in expect if expect[name] > 0):
        raise AssertionError(f"{what}: a kernel of the path never launched: {got}")
    # A full step runs the whole pipeline; once the scene sleeps the
    # early-out skips the rest, so both rates are reported.
    full_ms = 1e3 * sum(full_s) / len(full_s)
    timed_ms = 1e3 * sum(timed_s) / len(timed_s)
    say(what, f"{n_boxes} bodies, {world.contacts.capacity} contact slots, "
        f"{steps} steps: {len(full_s)} full steps at {full_ms:.2f} ms/step "
        f"(median {1e3 * sorted(full_s)[len(full_s) // 2]:.2f}), "
        f"{1e3 * n_boxes / full_ms:.0f} body-steps/s per full step; last "
        f"{steps - timed_from} steps ({timed_full} full): {timed_ms:.2f} ms/step, "
        f"{1e3 * n_boxes / timed_ms:.0f} body-steps/s; peak {peak / 2**20:.0f} MiB; "
        f"end: {int(diag['num_sleeping'])} asleep; dropped 0, overflow drops 0, "
        f"most rows in the overflow colour {max_num_overflow}; launches {got} [{smi}]")
    if series:
        say(what, "step: sideways m, apex m: " + "; ".join(
            f"{i}: {dx:.3f}, {dy:.3f}" for i, dx, dy in series))
        worst = (max(r[1] for r in series), max(r[2] for r in series))
        if not (worst[0] <= watch[2] and worst[1] <= watch[3]):
            raise AssertionError(f"{what}: moved {worst} m (sideways, apex), "
                                 f"limits {watch[2:]}")
    return world, got


@contextlib.contextmanager
def plain_versions():
    """Within the block every wrapper the pipeline calls is its plain PyTorch
    version, on whatever device the tensors lie; no kernel is launched."""
    def solve_color_plain(mode, color, state, data, imp, bucket_a, bucket_b, bucket_valid,
                          relax, ovf_order, ovf_key, params):
        return kd.solve_color_twin(mode, color, state, data, imp, bucket_a, bucket_b,
                                   bucket_valid, relax, params)

    def joint_color_plain(color, last, state, data, lam, jtype, body_a, body_b, jcolor, mask,
                          ovf_order, ovf_key, hh):
        return ki.joint_color_twin(color, state, data, lam, jtype, body_a, body_b, jcolor,
                                   mask, hh)

    def joint_velocities_plain(state, pre, data, body_a, body_b, mask, damp_order, damp_key, h):
        return ki.joint_velocities_twin(state, pre, data, body_a, body_b, mask, h)

    swaps = [
        (ka, "box_manifold", ka.box_manifold_twin), (kb, "grid_sweep", kb.grid_sweep_twin),
        (kc, "integrate_bodies", kc.integrate_bodies_twin),
        (kd, "solve_color", solve_color_plain),
        (ke, "collider_aabbs", ke.collider_aabbs_twin), (ke, "cell_keys", ke.cell_keys_twin),
        (kf, "contact_join", kf.contact_join_twin), (kf, "contact_rows", kf.contact_rows_twin),
        (kg, "color_edges", kg.color_edges_twin), (kg, "bucket_edges", kg.bucket_edges_twin),
        (kh, "constraint_flags", kh.constraint_flags_twin),
        (kh, "pack_constraints", kh.pack_constraints_twin),
        (sleep_m, "run_rank", kr.run_rank_twin),
        (ki, "joint_rows", ki.joint_rows_twin), (ki, "joint_color", joint_color_plain),
        (ki, "joint_velocities", joint_velocities_plain),
        (kj, "island_table", kj.island_table_twin), (kj, "island_labels", kj.island_labels_twin),
        (kj, "sleep_update", kj.sleep_update_twin),
        (kk, "prepare_bodies", kk.prepare_bodies_twin),
        (kk, "writeback_bodies", kk.writeback_bodies_twin),
        (kl, "compact_pairs", kl.compact_pairs_twin),
        (km, "convex_manifold", km.convex_manifold_twin),
        (kn, "round_manifold", kn.round_manifold_twin),
        (km, "plane_patch_manifold", km.plane_patch_manifold_twin),
        (kpq, "hull_manifold", kpq.hull_manifold_twin),
        (kpq, "plane_hull_manifold", kpq.plane_hull_manifold_twin),
        (kccd, "swept_toi", kccd.swept_toi_twin), (ks, "shape_cast", ks.shape_cast_twin),
        (kt, "ray_cast", kt.ray_cast_twin),
        (kaf, "point_3d", lambda *a: kaf.point_3d_twin(*a[:10])),
        (kag, "ray_cast_grid", lambda rays, md, solid, tabs, cells=64, window=32, work=None:
         kag.ray_cast_grid_twin(rays, md, solid, tabs, cells, window)),
        (kah, "aabb_overlap", kah.aabb_overlap_twin),
        (ks, "shape_overlap", lambda *a: ks.shape_overlap_twin(*a[:-1], a[-1].hit)),
        (ks, "shape_manifold", ks.shape_manifold_twin),
        (kai, "toi_pair", lambda pair, idx, tabs, hit, t, iters=kai.ROUNDS, rounds=None:
         kai.toi_pair_twin(pair, idx, tabs, hit, t, iters)),
    ]
    kept = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, plain in swaps:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for mod, name, fn in kept:
            setattr(mod, name, fn)


def trajectory(world, config, steps, ids):
    """Positions f32[steps, len(ids), 3] of the bodies ``ids`` after each of
    ``steps`` steps, and the rows in the overflow colour at each step:
    contacts, and joints when the world has joint slots."""
    idx = torch.tensor(ids, device=world.bodies.pos.device)
    frames, overflow = [], []
    for _ in range(steps):
        world, diag = physics_step(world, config, return_diagnostics=True)
        frames.append(world.bodies.pos[idx].clone())
        rows = (int(diag["num_overflow"]),)
        if world.joints.capacity > 0:
            rows += (int((world.joints.color == config.max_colors - 1).sum()),)
        overflow.append(rows)
    return torch.stack(frames), overflow


def on_plain_versions(world, config, steps, ids):
    """``trajectory`` with every kernel replaced by its plain version; fails
    if a kernel was launched. Returns (positions, overflow rows, seconds)."""
    kernels.reset_launches()
    t0 = time.perf_counter()
    with plain_versions():
        frames, overflow = trajectory(world, config, steps, ids)
    seconds = time.perf_counter() - t0
    if any(kernels.launches().values()):
        raise AssertionError(f"plain path: kernels were launched: {kernels.launches()}")
    return frames, overflow, seconds


def phase_plain_path(device):
    """The base-100 pyramid from its start through ``PLAIN_STEPS`` steps,
    once on the kernels and once on their plain versions alone (on the card,
    no kernel launched). The two must agree: the rows in the overflow colour
    in the first ``PLAIN_EXACT_STEPS`` steps, every box's position within
    ``PLAIN_TOL`` over the first ``PLAIN_TIGHT_STEPS``, the apex's height
    within ``PLAIN_APEX_TOL`` throughout. What the pyramid does in these
    steps (it sags while the overflow colour empties) is thus the pipeline's
    arithmetic and not a kernel's."""
    config = PILE_CONFIG
    world, ids = pyramid(device)
    start = world.bodies.pos[torch.tensor(ids, device=device)]
    apex = int(torch.argmax(start[:, 1]))
    on_kernels, overflow = trajectory(world, config, PLAIN_STEPS, ids)
    on_plain, overflow_plain, seconds = on_plain_versions(world, config, PLAIN_STEPS, ids)
    overflow = [r[0] for r in overflow]
    overflow_plain = [r[0] for r in overflow_plain]
    diff = (on_kernels - on_plain).abs().amax(dim=(1, 2))
    sag_k = on_kernels[:, apex, 1] - start[apex, 1]
    sag_p = on_plain[:, apex, 1] - start[apex, 1]
    apart = (sag_k - sag_p).abs()
    say("plain path", f"pyramid base {PYRAMID_BASE}, {PLAIN_STEPS} steps on the kernels and on "
        f"their plain versions ({seconds:.1f} s): largest difference of any box's position in "
        f"the first {PLAIN_TIGHT_STEPS} steps {float(diff[:PLAIN_TIGHT_STEPS].max()):.3g} m "
        f"(limit {PLAIN_TOL}), of the apex's height in all {float(apart.max()):.3g} m (limit "
        f"{PLAIN_APEX_TOL}); step: apex y on kernels, on plain versions (m), largest "
        f"difference of any box (m), rows in the overflow colour on kernels, on plain "
        f"versions: " + "; ".join(
            f"{i + 1}: {float(sag_k[i]):.4f}, {float(sag_p[i]):.4f}, {float(diff[i]):.2g}, "
            f"{overflow[i]}, {overflow_plain[i]}" for i in range(4, PLAIN_STEPS, 5)))
    if overflow[:PLAIN_EXACT_STEPS] != overflow_plain[:PLAIN_EXACT_STEPS]:
        raise AssertionError(f"plain path: rows in the overflow colour differ in the first "
                             f"{PLAIN_EXACT_STEPS} steps: {overflow} against {overflow_plain}")
    if not float(diff[:PLAIN_TIGHT_STEPS].max()) <= PLAIN_TOL:
        raise AssertionError(f"plain path: a box is {float(diff[:PLAIN_TIGHT_STEPS].max())} m "
                             f"from its place on the plain versions within "
                             f"{PLAIN_TIGHT_STEPS} steps (limit {PLAIN_TOL})")
    if not float(apart.max()) <= PLAIN_APEX_TOL:
        raise AssertionError(f"plain path: the apexes part by {float(apart.max())} m "
                             f"(limit {PLAIN_APEX_TOL})")


def phase_hinges_plain_path(device):
    """The full-width hinged boxes from their start through
    ``HINGE_PLAIN_STEPS`` steps on the kernels and on their plain versions
    alone: the rows in the overflow colour (contacts and joints) equal for
    ``PLAIN_EXACT_STEPS`` steps, every box within ``PLAIN_TOL`` for
    ``PLAIN_TIGHT_STEPS``."""
    config = PILE_CONFIG
    world, ids = hinges(device)
    on_kernels, overflow = trajectory(world, config, HINGE_PLAIN_STEPS, ids)
    on_plain, overflow_plain, seconds = on_plain_versions(world, config, HINGE_PLAIN_STEPS, ids)
    diff = (on_kernels - on_plain).abs().amax(dim=(1, 2))
    say("plain path", f"hinges {HINGE_BLOCKS} x {HINGE_ROWS} x {HINGE_COLS}, {HINGE_PLAIN_STEPS} steps on the "
        f"kernels and on their plain versions ({seconds:.1f} s): largest difference of any "
        f"box's position in the first {PLAIN_TIGHT_STEPS} steps "
        f"{float(diff[:PLAIN_TIGHT_STEPS].max()):.3g} m (limit {PLAIN_TOL}), in all "
        f"{float(diff.max()):.3g} m; step: largest difference (m), overflow rows (contacts, "
        f"joints) on kernels, on plain versions: " + "; ".join(
            f"{i + 1}: {float(diff[i]):.2g}, {overflow[i]}, {overflow_plain[i]}"
            for i in range(1, HINGE_PLAIN_STEPS, 2)))
    if overflow[:PLAIN_EXACT_STEPS] != overflow_plain[:PLAIN_EXACT_STEPS]:
        raise AssertionError(f"plain path: hinges' overflow rows differ in the first "
                             f"{PLAIN_EXACT_STEPS} steps: {overflow} against {overflow_plain}")
    if not float(diff[:PLAIN_TIGHT_STEPS].max()) <= PLAIN_TOL:
        raise AssertionError(f"plain path: a hinged box is "
                             f"{float(diff[:PLAIN_TIGHT_STEPS].max())} m from its place on the "
                             f"plain versions within {PLAIN_TIGHT_STEPS} steps (limit {PLAIN_TOL})")


def phase_hinges(device, smi):
    """The hinged-box path at full width through ``physics_step``; fails
    unless every joint's anchors stay within ``HINGE_ANCHOR_TOL``. Returns
    the launch counts."""
    world, ids = hinges(device)
    gaps = []

    def check(w):
        gaps.append(anchor_gap(w))
        if not gaps[-1] <= HINGE_ANCHOR_TOL:
            raise AssertionError(f"hinges: joint anchors {gaps[-1]} m apart "
                                 f"(limit {HINGE_ANCHOR_TOL})")

    world, got = drive("hinges", world, PILE_CONFIG, HINGE_STEPS, smi, len(ids), every10=check)
    say("hinges", f"{int(world.joints.active.sum())} revolute joints; largest anchor separation "
        f"{max(gaps):.3g} m (limit {HINGE_ANCHOR_TOL}); every 10 steps: "
        + ", ".join(f"{g:.2g}" for g in gaps) + f"; lowest box y "
        f"{float(world.bodies.pos[1:, 1].min()):.3f} m")
    # Not a gate: one block of 334-box rows, as the reference behaves.
    n = HINGE_ROWS * WIDE_ROW_COLS + 1
    wide, _ = scenes.falling_hinges(HINGE_ROWS, WIDE_ROW_COLS,
                                    max_contacts=HINGE_SLOTS_PER_BOX * n, device=device)
    wide_gaps = []
    for _ in range(WIDE_ROW_STEPS):
        wide = physics_step(wide, PILE_CONFIG)
        wide_gaps.append(anchor_gap(wide))
    say("hinges", f"rows {WIDE_ROW_COLS} wide ({HINGE_ROWS} x {WIDE_ROW_COLS}), largest anchor "
        f"separation in each of the first {WIDE_ROW_STEPS} steps: "
        + ", ".join(f"{g:.3g}" for g in wide_gaps) + " m")
    return got


def mixed_shapes(device, n=SHAPES_N, per_row=SHAPES_PER_ROW):
    return scenes.many_shapes(n, per_row=per_row,
                              max_contacts=SHAPES_SLOTS_PER_BODY * (n + 1), device=device)


def phase_shapes(device, smi):
    """The mixed-shape path at full width through ``physics_step``: every
    shape pair of the scene launched, nothing below the plane. Returns the
    launch counts."""
    world, ids = mixed_shapes(device)
    buckets = {}
    world, got = drive("shapes", world, SHAPES_CONFIG, SHAPES_STEPS, smi, len(ids),
                       buckets=buckets)
    low = float(world.bodies.pos[1:, 1].min())
    if not low > 0.0:
        raise AssertionError(f"shapes: a body fell through the plane (lowest y {low})")
    seen = {pair: (len(v), max(v)) for pair, v in sorted(buckets.items())}
    say("shapes", f"{len(seen)} shape pairs launched (steps, most pairs in a step): {seen}; "
        f"lowest body y {low:.3f} m; {int(world.bodies.sleeping.sum())} asleep")
    missing = sorted(set(SHAPE_PAIRS) - set(seen))
    if missing:
        raise AssertionError(f"shapes: shape pairs never launched: {missing}")
    return got


def phase_shapes_plain_path(device):
    """``SHAPES_PLAIN_N`` mixed shapes from their start through
    ``PLAIN_STEPS`` steps on the kernels and on their plain versions alone
    (they fall and land on the plane): every body within ``PLAIN_TOL`` for
    ``PLAIN_TIGHT_STEPS`` steps. Then, landed on each other after
    ``SHAPES_KERNEL_STEPS`` steps, ``SHAPES_ONE_STEPS`` single steps, each
    from the kernels' state on the kernels and on the plain versions: every
    body within ``SHAPES_ONE_STEP_TOL`` after each. (Run on, the two
    trajectories of the landing pile part by centimetres within a few steps:
    the plain versions' unordered ``index_add_`` sums differ from run to run
    in the last bits, and the impacts amplify them.)"""
    world, ids = mixed_shapes(device, SHAPES_PLAIN_N, SHAPES_PLAIN_PER_ROW)
    on_kernels, _ = trajectory(world, SHAPES_CONFIG, PLAIN_STEPS, ids)
    on_plain, _, seconds = on_plain_versions(world, SHAPES_CONFIG, PLAIN_STEPS, ids)
    diff = (on_kernels - on_plain).abs().amax(dim=(1, 2))
    for _ in range(SHAPES_KERNEL_STEPS):
        world = physics_step(world, SHAPES_CONFIG)
    one = []
    for _ in range(SHAPES_ONE_STEPS):
        on_k = physics_step(world, SHAPES_CONFIG)
        kernels.reset_launches()
        with plain_versions():
            on_p = physics_step(world, SHAPES_CONFIG)
        if any(kernels.launches().values()):
            raise AssertionError(f"plain path: kernels were launched: {kernels.launches()}")
        one.append(float((on_k.bodies.pos - on_p.bodies.pos).abs().max()))
        world = on_k
    say("plain path", f"mixed shapes {SHAPES_PLAIN_N}, {PLAIN_STEPS} steps from the start on the "
        f"kernels and on their plain versions ({seconds:.1f} s): largest difference of any "
        f"body's position {float(diff.max()):.3g} m (limit {PLAIN_TOL} over the first "
        f"{PLAIN_TIGHT_STEPS}); after {SHAPES_KERNEL_STEPS} steps, one step from the same state "
        f"each: " + ", ".join(f"{d:.2g}" for d in one) + f" m (limit {SHAPES_ONE_STEP_TOL})")
    if not float(diff[:PLAIN_TIGHT_STEPS].max()) <= PLAIN_TOL:
        raise AssertionError(f"plain path: a mixed shape is {float(diff.max())} m from its "
                             f"place on the plain versions (limit {PLAIN_TOL})")
    if not max(one) <= SHAPES_ONE_STEP_TOL:
        raise AssertionError(f"plain path: one step of the landed mixed shapes parts by "
                             f"{max(one)} m (limit {SHAPES_ONE_STEP_TOL})")


def phase_cylinder_stack(device):
    """``tests/test_shapes_convex.py``'s stack of three cylinders and a cone,
    ``CYLINDER_STEPS`` steps on the kernels, held to that test's bounds."""
    world, stack, cone = scenes.cylinder_stack(device=device)
    kernels.reset_launches()
    for _ in range(CYLINDER_STEPS):
        world = physics_step(world, CYLINDER_CONFIG)
    got = kernels.launches()
    pos, quat = world.bodies.pos.cpu().numpy(), world.bodies.quat.cpu().numpy()
    sleeping = world.bodies.sleeping.cpu().numpy()
    heights = [abs(float(pos[b][1]) - (0.5 + k)) for k, b in enumerate(stack)]
    tilt = max(max(abs(float(quat[b][0])), abs(float(quat[b][2]))) for b in stack + [cone])
    say("cylinder_stack", f"{CYLINDER_STEPS} steps: cylinders off their heights by "
        + ", ".join(f"{h:.4f}" for h in heights) + f" m (limit {CYLINDER_HEIGHT_TOL}), cone "
        f"y {float(pos[cone][1]):.4f} m, largest tilt {tilt:.4f} (limit {CYLINDER_TILT_TOL}), "
        f"asleep {bool(sleeping[stack].all() and sleeping[cone])}; launches M {got['convex_manifold']} "
        f"O {got['plane_patch_manifold']}")
    if not (np.isfinite(pos).all() and max(heights) < CYLINDER_HEIGHT_TOL
            and tilt < CYLINDER_TILT_TOL and abs(float(pos[cone][1]) - 0.5) < CONE_TOL
            and sleeping[stack].all() and sleeping[cone]):
        raise AssertionError("cylinder_stack: the stack does not rest upright and asleep")
    if got["convex_manifold"] == 0 or got["plane_patch_manifold"] == 0:
        raise AssertionError(f"cylinder_stack: Kernels M and O did not carry it: {got}")


def terrain(device, n=None, per_row=None, field=None):
    """``scenes.terrain_shapes``, by default the full-width path's."""
    n = n or TERRAIN_N
    return scenes.terrain_shapes(n, per_row=per_row or TERRAIN_PER_ROW, seed=TERRAIN_SEED,
                                 field=field or TERRAIN_FIELD,
                                 max_contacts=TERRAIN_SLOTS_PER_BODY * n, device=device)


def heights_above(world, ids, field=None):
    """(height f64[len(ids)] of each body's centre of mass above the field's
    surface at its (x, z), farthest |x| or |z|). (The centre of mass lies
    inside the body's collider; a rock's origin need not: the hull of 12
    points on a sphere can miss its centre.)"""
    field = field or TERRAIN_FIELD
    b = world.bodies
    idx = torch.tensor(ids, device=world.device)
    p = (b.pos[idx] + quat_m.rotate(b.quat[idx], b.com[idx])).cpu().numpy().astype(np.float64)
    heights = scenes.terrain_heights(field)
    return (p[:, 1] - scenes.terrain_height_at(heights, p[:, 0], p[:, 2]),
            float(np.abs(p[:, [0, 2]]).max()))


def on_the_field(what, world, ids, field=None):
    """(least height of a body's centre of mass above the field's surface,
    farthest |x| or |z|); fails if a centre is more than
    ``TERRAIN_BELOW_TOL`` below the surface or outside the footprint."""
    field = field or TERRAIN_FIELD
    h, reach = heights_above(world, ids, field)
    above = float(h.min())
    if not above >= -TERRAIN_BELOW_TOL:
        raise AssertionError(f"{what}: a body is {-above} m below the field's surface "
                             f"(limit {TERRAIN_BELOW_TOL})")
    if not reach <= (field - 1) / 2:
        raise AssertionError(f"{what}: a body left the field ({reach} m from its centre line)")
    return above, reach


def cell_runs(world, config):
    """(largest number of entries in one grid cell, cells with more than the
    sweep window + 1 entries) of ``world``'s next broadphase, computed by the
    plain versions (no launch is counted)."""
    with plain_versions():
        g = bp_m.grid_entries(bp_m.update_aabbs(world, config), config)
    keys = g.skey[g.skey != kb.SENTINEL]
    _, counts = torch.unique_consecutive(keys, return_counts=True)
    return int(counts.max()), int((counts > g.window + 1).sum())


def phase_terrain(device, smi):
    """The hull-and-terrain path at full width through ``physics_step``:
    every one of its 21 shape pairs launched, no body below the field's
    surface or off the field (checked every 10 steps). Returns the launch
    counts."""
    world, ids = terrain(device)
    n_cols = int(world.colliders.active.sum())
    pool = world.convex_verts.shape[0]
    runs = [cell_runs(world, TERRAIN_CONFIG)]
    buckets, field = {}, []

    def check(w):
        field.append(on_the_field("terrain", w, ids))
        runs.append(cell_runs(w, TERRAIN_CONFIG))

    world, got = drive("terrain", world, TERRAIN_CONFIG, TERRAIN_STEPS, smi, len(ids),
                       every10=check, buckets=buckets)
    seen = {pair: (len(v), max(v)) for pair, v in sorted(buckets.items())}
    largest = sorted(((max(v), pair) for pair, v in buckets.items()), reverse=True)[:6]
    say("terrain", f"{n_cols} colliders ({n_cols - len(ids)} triangles), a pool of {pool} "
        f"vertices; {len(seen)} shape pairs launched (steps, most pairs in a step): {seen}; "
        f"largest buckets {largest}; every 10 steps, least height above the field (m) and "
        f"farthest |x|, |z| (m): " + ", ".join(f"{a:.3f}/{r:.1f}" for a, r in field)
        + f"; largest grid cell run (entries, cells past the window) at the start and every "
        f"10 steps: {runs}; {int(world.bodies.sleeping.sum())} asleep")
    missing = sorted(set(TERRAIN_PAIRS) - set(seen))
    if missing:
        raise AssertionError(f"terrain: shape pairs never launched: {missing}")
    return got


def phase_terrain_plain_path(device):
    """``TERRAIN_PLAIN_N`` bodies on the terrain from their start through
    ``PLAIN_STEPS`` steps on the kernels and on their plain versions alone:
    every body within ``PLAIN_TOL`` for ``PLAIN_TIGHT_STEPS`` steps; then,
    landed after ``TERRAIN_KERNEL_STEPS`` steps, ``SHAPES_ONE_STEPS`` single
    steps, each from the kernels' state on the kernels and on the plain
    versions: every body within ``SHAPES_ONE_STEP_TOL`` after each (as the
    mixed shapes' plain path)."""
    world, ids = terrain(device, TERRAIN_PLAIN_N, TERRAIN_PLAIN_PER_ROW)
    on_kernels, _ = trajectory(world, TERRAIN_CONFIG, PLAIN_STEPS, ids)
    on_plain, _, seconds = on_plain_versions(world, TERRAIN_CONFIG, PLAIN_STEPS, ids)
    diff = (on_kernels - on_plain).abs().amax(dim=(1, 2))
    for _ in range(TERRAIN_KERNEL_STEPS):
        world = physics_step(world, TERRAIN_CONFIG)
    one, pairs = [], 0
    for _ in range(SHAPES_ONE_STEPS):
        on_k, diag = physics_step(world, TERRAIN_CONFIG, return_diagnostics=True)
        pairs = max(pairs, sum(diag["manifold_pairs"].values()))
        kernels.reset_launches()
        with plain_versions():
            on_p = physics_step(world, TERRAIN_CONFIG)
        if any(kernels.launches().values()):
            raise AssertionError(f"plain path: kernels were launched: {kernels.launches()}")
        one.append(float((on_k.bodies.pos - on_p.bodies.pos).abs().max()))
        world = on_k
    say("plain path", f"terrain {TERRAIN_PLAIN_N}, {PLAIN_STEPS} steps from the start on the "
        f"kernels and on their plain versions ({seconds:.1f} s): largest difference of any "
        f"body's position {float(diff.max()):.3g} m (limit {PLAIN_TOL} over the first "
        f"{PLAIN_TIGHT_STEPS}); after {TERRAIN_KERNEL_STEPS} steps ({pairs} manifold pairs a "
        f"step), one step from the same state each: " + ", ".join(f"{d:.2g}" for d in one)
        + f" m (limit {SHAPES_ONE_STEP_TOL})")
    if not float(diff[:PLAIN_TIGHT_STEPS].max()) <= PLAIN_TOL:
        raise AssertionError(f"plain path: a terrain body is {float(diff.max())} m from its "
                             f"place on the plain versions (limit {PLAIN_TOL})")
    if not max(one) <= SHAPES_ONE_STEP_TOL:
        raise AssertionError(f"plain path: one step of the landed terrain parts by "
                             f"{max(one)} m (limit {SHAPES_ONE_STEP_TOL})")


def steps(world, config, n):
    for _ in range(n):
        world = physics_step(world, config)
    return world


def phase_reference_scenes(device):
    """The reference's trimesh, voxel, hull and round-cuboid scenes on the
    kernels, each held to its source's checks. Returns the launch counts
    (the path of Kernel Q, a hull on a half-space)."""
    kernels.reset_launches()
    found = []
    world, balls = scenes.trimesh_valley(device=device)
    pos = steps(world, SCENE_CONFIG, 300).bodies.pos.cpu().numpy()
    # examples/trimesh_shapes_3d.py: rolled into the valley, resting on the V.
    ok = np.isfinite(pos).all() and all(abs(pos[b][0]) < 1.0 and 0.2 < pos[b][1] < 1.5
                                        for b in balls)
    found.append(("trimesh_valley", ok, "balls at " + ", ".join(
        f"({pos[b][0]:.3f}, {pos[b][1]:.3f})" for b in balls)))
    world, ball = scenes.voxel_stairs(device=device)
    p = steps(world, SCENE_CONFIG, 240).bodies.pos[ball].cpu().numpy()
    # examples/voxels_3d.py: on the step of column x = 1, y = 2 + 0.4.
    found.append(("voxel_stairs", bool(np.isfinite(p).all() and abs(p[1] - 2.4) < 0.1),
                  f"ball y {p[1]:.4f}"))
    world, ids = scenes.hull_stack(single=True, device=device)
    world = steps(world, HULL_CONFIG, 120)
    y = float(world.bodies.pos[ids[0], 1])
    # tests/test_convex_hull.py::test_hull_cube_rests_on_plane
    found.append(("hull cube", abs(y - 0.5) < 0.02 and bool(world.bodies.sleeping[ids[0]]),
                  f"y {y:.4f}, asleep {bool(world.bodies.sleeping[ids[0]])}"))
    world, ids = scenes.hull_stack(device=device)
    pos = steps(world, HULL_CONFIG, 240).bodies.pos.cpu().numpy()
    lower, upper, octa = (pos[i][1] for i in ids)
    # test_hull_stack_and_octahedron: the stack holds, the octahedron lies on
    # a face (its centre r / sqrt(3) = 0.346 m up).
    found.append(("hull stack", bool(np.isfinite(pos).all() and abs(lower - 0.5) < 0.05
                                     and abs(upper - 1.5) < 0.1 and 0.25 < octa < 0.6 + 1e-3),
                  f"lower {lower:.4f}, upper {upper:.4f}, octahedron {octa:.4f}"))
    b = SceneBuilder()
    g = b.add_body(body_type=BodyType.STATIC)
    b.half_space(g, normal=(0, 1, 0))
    rc = b.add_body(pos=(0.0, 0.8, 0.0))
    b.round_cuboid(rc, 1.0, 1.0, 1.0, 0.1)
    world = steps(b.finalize(max_bodies=4, max_colliders=4, max_contacts=16, device=device),
                  ROUND_CONFIG, 120)
    y = float(world.bodies.pos[rc, 1])
    # tests/test_round_shapes.py::test_round_cuboid_rests_at_outer_height
    found.append(("round cuboid", abs(y - 0.6) < 0.03, f"y {y:.4f}"))
    got = kernels.launches()
    say("scenes", "; ".join(f"{name} {'OK' if ok else 'FAILED'}: {text}"
                            for name, ok, text in found)
        + f"; launches P {got['hull_manifold']} Q {got['plane_hull_manifold']}")
    bad = [name for name, ok, _ in found if not ok]
    if bad:
        raise AssertionError(f"scenes: {bad} fail their checks")
    if got["hull_manifold"] == 0 or got["plane_hull_manifold"] == 0:
        raise AssertionError(f"scenes: Kernels P and Q did not carry them: {got}")
    return got


# ---- the time-of-impact path: swept CCD (Kernel R) and the casts (S, T) ------


def bullets_below(world, shots):
    """How many bullets' centres of mass are more than ``TERRAIN_BELOW_TOL``
    below the field's surface."""
    return int((heights_above(world, shots)[0] < -TERRAIN_BELOW_TOL).sum())


def ccd_world(device, n=None, per_row=None, bullets=None, field=None):
    """``scenes.terrain_ccd``, by default the full-width path's."""
    n = n or TERRAIN_N
    bullets = bullets or CCD_BULLETS
    return scenes.terrain_ccd(n, per_row=per_row or TERRAIN_PER_ROW, bullets=bullets,
                              seed=TERRAIN_SEED, field=field or TERRAIN_FIELD,
                              max_contacts=TERRAIN_SLOTS_PER_BODY * (n + bullets), device=device)


def substepped(world, config):
    """(prepared step, solver state after its substeps) of ``world``'s next
    step: what the swept-CCD pass of that step sees."""
    p = prepare_step(world, config)
    s, _ = run_substeps(p, config)
    return p, s


def r_rounds(grid):
    """Kernel R over ``grid``, with the rounds each pair ran: ``(toi
    f32[k_ok * M], rounds i32[k_ok * M])``, ``rounds`` negated where a valid
    pair ran all without a hit and t stayed below 1 (``kernels/swept_toi.py``)."""
    m = grid.tab.pos0.shape[0]
    dev = grid.tab.pos0.device
    toi = torch.ones((grid.k_ok * m,), dtype=torch.float32, device=dev)
    rounds = torch.zeros((grid.k_ok * m,), dtype=torch.int32, device=dev)
    rows = grid.swept[:grid.k_ok].contiguous()
    for pair, flat in grid.buckets:
        kccd.swept_toi(pair, flat, rows, m, grid.tab, toi, rounds)
    return toi, rounds


def grid_work(grid, rounds):
    """(bytes, operations) of Kernel R over ``grid``: each collider's row and
    the pair list read once, the TOIs written once; each pair's manifolds
    (the rounds it ran, from ``r_rounds``) at ``MANIFOLD_OPS`` of its kernel
    plus ``ROUND_OPS`` for the rest of a round."""
    io = nbytes(*grid.tab, *(flat for _, flat in grid.buckets)) + 4 * rounds.numel()
    ops = 0
    for pair, flat in grid.buckets:
        ran = int(rounds[flat.long()].abs().sum())
        ops += ran * (MANIFOLD_OPS[PAIR_KERNELS[pair][1]] + ROUND_OPS)
    return io, ops


def swept_subset(grid, aabbs, seed):
    """bool[M]: the colliders whose swept AABB (this step's AABB ``aabbs``
    stretched along its delta position) meets a swept collider's, and
    ``seed``'s ``CCD_TWIN_COLUMNS`` more."""
    tab = grid.tab
    lo = aabbs[0] + torch.clamp(tab.sweep, max=0.0)
    hi = aabbs[1] + torch.clamp(tab.sweep, min=0.0)
    rows = grid.swept[:grid.k_ok].long()
    meets = ((lo[None, :, :] <= hi[rows][:, None, :])
             & (hi[None, :, :] >= lo[rows][:, None, :])).all(-1).any(0)
    return with_seeded(meets, seed)


def with_seeded(mask, seed):
    """``mask`` (bool[M]) with ``CCD_TWIN_COLUMNS`` more entries, drawn by
    ``seed``, set."""
    m = mask.shape[0]
    rng = np.random.default_rng(seed)
    extra = torch.from_numpy(rng.choice(m, min(CCD_TWIN_COLUMNS, m), replace=False))
    mask[extra.to(mask.device)] = True
    return mask


def kernel_r_against_twin(grid, aabbs, nonlinear_rows):
    """Kernel R over the whole grid, then its plain version on the pairs of
    ``swept_subset``'s columns; linear rows bit for bit, nonlinear ones
    within ``TOL_R_NONLINEAR``. Returns (max abs error, twin pairs, the
    twin's milliseconds on them, the rounds of the whole grid)."""
    m = grid.tab.pos0.shape[0]
    toi, rounds = r_rounds(grid)
    if not torch.equal(toi, ccd_m.grid_tois(grid).reshape(-1)):
        raise AssertionError("swept_toi: two runs differ")
    if bool(((rounds < 0) & ~(toi < 1.0)).any()):
        raise AssertionError("swept_toi: a pair whose rounds ran out returned t >= 1")
    cols = swept_subset(grid, aabbs, 3)
    rows = grid.swept[:grid.k_ok].contiguous()
    twin = torch.ones_like(toi)
    sub = [(pair, flat[cols[flat.long() % m]].contiguous()) for pair, flat in grid.buckets]
    sub = [(pair, keep) for pair, keep in sub if keep.numel()]

    def run_twin():
        for pair, keep in sub:
            kccd.swept_toi_twin(pair, keep, rows, m, grid.tab, twin)

    _, twin_ms = once_ms(run_twin)
    flats = torch.cat([f for _, f in sub]).long()
    nonlinear = nonlinear_rows[flats // m]
    err = compare("swept_toi linear rows", toi[flats][~nonlinear], twin[flats][~nonlinear])
    err = max(err, compare("swept_toi nonlinear rows", toi[flats][nonlinear],
                           twin[flats][nonlinear], TOL_R_NONLINEAR))
    return err, int(flats.numel()), twin_ms, rounds


def touching_at_start(grid, r, j):
    """Whether the grid's pair (row ``r``, collider ``j``) touches at t = 0
    (its least separation there <= 1e-4), by the plain manifold function:
    the pairs the sweep's first repair advances only ``DEEPER`` deep."""
    tab = grid.tab
    i = int(grid.swept[r])
    a, b = (j, i) if int(tab.shape_type[i]) > int(tab.shape_type[j]) else (i, j)
    pair = (int(tab.shape_type[a]), int(tab.shape_type[b]))
    sep4 = pair_manifold_twin(pair, tab.pos0[a:a + 1], tab.quat0[a:a + 1], tab.params[a:a + 1],
                              tab.pos0[b:b + 1], tab.quat0[b:b + 1], tab.params[b:b + 1],
                              tab.pool)[3]
    return float(sep4.amin()) <= 1e-4


def ccd_side_effects(world):
    """What the sweep's two repairs of the reference (``kernels/swept_toi.py``,
    ROADMAP 3b) do on the ``ccd`` run: its ``CCD_STEPS`` steps again from
    ``world``, and per step the grid's pairs that return t < 1 without a
    hit (their rounds ran out: the second repair), the bullets whose delta
    position R cut, and of those the ones with no contact point in the next
    step's narrowphase (stopped short of anything). Each of the last is put
    down to the pair that set its TOI: one whose rounds ran out, one that
    touched at t = 0 (the first repair, advancing only ``DEEPER`` deep), or
    one that met from apart (the reference's own rule). Returns (the three
    counts a step, {cause: bullets cut with no contact after})."""
    n_bodies = world.bodies.capacity
    ran_out, cut, alone = [], [], []
    causes = {"ran out": 0, "touching at t = 0": 0, "met from apart": 0}
    pending = {}  # body -> (grid, row, collider, ran out) of the previous step's cuts

    def check(p):
        c = p.contacts
        live = c.active & (c.num_points > 0)
        touched = torch.zeros(n_bodies, dtype=torch.bool, device=world.device)
        touched[c.body_a[live].long()] = True
        touched[c.body_b[live].long()] = True
        lone = [why for body, why in pending.items() if not bool(touched[body])]
        for grid, r, j, out in lone:
            causes["ran out" if out else "touching at t = 0" if touching_at_start(grid, r, j)
                   else "met from apart"] += 1
        alone.append(len(lone))

    for step in range(CCD_STEPS):
        p, s = substepped(world, CCD_CONFIG)
        if step:
            check(p)
        grid = ccd_m.swept_grid(p.world, s, *p.poses, CCD_CONFIG)
        pending, n_out = {}, 0
        if grid.k_ok:
            toi, rounds = r_rounds(grid)
            n_out = int((rounds < 0).sum())
            row_min, col = toi.view(grid.k_ok, -1).min(1)
            body = p.world.colliders.body_idx[grid.swept[:grid.k_ok].long()].long()
            m = toi.shape[0] // grid.k_ok
            for r in torch.nonzero(row_min * ccd_m.TOI_EPS < 1.0)[:, 0].tolist():
                j = int(col[r])
                why = (grid, r, j, bool(rounds[r * m + j] < 0))
                pending[int(body[r])] = min(pending.get(int(body[r]), why), why,
                                            key=lambda w: float(toi[w[1] * m + w[2]]))
        ran_out.append(n_out)
        cut.append(len(pending))
        world = physics_step(world, CCD_CONFIG)
    check(prepare_step(world, CCD_CONFIG))
    return ran_out, cut, alone, causes


def phase_ccd(device, smi):
    """The swept-CCD path at full width: ``terrain_ccd`` (the terrain's
    10,000 bodies and 32 bullets fired down into it at 300 m/s) through
    ``physics_step`` with ``swept_ccd`` for ``CCD_STEPS`` steps: no bullet's
    centre of mass ever below the field's surface or off the field (checked
    every step), every body of the terrain held as before (every 10 steps),
    no dropped pair, and Kernel R launched on every step that sweeps a
    moving collider. Before that, R against its plain version on the
    grid of the state after ``CCD_KERNEL_STEPS`` steps; after, what the
    sweep's repairs did over those steps (``ccd_side_effects``), and the
    same world for ``CCD_CONTROL_STEPS`` steps without ``swept_ccd`` (both
    printed, not gated). Returns ({"swept_toi": measurements}, launch counts)."""
    world, ids, shots = ccd_world(device)
    n_cols = int(world.colliders.active.sum())
    start = world
    for _ in range(CCD_KERNEL_STEPS):
        world = physics_step(world, CCD_CONFIG)
    p, s = substepped(world, CCD_CONFIG)
    grid = ccd_m.swept_grid(p.world, s, *p.poses, CCD_CONFIG)
    if grid.k_ok != CCD_BULLETS:
        raise AssertionError(f"ccd: {grid.k_ok} swept colliders, not {CCD_BULLETS}")
    body = p.world.colliders.body_idx[grid.swept[:grid.k_ok].long()].long()
    nonlinear = p.world.bodies.swept_ccd_nonlinear[body]
    err, twin_pairs, twin_ms, rounds = kernel_r_against_twin(
        grid, (p.world.colliders.aabb_min, p.world.colliders.aabb_max), nonlinear)
    io, ops = grid_work(grid, rounds)
    b_ms, b_by = bound(io, ops)
    hits = int((ccd_m.grid_tois(grid).amin(1) < 1.0).sum())
    m = grid.tab.pos0.shape[0]
    r = dict(max_abs_err=err, ms=cuda_ms(lambda: ccd_m.grid_tois(grid)), plain_ms=twin_ms,
             bound_ms=b_ms, bound_by=b_by, library_ms=None, pairs=grid.k_ok * m,
             plain_pairs=twin_pairs, mean_rounds=float(rounds.abs().double().mean()))
    say("ccd", f"Kernel R on the grid after {CCD_KERNEL_STEPS} steps: {grid.k_ok} x {m} pairs "
        f"in {len(grid.buckets)} buckets ({[pair for pair, _ in grid.buckets]}), "
        f"{r['mean_rounds']:.3f} rounds a pair, {hits} swept colliders meet something within "
        f"the step; against the twin on {twin_pairs} pairs (every collider whose swept AABB "
        f"meets a bullet's and {CCD_TWIN_COLUMNS} seeded ones): max abs err {err:.3g}; "
        f"kernel {r['ms']:.3f} ms (whole grid), twin {r['plain_ms']:.3f} ms (those pairs, "
        f"one run), "
        f"bound {b_ms:.5f} ms ({b_by}) [{smi}]")

    steps_swept, steps_r, field = [0], [0], []

    def each_step(i, w, diag):
        field.append(on_the_field("ccd bullets", w, shots))
        if diag["stepped"] and diag["swept_colliders"] > 0:
            steps_swept[0] += 1
            steps_r[0] += int(len(diag["swept_pairs"]) > 0)

    def every10(w):
        on_the_field("ccd pile", w, ids)

    world, got = drive("ccd", start, CCD_CONFIG, CCD_STEPS, smi, len(ids) + len(shots),
                       every10=every10, each_step=each_step)
    if steps_r[0] != steps_swept[0] or steps_swept[0] == 0:
        raise AssertionError(f"ccd: Kernel R ran on {steps_r[0]} of the {steps_swept[0]} steps "
                             "that swept a moving collider")
    low = min(a for a, _ in field)
    ran_out, cut, alone, causes = ccd_side_effects(start)
    say("ccd", f"the sweep's repairs over the same {CCD_STEPS} steps (ROADMAP 3b): pairs "
        f"returning t < 1 without a hit {sum(ran_out)} (most in a step {max(ran_out)}); "
        f"bullets cut {sum(cut)} (most in a step {max(cut)}), of which with no contact point "
        f"in the next step {sum(alone)} (most in a step {max(alone)}; by the pair that set "
        f"the TOI: {causes}); a step each: ran out {ran_out}, cut {cut}, cut and no contact "
        f"after {alone}")
    control = start
    for _ in range(CCD_CONTROL_STEPS):
        control = physics_step(control, CCD_CONFIG.replace(swept_ccd=False))
    say("ccd", f"{n_cols} colliders, {len(shots)} bullets ({CCD_BULLETS // 2} linear spheres, "
        f"{CCD_BULLETS // 2} nonlinear spinning capsules): R ran on all {steps_swept[0]} steps "
        f"that swept a moving collider ({got['swept_toi']} launches); the bullets' least "
        f"height above the field over all {CCD_STEPS} steps {low:.4f} m, "
        f"{bullets_below(world, shots)} below at the end; without swept CCD, "
        f"{bullets_below(control, shots)} of {len(shots)} end below the field after "
        f"{CCD_CONTROL_STEPS} steps")
    return {"swept_toi": r}, got


def swept_scene(device, bullets):
    """tests/test_scenes.py's two swept worlds: a bullet at 300 m/s into a
    thin wall (``bullets == 1``) or two at 150 m/s into each other."""
    b = SceneBuilder()
    if bullets == 1:
        wall = b.add_body(body_type=BodyType.STATIC, pos=(5.0, 0.0, 0.0))
        b.box(wall, 0.05, 10.0, 10.0)
        shots = [(0.0, 300.0)]
    else:
        shots = [(-4.0, 150.0), (4.0, -150.0)]
    ids = []
    for x, v in shots:
        ids.append(b.add_body(pos=(x, 0.0, 0.0), lin_vel=(v, 0.0, 0.0), swept_ccd=True,
                              gravity_scale=0.0))
        b.sphere(ids[-1], 0.1, speculative_margin=0.05)
    return b.finalize(max_bodies=4, max_colliders=4, max_contacts=16, device=device), ids


def example_ccd(device, swept):
    """examples/ccd.py's scene."""
    b = SceneBuilder()
    wall = b.add_body(body_type=BodyType.STATIC, pos=(5.0, 0.0, 0.0))
    b.box(wall, 0.05, 3.0, 3.0)
    bullet = b.add_body(pos=(0.0, 0.0, 0.0), lin_vel=(80.0, 0.0, 0.0), gravity_scale=0.0,
                        swept_ccd=swept)
    b.sphere(bullet, 0.1)
    return b.finalize(max_bodies=4, max_colliders=4, max_contacts=16, device=device), bullet


def phase_ccd_reference(device):
    """The reference's swept-CCD scenes on the kernels with their own
    checks: tests/test_scenes.py's bullet (x < 5 after 10 steps) and its two
    bullets (not crossed after 12), examples/ccd.py in both modes (x < 5
    after 30 steps), and ``ccd_stress(32, 80)`` for 30 steps (finite)."""
    kernels.reset_launches()
    found = []
    world, (bullet,) = swept_scene(device, 1)
    x = float(steps(world, SWEPT_CONFIG, 10).bodies.pos[bullet, 0])
    found.append(("swept bullet", x < 5.0, f"x {x:.4f}"))
    world, (left, right) = swept_scene(device, 2)
    pos = steps(world, SWEPT_CONFIG, 12).bodies.pos
    xl, xr = float(pos[left, 0]), float(pos[right, 0])
    found.append(("two bullets", xl <= xr + 0.2 and math.isfinite(xl + xr),
                  f"left {xl:.4f}, right {xr:.4f}"))
    for swept in (False, True):
        world, bullet = example_ccd(device, swept)
        x = float(steps(world, PhysicsConfig(max_colors=4, swept_ccd=swept), 30)
                  .bodies.pos[bullet, 0])
        found.append((f"examples/ccd.py {'swept' if swept else 'speculative'}", x < 5.0,
                      f"x {x:.4f}"))
    world, ids = scenes.ccd_stress(32, 80.0, device=device)
    dropped = 0
    for _ in range(30):
        world, diag = physics_step(world, PhysicsConfig(max_colors=4), return_diagnostics=True)
        dropped = max(dropped, int(diag["dropped_pairs"]))
    x = world.bodies.pos[ids, 0]
    found.append(("ccd_stress(32, 80)", bool(torch.isfinite(world.bodies.pos).all()),
                  f"bullets' x {float(x.min()):.3f}..{float(x.max()):.3f}, most dropped "
                  f"pairs in a step {dropped} (272 contact slots; ROADMAP 3b)"))
    got = kernels.launches()
    say("ccd scenes", "; ".join(f"{name} {'OK' if ok else 'FAILED'}: {text}"
                                for name, ok, text in found)
        + f"; launches R {got['swept_toi']}")
    bad = [name for name, ok, _ in found if not ok]
    if bad:
        raise AssertionError(f"ccd scenes: {bad} fail their checks")
    if got["swept_toi"] == 0:
        raise AssertionError("ccd scenes: Kernel R did not carry them")


def query_rays(seed):
    """``QUERY_RAYS`` seeded rays over the terrain: three in four straight
    down (with a tilt of at most 0.05) from 20 m onto the pile and the field
    (within 3/4 of its half width of the centre), the rest level through the
    pile from the field's edge. (origins, unit directions) f32[R, 3] on the
    CPU."""
    rng = np.random.default_rng(seed)
    n = QUERY_RAYS
    down = n * 3 // 4
    half = (TERRAIN_FIELD - 1) / 2
    reach = 0.75 * half
    o = np.concatenate([
        np.stack([rng.uniform(-reach, reach, down), np.full(down, 20.0),
                  rng.uniform(-reach, reach, down)], 1),
        np.stack([np.full(n - down, -half - 1.0), rng.uniform(0.3, 4.0, n - down),
                  rng.uniform(-reach, reach, n - down)], 1)])
    d = np.concatenate([np.tile([[0.0, -1.0, 0.0]], (down, 1)),
                        np.tile([[1.0, 0.0, 0.0]], (n - down, 1))])
    d = d + rng.uniform(-0.05, 0.05, d.shape)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o.astype(np.float32)), torch.from_numpy(d.astype(np.float32))


def ray_work(world, n_rays, t):
    """(bytes, operations) of Kernel T for ``n_rays`` rays on every collider
    of ``world``: the rays, the colliders' rows and the hulls' vertices read
    once, distances and normals written once; ``RAY_OPS`` a (ray, analytic
    collider), and for a pool-backed shape 24 marches of 13 scans of its
    vertices (``HULL_SCAN_OPS`` a vertex) plus the face fit."""
    col = world.colliders
    convex = col.shape_type == int(ShapeType.CONVEX)
    verts = int(col.params[convex, 1].sum())
    io = 24 * n_rays + 52 * col.capacity + 12 * verts + nbytes(*t)
    ops = n_rays * (RAY_OPS * int((~convex).sum())
                    + (24 * 13 + 8) * HULL_SCAN_OPS * verts + 500 * int(convex.sum()))
    return io, ops


def cast_work(world, shape_type, rounds, out):
    """(bytes, operations) of Kernel S for one cast: the colliders' rows read
    and their results written once; each collider's manifolds (its rounds and
    the final one) at ``MANIFOLD_OPS`` of its pair's kernel."""
    col = world.colliders
    io = 52 * col.capacity + 12 * int(world.convex_verts.shape[0]) + nbytes(*out)
    ops = 0
    for t in torch.unique(col.shape_type).tolist():
        pair = (min(shape_type, t), max(shape_type, t))
        if pair in PAIR_KERNELS:
            n = int(rounds[col.shape_type == t].sum()) + int((col.shape_type == t).sum())
            ops += n * (MANIFOLD_OPS[PAIR_KERNELS[pair][1]] + ROUND_OPS)
    return io, ops


def cast_subset(world, params, origin, direction, seed):
    """bool[M]: the colliders whose AABB (this step's, widened by
    ``QUERY_AABB_PAD``) meets the cast's swept box (the segment from
    ``origin`` along ``direction`` to ``QUERY_MAX_DISTANCE + 1``, widened by
    the sum of the shape's params, which bounds the reach of the five query
    shapes), and ``seed``'s ``CCD_TWIN_COLUMNS`` more."""
    col = world.colliders
    o = torch.tensor(origin, dtype=torch.float32, device=world.device)
    d = torch.tensor(direction, dtype=torch.float32, device=world.device)
    end = o + d / torch.linalg.vector_norm(d) * (QUERY_MAX_DISTANCE + 1.0)
    reach = float(sum(params)) + QUERY_AABB_PAD
    lo, hi = torch.minimum(o, end) - reach, torch.maximum(o, end) + reach
    meets = ((col.aabb_min <= hi) & (col.aabb_max >= lo)).all(-1)
    return with_seeded(meets, seed)


def cast_against_twin(world, st, params, origin, rot, down, seed):
    """Kernel S on one cast (every bucket, with its rounds), then its plain
    version on ``cast_subset``'s colliders: hit flags exactly, the hits'
    distances, points and normals within ``TOL_ST``. Returns (max abs error,
    the twin's colliders, its milliseconds, the kernel's ``CastOut``, the
    rounds)."""
    name = ShapeType(st).name
    query, tabs, out, buckets = shapecast.cast_setup(world, st, params, origin, rot, down,
                                                     QUERY_MAX_DISTANCE)
    twin = ks.CastOut(*(x.clone() for x in out))
    rounds = torch.zeros(world.colliders.capacity, dtype=torch.int32, device=world.device)
    for pair, cols in buckets:
        ks.shape_cast(pair, cols, st, query, *tabs, out, rounds)
    keep = cast_subset(world, params, origin, down, seed)
    sub = [(pair, cols[keep[cols.long()]].contiguous()) for pair, cols in buckets]
    sub = [(pair, cols) for pair, cols in sub if cols.numel()]

    def run_twin():
        for pair, cols in sub:
            ks.shape_cast_twin(pair, cols, st, query, *tabs, twin)

    _, twin_ms = once_ms(run_twin)
    idx = torch.cat([cols for _, cols in sub]).long()
    compare(f"shape_cast {name} hits", out.hit[idx], twin.hit[idx])
    hit = idx[twin.hit[idx]]
    err = 0.0
    for what, x, y in zip(("distance", "point_a", "point_b", "normal"), (out.t, *out[2:]),
                          (twin.t, *twin[2:])):
        err = max(err, compare(f"shape_cast {name} {what}", x[hit], y[hit], TOL_ST))
    return err, int(idx.numel()), twin_ms, out, rounds


def phase_queries(device, smi):
    """Ray and shape casts into the full-width terrain after
    ``TERRAIN_KERNEL_STEPS`` steps, as a user makes them: ``cast_shape`` and
    ``shape_hits(max_hits=4)`` of a sphere, a capsule, a box, a cylinder and
    a cone from seeded origins above the pile, straight down; ``cast_ray``
    and ``ray_hits`` with ``solid`` both ways; ``QUERY_RAYS`` rays in one
    call (one launch of T per shape type). The launch counts are those of
    these calls alone. Then S against its plain version on each of the five
    casts (``cast_against_twin``), T on ``QUERY_TWIN_RAYS`` of the rays:
    collider hits exactly, distances, points and normals within ``TOL_ST``;
    then the times. Returns ({name: measurements}, launch counts)."""
    world, _ = terrain(device)
    for _ in range(TERRAIN_KERNEL_STEPS):
        world = physics_step(world, TERRAIN_CONFIG)
    rng = np.random.default_rng(11)
    qf = QueryFilter()
    reach = 0.6 * (TERRAIN_FIELD - 1) / 2
    casts = []
    for st, params in QUERY_SHAPES:
        origin = (float(rng.uniform(-reach, reach)), 15.0, float(rng.uniform(-reach, reach)))
        q = rng.normal(size=4)
        rot = tuple(float(x) for x in q / np.linalg.norm(q))
        down = (float(rng.uniform(-0.05, 0.05)), -1.0, float(rng.uniform(-0.05, 0.05)))
        casts.append((st, params, origin, rot, down))
    ray_from = [(solid, (float(rng.uniform(-reach, reach)), 20.0,
                         float(rng.uniform(-reach, reach)))) for solid in (True, False)]
    inside_from = tuple(float(x) for x in world.bodies.pos[1].tolist())
    d = (0.0, -1.0, 0.0)
    origins, dirs = query_rays(5)
    o_dev, d_dev = origins.to(device), dirs.to(device)
    torch.cuda.synchronize()

    kernels.reset_launches()
    shape_results = [(cast_shape(world, st, params, origin, rot, down, QUERY_MAX_DISTANCE),
                      shape_hits(world, st, params, origin, rot, down, QUERY_MAX_DISTANCE,
                                 max_hits=4))
                     for st, params, origin, rot, down in casts]
    ray_results = [(cast_ray(world, o, d, 50.0, solid), ray_hits(world, o, d, 4, 50.0, solid),
                    cast_ray(world, inside_from, d, 50.0, solid)) for solid, o in ray_from]
    before = kernels.launches()["ray_cast"]
    t, n = raycast.all_hits(world, o_dev, d_dev, True, qf)
    got = kernels.launches()
    n_launch = got["ray_cast"] - before

    hits = []
    for (st, *_), (one, many) in zip(casts, shape_results):
        if not (bool(one.hit) and int(one.collider) == int(many.collider[0])):
            raise AssertionError(f"queries: the {ShapeType(st).name} cast hit nothing or its "
                                 "two calls disagree")
        hits.append(f"{ShapeType(st).name.lower()} {float(one.distance):.3f} m to "
                    f"{int(one.collider)}, {int(many.hit.sum())} hits")
    ray_text = []
    for (solid, _), (one, many, inside) in zip(ray_from, ray_results):
        if not (bool(one.hit) and int(one.collider) == int(many.collider[0])):
            raise AssertionError("queries: a ray down onto the terrain hit nothing")
        if solid != (float(inside.distance) == 0.0):
            raise AssertionError(f"queries: a ray from inside a body (solid={solid}) gave "
                                 f"{float(inside.distance)}")
        ray_text.append(f"solid={solid}: {float(one.distance):.3f} m to {int(one.collider)}, "
                        f"{int(many.hit.sum())} hits, from inside {float(inside.distance):.3f}")
    want_s = 2 * sum(sum(1 for _, cols in shapecast.cast_setup(
        world, st, params, origin, rot, down, QUERY_MAX_DISTANCE)[3] if cols.numel())
        for st, params, origin, rot, down in casts)
    if got["shape_cast"] != want_s or n_launch == 0 or got["ray_cast"] <= n_launch:
        raise AssertionError(f"queries: Kernels S and T did not carry the casts: {got} "
                             f"(S: {want_s} buckets of the ten casts)")

    out, err_s, twin_cols, twin_ms_s = {}, 0.0, [], 0.0
    for st, params, origin, rot, down in casts:
        err, n_cols, twin_ms, res, rounds = cast_against_twin(world, st, params, origin, rot,
                                                              down, 3 + st)
        err_s = max(err_s, err)
        twin_cols.append(n_cols)
        if st == int(ShapeType.SPHERE):
            b_ms, b_by = bound(*cast_work(world, st, rounds, res))
            args = (st, params, origin, rot, down, QUERY_MAX_DISTANCE, qf)
            out["shape_cast"] = dict(
                max_abs_err=0.0, ms=cuda_ms(lambda args=args: shapecast.sweep_all(world, *args)),
                plain_ms=twin_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                plain_colliders=n_cols)
    out["shape_cast"]["max_abs_err"] = err_s
    hit = t < raycast.BIG
    k = QUERY_TWIN_RAYS
    with plain_versions():
        (tw, nw), twin_ms = once_ms(lambda: raycast.all_hits(world, o_dev[:k], d_dev[:k], True,
                                                             qf))
    compare("ray_cast hits", hit[:k], tw < raycast.BIG)
    err_t = compare("ray_cast distance", torch.where(hit[:k], t[:k], 0.0),
                    torch.where(hit[:k], tw, 0.0), TOL_ST)
    err_t = max(err_t, compare("ray_cast normal", torch.where(hit[:k, :, None], n[:k], 0.0),
                               torch.where(hit[:k, :, None], nw, 0.0), TOL_ST))
    b_ms, b_by = bound(*ray_work(world, QUERY_RAYS, (t, n)))
    out["ray_cast"] = dict(max_abs_err=err_t,
                           ms=cuda_ms(lambda: raycast.all_hits(world, o_dev, d_dev, True, qf)),
                           plain_ms=twin_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                           rays=QUERY_RAYS, plain_rays=k)
    first = int(hit.any(1).sum())
    say("queries", f"terrain {TERRAIN_N} after {TERRAIN_KERNEL_STEPS} steps, "
        f"{world.colliders.capacity} colliders: shape casts " + "; ".join(hits)
        + f"; rays " + "; ".join(ray_text) + f"; {QUERY_RAYS} rays in {n_launch} launches of T "
        f"(one per shape type), {first} hit something, {int(hit.sum())} (ray, collider) hits; "
        f"launches of these calls: S {got['shape_cast']} (one per bucket of each of the ten "
        f"casts), T {got['ray_cast']}; S against its twin on the five casts "
        f"({twin_cols} colliders: those whose AABB meets the cast's swept box and "
        f"{CCD_TWIN_COLUMNS} seeded ones): max abs err {err_s:.3g}; T on {k} rays: "
        f"{err_t:.3g}; " + show("times", out) + f" [{smi}]")
    return out, got, world


# The grid queries on the queries phase's world: GRID_POINTS points (the first
# GRID_CENTRES at seeded bodies' collider centres, inside them), GRID_BOXES
# AABBs, the five QUERY_SHAPES' intersections, QUERY_RAYS grid rays,
# GRID_CASTERS ray casters (half hollow) and five shape casters; AF, AG, AH
# and S's overlap mode held to their twins on the first QUERY_TWIN_RAYS
# points, rays and boxes.
GRID_POINTS, GRID_CENTRES, GRID_BOXES, GRID_CASTERS = 1024, 256, 64, 256
# Arithmetic operations (not comparisons or selects) of one (point,
# collider) of AF by kind: the two rotations and the kind's own; a hull's
# fixed part (the mean, the steps' updates, the certificate) and, from the
# launch's counters, 5 a vertex row of its scans and 11 a row of the exact
# containment test.
AF_FRAME_OPS = 66
AF_KIND_OPS = {kaf.SPHERE: 20, kaf.CAPSULE: 30, kaf.BOX: 17, kaf.PLANE: 11, kaf.CYLINDER: 50,
               kaf.CONE: 80, kaf.SEGMENT: 9, kaf.MISS: 0, kaf.CONVEX: 520}
AF_SCAN_OPS, AF_EXACT_OPS = 5, 11
# AG: a ray's set-up, each cell's step and key (6) and binary search (3 a
# probe), each test's rotations (93) beside T's RAY_OPS or a hull's march.
AG_RAY_OPS, AG_CELL_OPS, AG_PROBE_OPS, AG_TEST_OPS = 40, 8, 3, 93


def af_work(world, p_n, work):
    """(bytes, operations) of AF on ``p_n`` points: the points, the
    colliders' rows and the pool read once, 17 bytes written a pair; each
    pair's kind operations and the launch's counted vertex rows."""
    m = world.colliders.capacity
    kinds = qpoint.point_kinds(world)
    io = 12 * p_n + 60 * m + 12 * int(world.convex_verts.shape[0]) + 17 * p_n * m
    per = sum(AF_KIND_OPS[k] * int((kinds == k).sum()) for k in kaf.KINDS)
    ops = p_n * (m * AF_FRAME_OPS + per) + AF_SCAN_OPS * int(work[0]) + AF_EXACT_OPS * int(work[1])
    return io, ops


def ag_work(world, grid, r_n, cells, work):
    """(bytes, operations) of AG on ``r_n`` rays: the rays, the grid, the
    colliders' rows and the pool read once, 20 bytes written a ray; each
    ray's walk and binary searches, and the launch's counted tests (T's
    ``RAY_OPS`` an analytic one, ``ray_work``'s march a hull vertex row)."""
    m, ne = world.colliders.capacity, grid.skey.shape[0]
    io = 29 * r_n + 8 * ne + 5 * grid.global_idx.shape[0] + 65 * m \
        + 12 * int(world.convex_verts.shape[0]) + 20 * r_n
    probes = math.ceil(math.log2(ne + 1))
    ops = r_n * (AG_RAY_OPS + cells * (AG_CELL_OPS + AG_PROBE_OPS * probes)) \
        + int(work[0]) * (AG_TEST_OPS + RAY_OPS) \
        + int(work[1]) * (AG_TEST_OPS + 500) + int(work[2]) * (24 * 13 + 8) * HULL_SCAN_OPS
    return io, ops


def grid_against_brute_force(world, grid, o, d, window):
    """AG with ``window`` against T's brute force on the rays (``o``, ``d``
    unit, on the card), both solid, up to ``QUERY_MAX_DISTANCE``: the rays
    whose hit flag differs, and whose grid hit is not the brute force's
    nearest (its distance, and the brute force's own distance of the grid's
    collider)."""
    grid_hit = cast_ray_grid(world, grid, o, d, QUERY_MAX_DISTANCE, True, cell_window=window)
    d = vec.normalize_or_rn(d, torch.tensor([1.0, 0.0, 0.0], device=d.device))  # as the grid's
    t, _ = raycast.all_hits(world, o, d, True, QueryFilter())
    t = torch.where(t <= QUERY_MAX_DISTANCE, t, raycast.BIG)
    nearest = t.amin(1)
    flag = grid_hit.hit != (nearest < raycast.BIG)
    ci = grid_hit.collider.clamp(min=0).long()
    own = t.gather(1, ci[:, None])[:, 0]
    off = grid_hit.hit & ((grid_hit.distance != nearest) | (own != grid_hit.distance))
    return int(flag.sum()), int(off.sum()), torch.nonzero(flag | off)[:8, 0].tolist()


def phase_grid_queries(device, smi, world):
    """Point projections, intersections, the query grid and the persistent
    casters on the queries phase's world, as a user makes them:
    ``project_point`` and ``point_intersections`` of ``GRID_POINTS`` seeded
    points (the first ``GRID_CENTRES`` at collider centres of seeded bodies,
    each inside its collider, hulls included), ``project_point_predicate``,
    ``aabb_intersections`` of ``GRID_BOXES`` boxes, ``shape_intersections``
    of the five ``QUERY_SHAPES`` at seeded bodies, ``cast_ray_grid`` on
    ``query_rays(5)``, ``GRID_CASTERS`` ray casters from seeded bodies'
    collider centres (half hollow; with a window that holds every cell run)
    and five shape casters. The launch counts are those of these
    calls alone. Then AF, AG, AH and S's overlap mode against their twins
    (the first ``QUERY_TWIN_RAYS`` points, rays and boxes; the five shapes),
    E's cell keys against the reference's packing of the unclamped cell
    coordinates, AG against T's brute force with a window that holds every
    cell run (no ray may differ) and at the default (the rays that differ
    are counted), and the times. Returns ({name: measurements}, launch
    counts)."""
    col = world.colliders
    rng = np.random.default_rng(13)
    pos, _ = bp_m.collider_poses(world)
    dynamic = torch.nonzero(world.bodies.body_type[col.body_idx.long()] == int(BodyType.DYNAMIC)
                            & col.active)[:, 0]
    picks = dynamic[torch.from_numpy(rng.choice(dynamic.numel(), GRID_CENTRES + GRID_CASTERS
                                                + 5, replace=False)).to(device)]
    centres = picks[:GRID_CENTRES]
    reach = 0.75 * (TERRAIN_FIELD - 1) / 2
    pts = torch.cat([pos[centres].cpu(), torch.from_numpy(np.stack([
        rng.uniform(-reach, reach, GRID_POINTS - GRID_CENTRES),
        rng.uniform(-1.0, 6.0, GRID_POINTS - GRID_CENTRES),
        rng.uniform(-reach, reach, GRID_POINTS - GRID_CENTRES)], 1).astype(np.float32))])
    box_lo = rng.uniform([-reach, -1.0, -reach], [reach, 4.0, reach], (GRID_BOXES, 3))
    box_hi = box_lo + rng.uniform(0.2, 3.0, (GRID_BOXES, 3))
    shape_at = pos[picks[GRID_CENTRES + GRID_CASTERS:]].tolist()
    shapes = [(st, params, tuple(at), tuple(float(x) for x in q / np.linalg.norm(q)))
              for (st, params), at, q in zip(QUERY_SHAPES, shape_at, rng.normal(size=(5, 4)))]
    casters = RayCasters.create([
        dict(body=int(col.body_idx[c]), origin=tuple(col.local_pos[c].tolist()),
             direction=tuple(rng.normal(size=3) * [1.0, 0.2, 1.0] - [0.0, 1.0, 0.0]),
             max_distance=QUERY_MAX_DISTANCE, solid=k % 2 == 0)
        for k, c in enumerate(picks[GRID_CENTRES:GRID_CENTRES + GRID_CASTERS].tolist())],
        device=device)
    shape_casters = ShapeCasters.create([
        dict(shape_type=st, params=params, body=int(col.body_idx[picks[k]]) if k % 2 else -1,
             origin=(0.0, 3.0, 0.0) if k % 2 else (float(rng.uniform(-reach, reach)), 15.0,
                                                   float(rng.uniform(-reach, reach))),
             direction=(0.0, -1.0, 0.0), max_distance=QUERY_MAX_DISTANCE)
        for k, (st, params) in enumerate(QUERY_SHAPES)], device=device)
    origins, dirs = query_rays(5)
    o_dev, d_dev = origins.to(device), dirs.to(device)
    no_box = lambda w, ids: w.colliders.shape_type[ids] != int(ShapeType.BOX)  # noqa: E731
    torch.cuda.synchronize()

    kernels.reset_launches()
    projected = [project_point(world, p) for p in pts]
    listed = [point_intersections(world, p) for p in pts]
    predicated = [project_point_predicate(world, p, no_box) for p in pts[:16]]
    boxes = [aabb_intersections(world, lo, hi) for lo, hi in zip(box_lo, box_hi)]
    shaped = [shape_intersections(world, *shape) for shape in shapes]
    grid = build_query_grid(world)
    rays = cast_ray_grid(world, grid, o_dev, d_dev, QUERY_MAX_DISTANCE)
    runs = torch.unique_consecutive(grid.skey, return_counts=True)[1][:-1]
    longest = int(runs.max())
    cast = update_ray_casters(world, casters, grid, cell_window=max(longest, 32))
    shape_cast = update_shape_casters(world, shape_casters)
    torch.cuda.synchronize()
    got = kernels.launches()

    want = dict(point_3d=2 * GRID_POINTS + 16, ray_cast_grid=2, aabb_overlap=GRID_BOXES)
    if any(got[k] < v for k, v in want.items()) or got["shape_overlap"] < 5 \
            or got["shape_cast"] < 5:
        raise AssertionError(f"grid queries: AF, AG, AH and S did not carry the calls: {got}")
    inside = torch.stack([r["is_inside"] for r in projected[:GRID_CENTRES]])
    lists = torch.stack(listed[:GRID_CENTRES])
    own = (lists == centres[:, None].to(torch.int32)).any(1)
    if not (bool(inside.all()) and bool(own.all())):
        raise AssertionError(f"grid queries: {int((~inside).sum())} of the {GRID_CENTRES} "
                             f"collider centres reported outside, {int((~own).sum())} not listed")
    hulls = int((col.shape_type[centres] == int(ShapeType.CONVEX)).sum())
    if hulls == 0 or not all(bool(r["hit"]) for r in predicated):
        raise AssertionError("grid queries: no hull among the centres, or a predicate missed")
    if sum(int(b[0]) >= 0 for b in boxes) < GRID_BOXES // 2 \
            or not all(int(x[0]) >= 0 for x in shaped):
        raise AssertionError("grid queries: the boxes or a shape intersected too little")
    hollow = ~casters.solid & casters.enabled
    if not bool((cast.distance[~hollow] == 0.0).all()):
        raise AssertionError("grid queries: a solid caster at its collider's centre missed 0")
    if int(shape_cast.hit.sum()) < 3 or int(rays.hit.sum()) < QUERY_RAYS // 2:
        raise AssertionError("grid queries: the shape casters or the grid rays hit too little")

    # The kernels against their twins.
    k = QUERY_TWIN_RAYS
    work_f = torch.zeros(2, dtype=torch.int64, device=device)
    dist, closest, ins = qpoint.all_point_hits(world, pts[:k], work_f)
    with plain_versions():
        (dist_w, closest_w, ins_w), twin_ms_f = once_ms(
            lambda: qpoint.all_point_hits(world, pts[:k]))
    compare("point_3d inside", ins, ins_w)
    err_f = max(compare("point_3d distance", dist, dist_w, TOL_ST),
                compare("point_3d closest", closest, closest_w, TOL_ST))
    work_all = torch.zeros(2, dtype=torch.int64, device=device)
    qpoint.all_point_hits(world, pts, work_all)
    w_grid = torch.zeros(3, dtype=torch.int64, device=device)
    md = torch.full((QUERY_RAYS,), QUERY_MAX_DISTANCE, device=device)
    solid = torch.ones(QUERY_RAYS, dtype=torch.bool, device=device)
    tabs = accel.grid_tables(world, grid, QueryFilter())
    rays_in = torch.cat([o_dev, d_dev], 1).contiguous()
    t_g, n_g, c_g = kag.ray_cast_grid(rays_in, md, solid, tabs, work=w_grid)
    with plain_versions():
        (t_w, n_w, c_w), twin_ms_g = once_ms(lambda: kag.ray_cast_grid(
            rays_in[:k], md[:k], solid[:k], tabs))
    compare("ray_cast_grid collider", c_g[:k], c_w)
    err_g = max(compare("ray_cast_grid distance", t_g[:k], t_w, TOL_ST),
                compare("ray_cast_grid normal", n_g[:k], n_w, TOL_ST))
    lo_t = torch.from_numpy(box_lo.astype(np.float32)).to(device)
    hi_t = torch.from_numpy(box_hi.astype(np.float32)).to(device)
    over = qintersect.all_aabb_overlaps(world, lo_t, hi_t)
    with plain_versions():
        over_w, twin_ms_h = once_ms(lambda: qintersect.all_aabb_overlaps(world, lo_t, hi_t))
    compare("aabb_overlap", over, over_w)
    twin_ms_s, err_s = 0.0, 0.0
    for shape in shapes:
        flags = qintersect.shape_overlaps(world, *shape)
        with plain_versions():
            flags_w, ms = once_ms(lambda shape=shape: qintersect.shape_overlaps(world, *shape))
        compare(f"shape_overlap {ShapeType(shape[0]).name}", flags, flags_w)
        twin_ms_s = twin_ms_s if shape[0] != int(ShapeType.SPHERE) else ms

    # E's keys against the reference's packing of the unclamped cell
    # coordinates (accel.py:_pack of floor(aabb / cell)), and how far the
    # in-grid coordinates stay from E's clamp.
    cell, in_grid, _ = bp_m.sweep_cell(col)
    lo_c, hi_c = torch.floor(col.aabb_min / cell), torch.floor(col.aabb_max / cell)
    reach_cells = float(torch.cat([lo_c[in_grid], hi_c[in_grid]]).abs().max())
    if reach_cells >= ke._CELL_LIMIT:
        raise AssertionError(f"grid queries: a cell coordinate reaches E's clamp: {reach_cells}")
    cc = lo_c.to(torch.int32)[:, None, :] + torch.tensor(ke._CELL_OFFSETS, dtype=torch.int32,
                                                         device=device)
    inside_aabb = (cc <= hi_c.to(torch.int32)[:, None, :]).all(-1) & in_grid[:, None]
    # One scene: E's int64 keys are the 32-bit packing.
    packed = torch.where(inside_aabb, kb.cell_key(cc), kb.SENTINEL).reshape(-1).long()
    compare("cell_keys against the unclamped packing",
            ke.cell_keys(world.bodies, col, cell, in_grid)[0], packed)
    # AG against T's brute force: every run in the window, then the default.
    full = grid_against_brute_force(world, grid, o_dev, d_dev, max(longest, 32))
    if full[0] or full[1]:
        raise AssertionError(f"grid queries: with a window of {longest} AG parts from T's brute "
                             f"force on {full[0]} hit flags and {full[1]} hits (rays {full[2]})")
    cut = grid_against_brute_force(world, grid, o_dev, d_dev, 32)
    # The hollow casters against T's brute force with solid=False.
    o_c, d_c = accel._attached(world, casters.body, casters.origin, casters.direction)
    d_c = vec.normalize_or_rn(d_c, torch.tensor([1.0, 0.0, 0.0], device=device))
    t_c, _ = raycast.all_hits(world, o_c[hollow], d_c[hollow], False, QueryFilter())
    t_c = torch.where(t_c <= QUERY_MAX_DISTANCE, t_c, raycast.BIG).amin(1)
    t_c = torch.where(t_c < raycast.BIG, t_c, float("inf"))
    if not bool((cast.distance[hollow] == t_c).all()):
        raise AssertionError(f"grid queries: {int((cast.distance[hollow] != t_c).sum())} hollow "
                             "casters part from T's brute force with solid=False")

    # Times: the public calls' kernels at the main path's widths.
    out = {}
    b_ms, b_by = bound(*af_work(world, GRID_POINTS, work_all))
    out["point_3d"] = dict(max_abs_err=err_f, plain_ms=twin_ms_f, bound_ms=b_ms, bound_by=b_by,
                           ms=cuda_ms(lambda: qpoint.all_point_hits(world, pts)),
                           library_ms=None, points=GRID_POINTS, plain_points=k)
    b_ms, b_by = bound(*ag_work(world, grid, QUERY_RAYS, 64, w_grid))
    out["ray_cast_grid"] = dict(
        max_abs_err=err_g, plain_ms=twin_ms_g, bound_ms=b_ms, bound_by=b_by,
        ms=cuda_ms(lambda: kag.ray_cast_grid(rays_in, md, solid, tabs)), library_ms=None,
        rays=QUERY_RAYS, plain_rays=k)
    m = col.capacity
    b_ms, b_by = bound(24 * GRID_BOXES + 25 * m + GRID_BOXES * m, 0)
    out["aabb_overlap"] = dict(
        max_abs_err=0.0, plain_ms=twin_ms_h, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        ms=cuda_ms(lambda: qintersect.all_aabb_overlaps(world, lo_t, hi_t)), boxes=GRID_BOXES)
    # The query grid (E's keys and a sort): its time, its plain version's,
    # and its bound (the AABBs and the flags read, the keys written, sorted
    # and their colliders written; the sort's comparisons not counted).
    grid_ms = cuda_ms(lambda: build_query_grid(world))
    with plain_versions():
        plain_grid, grid_twin_ms = once_ms(lambda: build_query_grid(world))
    compare("query grid keys", grid.skey, plain_grid.skey)
    compare("query grid colliders", grid.scol, plain_grid.scol)
    ne = grid.skey.shape[0]
    grid_bound, grid_by = bound(25 * m + 4 * ne + 8 * ne, 0)
    sphere = shapes[0]
    query, _, res, _ = shapecast.cast_setup(world, sphere[0], sphere[1], sphere[2], sphere[3],
                                            (1.0, 0.0, 0.0), 0.0)
    b_ms, b_by = bound(*cast_work(world, sphere[0], torch.zeros(m, dtype=torch.int32,
                                                                device=device), res))
    out["shape_overlap"] = dict(max_abs_err=err_s, plain_ms=twin_ms_s, bound_ms=b_ms,
                                bound_by=b_by, library_ms=None,
                                ms=cuda_ms(lambda: qintersect.shape_overlaps(world, *sphere)))
    say("grid queries", f"terrain {TERRAIN_N} after {TERRAIN_KERNEL_STEPS} steps, {m} colliders: "
        f"{GRID_POINTS} points ({GRID_CENTRES} at collider centres, {hulls} of them hulls, all "
        f"inside and listed), {GRID_BOXES} boxes, five shapes' intersections "
        f"({[int((x >= 0).sum()) for x in shaped]} listed), {QUERY_RAYS} grid rays "
        f"({int(rays.hit.sum())} hit), {GRID_CASTERS} ray casters ({int(cast.hit.sum())} hit; "
        f"the {int(hollow.sum())} hollow ones equal to T's brute force, from inside their "
        f"colliders at {float(cast.distance[hollow].min()):.3f}-"
        f"{float(cast.distance[hollow].max()):.3f} m), "
        f"five shape casters ({int(shape_cast.hit.sum())} hit); launches of these calls: "
        f"{dict((k, got[k]) for k in GRID_KERNELS + ('shape_cast', 'collider_aabbs'))}; "
        f"AF, AG, AH and S's overlap mode against their twins on {k} points, {k} rays, "
        f"{GRID_BOXES} boxes and five shapes: max abs err {max(err_f, err_g, err_s):.3g}; "
        f"AG against T's brute force on {QUERY_RAYS} rays: with a window of {longest} (the "
        f"longest cell run) 0 differ, at the default 32 {cut[0]} hit flags and {cut[1]} hits "
        f"differ (rays {cut[2]}); hull rows scanned: Frank-Wolfe {int(work_all[0])}, exact "
        f"{int(work_all[1])}; AG's tests: {int(w_grid[0])} analytic, {int(w_grid[1])} hulls; "
        f"E's keys equal to the unclamped packing, cell coordinates within "
        f"{reach_cells:.0f} of 0 (the clamp {ke._CELL_LIMIT:.0e}); "
        f"the query grid ({ne} entries, E's keys and a sort, equal to its plain version): "
        f"{grid_ms:.4f} ms, plain {grid_twin_ms:.4f} ms, bound {grid_bound:.5f} ms ({grid_by}); "
        + show("times", out) + f" [{smi}]")
    return out, got


# The contact queries, the character and picking on the queries phase's world
# (phase tools3d): TOOLS_PAIRS seeded pairs of its broadphase buffer (at
# least TOOLS_PAIR_MIN of each canonical pair present, a seeded half swapped)
# closing at up to TOOLS_SPEED m/s for TOOLS_MAX_T; AI against its twin on
# TOOLS_TWIN_PAIRS of them, on CPU copies.
TOOLS_PAIRS, TOOLS_PAIR_MIN, TOOLS_TWIN_PAIRS = 65_536, 64, 4096
TOOLS_SPEED, TOOLS_MAX_T = 300.0, 1.0 / 60.0
# The character: a capsule of half height 0.5 and radius 0.4 walking at
# CHARACTER_WALK m/s (reset every frame, as the examples do) from the field's
# -x edge into the pile for CHARACTER_FRAMES frames at 30 Hz; its lowest point
# and its depth in a collider (by AF at CHARACTER_AXIS_POINTS points along its
# axis) within TERRAIN_BELOW_TOL of the field and of the skin. The first
# CHARACTER_PLAIN_FRAMES frames on CHARACTER_PLAIN's terrain after
# CHARACTER_PLAIN_STEPS steps, on the kernels and on the plain versions (CPU
# copies), bit for bit.
CHARACTER_PARAMS = (0.5, 0.4)
CHARACTER_FRAMES, CHARACTER_DT, CHARACTER_WALK = 120, 1.0 / 30.0, (2.0, -1.0, 0.3)
CHARACTER_AXIS_POINTS = 17
CHARACTER_PLAIN = dict(n=300, per_row=12, field=17)
CHARACTER_PLAIN_STEPS, CHARACTER_PLAIN_FRAMES = 20, 5
PICK_2D_POINTERS = 64


def tools_pairs(world, seed):
    """``TOOLS_PAIRS`` pairs of ``world``'s next broadphase as
    ``contact_query`` takes them: (type_a, pos_a, quat_a, params_a, vel_a,
    type_b, pos_b, quat_b, params_b, vel_b) with a leading [P], on the card,
    and the canonical pairs present. Every canonical pair of the buffer is
    among the first pairs; a seeded half is swapped; a closes on b along the
    line of their centres (with some drift) at a seeded 0-``TOOLS_SPEED``
    m/s."""
    w2, pos, quat = bp_m.update_aabbs_and_poses(world, TERRAIN_CONFIG)
    bp = bp_m.broad_phase(w2, TERRAIN_CONFIG)
    col, dev = w2.colliders, world.device
    slots = torch.nonzero(bp.valid)[:, 0]
    ca, cb = bp.collider_a[slots].long(), bp.collider_b[slots].long()
    st = col.shape_type
    code = (torch.minimum(st[ca], st[cb]) * 16 + torch.maximum(st[ca], st[cb])).cpu().numpy()
    rng = np.random.default_rng(seed)
    first = np.concatenate([np.flatnonzero(code == c)[:TOOLS_PAIR_MIN] for c in np.unique(code)])
    rest = rng.choice(code.shape[0], TOOLS_PAIRS - first.shape[0],
                      replace=code.shape[0] < TOOLS_PAIRS)
    pick = torch.from_numpy(np.concatenate([first, rest])).to(dev)
    swap = torch.from_numpy(rng.random(TOOLS_PAIRS) < 0.5).to(dev)
    a = torch.where(swap, cb[pick], ca[pick])
    b = torch.where(swap, ca[pick], cb[pick])
    line = vec.normalize_or_rn(pos[b] - pos[a], torch.eye(3, device=dev)[0])
    drift = torch.from_numpy(rng.normal(size=(TOOLS_PAIRS, 3)).astype(np.float32)).to(dev)
    speed = torch.from_numpy(rng.uniform(0.0, TOOLS_SPEED, TOOLS_PAIRS).astype(np.float32))
    rel = (line + 0.2 * drift) * speed.to(dev)[:, None]
    pairs = (st[a], pos[a], quat[a], col.params[a], rel, st[b], pos[b], quat[b], col.params[b],
             torch.zeros_like(rel))
    return tuple(x.contiguous() for x in pairs), sorted(divmod(int(c), 16) for c in np.unique(code))


def toi_work(pairs, pool, rounds):
    """(bytes, operations) of Kernel AI on ``pairs``: each pair's row read and
    its results written once, the pool read once; each pair's rounds at its
    kernel's ``MANIFOLD_OPS`` and ``ROUND_OPS``, and for each pool-backed side
    its hull's fixed and per-vertex operations (as Kernel P's bound)."""
    ta, _, _, prm_a, _, tb, _, _, prm_b, _ = pairs
    p_n = ta.shape[0]
    io = (4 + 8 + 2 * 4 * (3 + 4 + 8) + 12 + 4 + 1 + 4) * p_n + nbytes(pool)
    lo, hi = torch.minimum(ta, tb), torch.maximum(ta, tb)
    ops = 0
    for pair in {tuple(x) for x in torch.stack([lo, hi], 1).tolist()}:
        if pair not in PAIR_KERNELS:
            continue
        name = PAIR_KERNELS[pair][1]
        sel = (lo == pair[0]) & (hi == pair[1])
        per = torch.full_like(ta, MANIFOLD_OPS[name] + ROUND_OPS, dtype=torch.int64)
        if name in OPS_PER_HULL:
            for t_side, prm in ((ta, prm_a), (tb, prm_b)):
                hull = t_side == int(ShapeType.CONVEX)
                per = per + torch.where(hull, OPS_PER_HULL[name] + OPS_PER_HULL_VERTEX[name]
                                        * prm[:, 1].long(), 0)
        ops += int((per * rounds.long())[sel].sum())
    return io, ops


def counting_syncs(fn):
    """``(fn(), where it synchronized)``: the ``file:line`` of each host read
    or blocking copy ``fn`` made, by PyTorch's sync debug mode, each at the
    innermost frame of the repo's own code that led to it (and the
    library's frame after it, where the read happened inside a library)."""
    import traceback

    torch.cuda.synchronize()
    sites = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()[:-1]
                if f.filename.startswith(ROOT) and f.filename != os.path.abspath(__file__)]
        site = f"{os.path.relpath(ours[-1].filename, ROOT)}:{ours[-1].lineno}" if ours else ""
        if not filename.startswith(ROOT):
            site += f" ({filename}:{lineno})"
        sites.append(site)

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sites


def character_frames(world, pos, frames, walk=None):
    """``frames`` frames of ``move_and_slide`` of the capsule from ``pos``
    (f32[3] on the world's device), the velocity reset to ``walk`` every
    frame: f32[F, 3, 3] of (position, velocity, last normal)."""
    dev = world.device
    walk = torch.tensor(CHARACTER_WALK if walk is None else walk, device=dev)
    quat = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)
    return _frames(world, pos, quat, walk, frames)


def _frames(world, pos, quat, walk, frames, syncs=None):
    """``character_frames`` from device tensors; with ``syncs`` (a list),
    each frame's synchronizing calls (``counting_syncs``) are appended."""
    out = []
    for _ in range(frames):
        def frame(pos=pos):
            return char3d.move_and_slide(world, ShapeType.CAPSULE, CHARACTER_PARAMS, pos, quat,
                                         walk, CHARACTER_DT)

        if syncs is None:
            pos, vel, normal = frame()
        else:
            (pos, vel, normal), where = counting_syncs(frame)
            syncs.append(where)
        out.append(torch.stack([pos, vel, normal]))
    return torch.stack(out)


def port_world(device, bodies, max_bodies):
    """A world of static bodies ``(pos, quat, shape, args)`` on a half-space,
    built by the port's builder, its AABBs stored."""
    b = SceneBuilder()
    b.half_space(b.add_body(body_type=BodyType.STATIC), normal=(0, 1, 0))
    for pos, quat, shape, args in bodies:
        getattr(b, shape)(b.add_body(body_type=BodyType.STATIC, pos=pos, quat=quat), *args)
    world = b.finalize(max_bodies=max_bodies, max_colliders=max_bodies,
                       max_contacts=4 * max_bodies, device=device)
    return bp_m.update_aabbs(world, PhysicsConfig())


def character_examples(device):
    """``examples/kinematic_character_3d.py``, ``character_walk.py`` and
    ``move_and_slide_3d.py``: their worlds, frames and checks, through the
    port on the card. Returns one line of text."""
    ident = (0.0, 0.0, 0.0, 1.0)
    quat = torch.tensor(ident, device=device)
    s, c = np.sin(np.pi / 28.0), np.cos(np.pi / 28.0)
    kinematic = port_world(device, [((2.6, 0.28, 0.0), (0.0, 0.0, s, c), "box", (1.6, 0.08, 2.0)),
                                    ((5.6, 0.52, 0.0), ident, "box", (1.6, 0.08, 2.0)),
                                    ((7.6, 2.0, 0.0), ident, "box", (0.3, 2.0, 4.0))], 8)
    p = _frames(kinematic, torch.tensor([0.0, 0.91, 0.0], device=device), quat,
                torch.tensor([2.0, -1.0, 0.0], device=device), 120)[-1, 0].cpu().numpy()
    if not (np.isfinite(p).all() and 5.5 < p[0] < 7.05 and p[1] > 1.3):
        raise AssertionError(f"kinematic_character_3d: ended at {p}")
    text = [f"kinematic_character_3d at x {p[0]:.2f}, y {p[1]:.2f}"]
    walk = port_world(device, [((2.5, 0.15, 0.0), ident, "box", (0.8, 0.15, 3.0)),
                               ((6.0, 1.5, 0.0), ident, "box", (0.3, 3.0, 8.0))], 4)
    pos = torch.tensor([0.0, 0.91, 0.0], device=device)
    vel = torch.tensor([2.0, -1.0, 0.0], device=device)
    for _ in range(90):
        pos, vel, _ = char3d.move_and_slide(walk, ShapeType.CAPSULE, CHARACTER_PARAMS, pos, quat,
                                            vel, 1.0 / 30.0)
        vel = vel.clone()
        vel[0] = 2.0
        vel[1] = torch.clamp(vel[1], min=-1.0) - 0.3
    p = pos.cpu().numpy()
    if not (np.isfinite(p).all() and 4.0 < p[0] < 5.75 - 0.4 + 0.05 and p[1] > 0.8):
        raise AssertionError(f"character_walk: ended at {p}")
    text.append(f"character_walk at x {p[0]:.2f}, y {p[1]:.2f}")
    s8, c8 = np.sin(np.pi / 8), np.cos(np.pi / 8)
    angled = port_world(device, [((4.0, 1.5, 0.0), (0.0, s8, 0.0, c8), "box", (0.3, 3.0, 8.0))], 4)
    p = _frames(angled, torch.tensor([0.0, 0.91, 0.0], device=device), quat,
                torch.tensor([2.0, -1.0, 0.0], device=device), 90)[-1, 0].cpu().numpy()
    n = np.asarray([np.cos(np.pi / 4), 0.0, -np.sin(np.pi / 4)])
    d = float(np.dot(p - np.asarray([4.0, 1.5, 0.0]), n))
    if not (np.isfinite(p).all() and d < -0.55 and p[0] > 1.5 and abs(p[2]) > 0.8):
        raise AssertionError(f"move_and_slide_3d: ended at {p}, {d} m from the wall plane")
    text.append(f"move_and_slide_3d at x {p[0]:.2f}, z {p[2]:.2f}, {d:.2f} m from the wall")
    return ", ".join(text)


def picking_example(device):
    """``examples/picking_demo.py``'s world and checks on the card."""
    ident = (0.0, 0.0, 0.0, 1.0)
    b = SceneBuilder()
    for x in (-2.0, 0.0, 2.0):
        b.sphere(b.add_body(body_type=BodyType.STATIC, pos=(x, 0.0, 0.0), quat=ident), 0.5)
    world = bp_m.update_aabbs(b.finalize(max_bodies=4, max_colliders=4, max_contacts=8,
                                         device=device), PhysicsConfig(max_colors=4))
    hits = picking.pick_batch(world, [(-2.0, 5.0, 0.0), (0.0, 5.0, 0.0), (2.0, 5.0, 0.0)],
                              [(0.0, -1.0, 0.0)] * 3)
    picked = hits.collider.tolist()
    mask = torch.tensor([False, True, False, False], device=device)
    left = picking.pick(world, (-2.0, 5.0, 0.0), (0.0, -1.0, 0.0), pickable=mask)
    middle = picking.pick(world, (0.0, 5.0, 0.0), (0.0, -1.0, 0.0), pickable=mask)
    if picked != [0, 1, 2] or bool(left.hit) or not (bool(middle.hit)
                                                      and int(middle.collider) == 1):
        raise AssertionError(f"picking_demo: picked {picked}, masked {bool(left.hit)}, "
                             f"{int(middle.collider)}")
    return f"picking_demo picked {picked}, its mask respected"


def phase_tools3d(device, smi, world):
    """The 3D contact queries, the character controller and picking on the
    queries phase's world, as a user calls them: ``time_of_impact``,
    ``contact`` and ``contact_manifolds`` on ``TOOLS_PAIRS`` pairs in one call
    each; a capsule driven by ``move_and_slide`` for ``CHARACTER_FRAMES``
    frames across the heightfield and into the pile (its synchronizing calls
    counted); the launch counts are those of these calls alone. Then AI
    against its twin on ``TOOLS_TWIN_PAIRS`` of the pairs (CPU copies, bit for
    bit), ``contact_manifolds`` against ``compute_manifolds``, every frame
    above the field, no deeper than the skin in a collider by S's manifold
    mode across the open field and by AF everywhere (within
    ``TERRAIN_BELOW_TOL``), S's manifold mode against its twin (CPU copies),
    the first
    ``CHARACTER_PLAIN_FRAMES`` frames on a small terrain on the kernels and
    the plain versions (CPU copies), the character and picking examples, and
    ``pick_batch`` of ``QUERY_RAYS`` rays and ``pick_2d`` of
    ``PICK_2D_POINTERS`` pointers against the ray casts they fold the
    pickable mask into. Returns ({name: measurements}, launch counts)."""
    col = world.colliders
    pairs, present = tools_pairs(world, 17)
    kw = dict(shape_pairs=TERRAIN_PAIRS, convex_verts=world.convex_verts)
    shapes = pairs[:4] + pairs[5:9]
    half = (TERRAIN_FIELD - 1) / 2
    heights = scenes.terrain_heights(TERRAIN_FIELD)
    x0, z0 = -half + 1.0, 0.3
    start = torch.tensor([x0, float(scenes.terrain_height_at(heights, [x0], [z0])[0]) + 0.95, z0],
                         device=device)
    walk = torch.tensor(CHARACTER_WALK, device=device)
    ident = torch.tensor([0.0, 0.0, 0.0, 1.0], device=device)
    torch.cuda.synchronize()

    kernels.reset_launches()
    hit, t = cq.time_of_impact(*pairs, TOOLS_MAX_T, **kw)
    found, c_pa, c_pb, c_n, pen = cq.contact(*shapes, **kw)
    man = cq.contact_manifolds(*shapes, **kw)
    torch.cuda.synchronize()
    before = kernels.launches()
    t0 = time.perf_counter()
    frame_syncs = []
    frames = _frames(world, start, ident, walk, CHARACTER_FRAMES, frame_syncs)
    torch.cuda.synchronize()
    frame_ms = 1e3 * (time.perf_counter() - t0) / CHARACTER_FRAMES
    syncs = sum(len(x) for x in frame_syncs)
    sync_sites = sorted(collections.Counter(x for f in frame_syncs for x in f).items())
    # The port's own host reads a frame, and any others (PyTorch's, once).
    ours = [sum(x.startswith("avian_tpu_torch") for x in f) for f in frame_syncs]
    others = [len(f) - n for f, n in zip(frame_syncs, ours)]
    got = kernels.launches()
    in_frames = {k: got[k] - before[k] for k in got}

    # The contact queries: AI against its twin, the manifolds against the
    # narrowphase's.
    if not (got["toi_pair"] > 0 and got["shape_manifold"] > 0 and got["shape_cast"] > 0):
        raise AssertionError(f"tools3d: AI, S or its manifold mode did not run: {got}")
    rng = np.random.default_rng(19)
    sub = torch.from_numpy(rng.choice(TOOLS_PAIRS, TOOLS_TWIN_PAIRS, replace=False)).to(device)
    cpu_pairs = [x[sub].cpu() for x in pairs]
    t1 = time.perf_counter()
    hit_w, t_w = cq.time_of_impact(*cpu_pairs, TOOLS_MAX_T, shape_pairs=TERRAIN_PAIRS,
                                   convex_verts=world.convex_verts.cpu())
    twin_ms_ai = 1e3 * (time.perf_counter() - t1)
    compare("toi_pair hit", hit[sub].cpu(), hit_w)
    err_ai = compare("toi_pair t", t[sub].cpu(), t_w)
    ref, _ = compute_manifolds(
        torch.cat([pairs[0], pairs[5]]), torch.cat([pairs[3], pairs[8]]),
        torch.cat([pairs[1], pairs[6]]), torch.cat([pairs[2], pairs[7]]),
        torch.arange(TOOLS_PAIRS, device=device),
        torch.arange(TOOLS_PAIRS, device=device) + TOOLS_PAIRS,
        torch.ones(TOOLS_PAIRS, dtype=torch.bool, device=device), TERRAIN_PAIRS,
        world.convex_verts)
    for what in ("normal", "point_a", "point_b", "separation", "feature_id", "count"):
        compare(f"contact_manifolds {what}", getattr(man, what), getattr(ref, what))
    order, _, spans = canonical_spans(pairs[0], pairs[5],
                                      torch.ones(TOOLS_PAIRS, dtype=torch.bool, device=device),
                                      TERRAIN_PAIRS)
    order = order.to(torch.int32)
    max_t = torch.full((TOOLS_PAIRS,), TOOLS_MAX_T, device=device)
    tabs = kai.ToiTables(pairs[0], pairs[5], pairs[1], pairs[2], pairs[3], pairs[6], pairs[7],
                         pairs[8], (pairs[4] - pairs[9]).contiguous(), max_t,
                         world.convex_verts.contiguous())
    hit_k, t_k = torch.zeros_like(hit), max_t * 1.01
    rounds = torch.zeros(TOOLS_PAIRS, dtype=torch.int32, device=device)

    def run_ai(rounds=None):
        for pair, a, b in spans:
            kai.toi_pair(pair, order[a:b].contiguous(), tabs, hit_k, t_k, rounds=rounds)

    run_ai(rounds)
    compare("toi_pair against time_of_impact", t_k, t)
    b_ms, b_by = bound(*toi_work(pairs, world.convex_verts, rounds))
    out = {"toi_pair": dict(max_abs_err=err_ai, ms=cuda_ms(run_ai), plain_ms=twin_ms_ai,
                            bound_ms=b_ms, bound_by=b_by, library_ms=None, pairs=TOOLS_PAIRS,
                            plain_pairs=TOOLS_TWIN_PAIRS, plain_device="cpu",
                            mean_rounds=float(rounds.float().mean()))}
    hit_share = float(hit.float().mean())
    pairs_text = (f"{TOOLS_PAIRS} pairs of the broadphase buffer ({len(present)} canonical pairs "
                  f"{present}), closing at 0-{TOOLS_SPEED:.0f} m/s for {TOOLS_MAX_T:.4f} s: "
                  f"time_of_impact hit {hit_share:.4f} of them in "
                  f"{float(rounds.float().mean()):.3f} rounds a pair, contact found "
                  f"{float(found.float().mean()):.4f}; AI equal to its twin on "
                  f"{TOOLS_TWIN_PAIRS} (CPU copies), contact_manifolds to "
                  f"compute_manifolds on all")

    # The character: finite, above the field and out of the colliders. S's
    # manifold mode gives each frame's deepest separation; the geometry (AF's
    # signed distances of points along the capsule's axis) its true depth.
    # The two part where the pair function reports a penetration that is not
    # there (ROADMAP 3b): S's depth is held to the skin across the open
    # field, the true depth everywhere.
    skin = char3d.MoveAndSlideConfig().skin_width
    f_pos = frames[:, 0]
    if not bool(torch.isfinite(frames).all()):
        raise AssertionError("tools3d: the character's state is not finite")
    p_np = f_pos.cpu().numpy().astype(np.float64)
    ground = float((p_np[:, 1] - 0.9
                    - scenes.terrain_height_at(heights, p_np[:, 0], p_np[:, 2])).min())
    plan = shapecast.cast_buckets(world, ShapeType.CAPSULE)
    prm = torch.tensor(CHARACTER_PARAMS, device=device)
    zero3, zero = torch.zeros(3, device=device), torch.zeros((), device=device)
    field = col.active & (col.body_idx == 0)
    s_depth, near = [], []
    for p in f_pos:
        sep, _ = shapecast.manifold_vs_all(plan, ShapeType.CAPSULE,
                                           shapecast.cast_query(prm, p, ident, zero3, zero, device))
        s_depth.append(-torch.where(col.active, sep, 1e9).min())
        near.append((torch.where(col.active & ~field, sep, 1e9) < 2 * skin).any())
    s_depth, near = torch.stack(s_depth).cpu(), torch.stack(near).cpu()
    axis = torch.linspace(-CHARACTER_PARAMS[0], CHARACTER_PARAMS[0], CHARACTER_AXIS_POINTS,
                          device=device)
    pts = f_pos[:, None, :] + torch.stack([zero.expand_as(axis), axis, zero.expand_as(axis)], 1)
    dist, _, _ = qpoint.all_point_hits(world, pts.reshape(-1, 3))
    true_depth = (CHARACTER_PARAMS[1] - torch.where(col.active, dist, 1e9).amin(1)).reshape(
        CHARACTER_FRAMES, -1).amax(1).cpu()
    first = int(near.nonzero()[0, 0]) if bool(near.any()) else CHARACTER_FRAMES
    open_field = float(s_depth[:first].max()) if first else 0.0
    false_deep = int(((s_depth > skin) & (true_depth <= skin)).sum())
    if not (ground >= -TERRAIN_BELOW_TOL and first < CHARACTER_FRAMES and open_field <= skin
            and float(true_depth.max()) <= skin + TERRAIN_BELOW_TOL):
        raise AssertionError(f"tools3d: the character's lowest point {ground} m from the field "
                             f"(limit -{TERRAIN_BELOW_TOL}), {open_field} m into a collider "
                             f"on the open field by S's manifold mode (limit {skin}), "
                             f"{float(true_depth.max())} m by AF (limit "
                             f"{skin + TERRAIN_BELOW_TOL}), near a shape from frame {first}")
    n_buckets = len(plan.buckets)
    want = dict.fromkeys(in_frames, 0)
    want.update(shape_cast=4 * n_buckets * CHARACTER_FRAMES, collider_aabbs=CHARACTER_FRAMES,
                shape_manifold=4 * n_buckets * CHARACTER_FRAMES)
    if in_frames != want or max(ours) > 1 or sum(others[1:]) or others[0] > 1:
        raise AssertionError(f"tools3d: the frames launched {in_frames} (expected {want}) and "
                             f"synchronized {[len(x) for x in frame_syncs]} times a frame, at "
                             f"{sync_sites}")

    # S's manifold mode against its twin (CPU copies), at the last frame.
    query = shapecast.cast_query(prm, f_pos[-1], ident, zero3, zero, device)
    sep_k, n_k = shapecast.manifold_vs_all(plan, ShapeType.CAPSULE, query)
    cpu_plan = shapecast.CastPlan(tuple(x.cpu() for x in plan.tabs),
                                  [(pair, cols.cpu()) for pair, cols in plan.buckets],
                                  plan.swapped.cpu())
    t1 = time.perf_counter()
    sep_w, n_w = shapecast.manifold_vs_all(cpu_plan, ShapeType.CAPSULE, query.cpu())
    twin_ms_m = 1e3 * (time.perf_counter() - t1)
    err_m = max(compare("shape_manifold separation", sep_k.cpu(), sep_w),
                compare("shape_manifold normal", n_k.cpu(), n_w))
    m = col.capacity
    cols_n = sum(int(cols.shape[0]) for _, cols in plan.buckets)
    ops = 0
    for pair, cols in plan.buckets:
        name = PAIR_KERNELS[pair][1]
        ops += int(cols.shape[0]) * MANIFOLD_OPS[name]
        if name in OPS_PER_HULL:
            ops += int(cols.shape[0]) * OPS_PER_HULL[name] + OPS_PER_HULL_VERTEX[name] * int(
                col.params[cols.long(), 1].sum())
    b_ms, b_by = bound(52 * m + nbytes(world.convex_verts) + 16 * cols_n + 80, ops)
    out["shape_manifold"] = dict(
        max_abs_err=err_m, ms=cuda_ms(lambda: shapecast.manifold_vs_all(plan, ShapeType.CAPSULE,
                                                                          query)),
        plain_ms=twin_ms_m, bound_ms=b_ms, bound_by=b_by, library_ms=None, colliders=cols_n,
        plain_device="cpu")

    # The first frames on a small terrain, on the kernels and on the plain
    # versions (CPU copies).
    small, _ = terrain(device, **CHARACTER_PLAIN)
    for _ in range(CHARACTER_PLAIN_STEPS):
        small = physics_step(small, TERRAIN_CONFIG)
    sh = scenes.terrain_heights(CHARACTER_PLAIN["field"])
    xs = -(CHARACTER_PLAIN["field"] - 1) / 2 + 1.0
    s_start = [xs, float(scenes.terrain_height_at(sh, [xs], [z0])[0]) + 0.95, z0]
    on_card = character_frames(small, torch.tensor(s_start, device=device),
                               CHARACTER_PLAIN_FRAMES)
    t1 = time.perf_counter()
    on_cpu = character_frames(small.to("cpu"), torch.tensor(s_start), CHARACTER_PLAIN_FRAMES)
    plain_s = time.perf_counter() - t1
    compare("character frames on the plain versions", on_card.cpu(), on_cpu)

    examples = character_examples(device) + "; " + picking_example(device)

    # Picking: pick_batch against T's argmin with the mask; pick_2d against
    # the 2D ray cast with it.
    o, d = query_rays(5)
    o, d = o.to(device), d.to(device)
    pickable = torch.from_numpy(rng.random(m) < 0.5).to(device)
    picks = picking.pick_batch(world, o, d, pickable=pickable)
    d_n = vec.normalize_or_rn(d, torch.eye(3, device=device)[0])
    t_all, _ = raycast.all_hits(world, o, d_n, True, QueryFilter(excluded=~pickable))
    nearest_i = torch.argmin(t_all, 1)
    t_first = t_all.gather(1, nearest_i[:, None])[:, 0]
    compare("pick_batch collider", picks.collider,
            torch.where(t_first < raycast.BIG, nearest_i, -1).to(torch.int32))
    compare("pick_batch distance", picks.distance,
            torch.where(t_first < raycast.BIG, t_first, float("inf")))
    unpickable = int((picks.hit & ~pickable[picks.collider.clamp(min=0).long()]).sum())
    if unpickable or int(picks.hit.sum()) < QUERY_RAYS // 4:
        raise AssertionError(f"tools3d: pick_batch picked {unpickable} unpickable colliders, "
                             f"{int(picks.hit.sum())} in all")
    w2d, _ = pyramid2d(device)
    for _ in range(DIM2_KERNEL_STEPS):
        w2d = physics_step_2d(w2d, DIM2_CONFIG)
    m2 = w2d.colliders.capacity
    pickable2 = torch.from_numpy(rng.random(m2) < 0.5).to(device)
    excluded2 = QueryFilter(excluded=~pickable2)
    picked_2d = 0
    for k in range(PICK_2D_POINTERS):
        o2 = (float(rng.uniform(-DIM2_BASE / 2, DIM2_BASE / 2)), float(rng.uniform(20.0, 120.0)))
        d2 = (float(rng.uniform(-0.3, 0.3)), -1.0) if k % 4 else (1.0, float(rng.uniform(-0.2, 0)))
        if k % 4 == 0:
            o2 = (-DIM2_BASE, float(rng.uniform(0.5, 40.0)))
        got2 = picking.pick_2d(w2d, o2, d2, pickable=pickable2)
        want2 = q2d.cast_ray(w2d, o2, d2, 1e30, True, excluded2)
        for f in ("collider", "body", "distance", "point", "normal", "hit"):
            compare(f"pick_2d {f}", getattr(got2, f).reshape(-1), getattr(want2, f).reshape(-1))
        picked_2d += int(got2.hit)
    if picked_2d < PICK_2D_POINTERS // 4:
        raise AssertionError(f"tools3d: pick_2d picked {picked_2d} of {PICK_2D_POINTERS}")

    blocked = int((frames[:, 2].abs().sum(1) > 0).sum())
    say("tools3d", f"terrain {TERRAIN_N} after {TERRAIN_KERNEL_STEPS} steps, {m} colliders: "
        + pairs_text + f"; the capsule ({CHARACTER_PARAMS}) {CHARACTER_FRAMES} frames at "
        f"{CHARACTER_WALK} m/s from x {x0}: {frame_ms:.2f} ms a frame, S "
        f"{in_frames['shape_cast'] / CHARACTER_FRAMES:.0f} and its manifold mode "
        f"{in_frames['shape_manifold'] / CHARACTER_FRAMES:.0f} launches a frame ({n_buckets} "
        f"buckets), {syncs} synchronizing calls (host reads) in {CHARACTER_FRAMES} frames, "
        f"at most {max(ours)} a frame in the port ({sync_sites}); ended "
        f"at {[round(x, 3) for x in f_pos[-1].tolist()]}, blocked in {blocked} frames, near a "
        f"shape from frame {first} in {int(near.sum())}; lowest point {ground:.4f} m from the "
        f"field (limit -{TERRAIN_BELOW_TOL}); deepest into a collider by S's manifold mode "
        f"{open_field:.5f} m on the open field (limit {skin}) and {float(s_depth.max()):.5f} m in "
        f"all, deeper than the skin in {int((s_depth > skin).sum())} frames, {false_deep} of "
        f"them not deeper by AF, whose deepest is {float(true_depth.max()):.5f} m (limit "
        f"{skin + TERRAIN_BELOW_TOL}); "
        f"{CHARACTER_PLAIN_FRAMES} frames on terrain_shapes({CHARACTER_PLAIN['n']}, per_row="
        f"{CHARACTER_PLAIN['per_row']}, field={CHARACTER_PLAIN['field']}) equal to the plain "
        f"versions' (CPU copies, {plain_s:.1f} s); {examples}; pick_batch of {QUERY_RAYS} rays "
        f"({int(picks.hit.sum())} picked, half the colliders pickable) equal to T's argmin, "
        f"pick_2d of {PICK_2D_POINTERS} pointers ({picked_2d} picked) equal to the 2D ray cast; "
        f"launches of the calls: {dict((k, got[k]) for k in TOOLS_KERNELS + ('shape_cast',))}; "
        + show("times", out) + f" [{smi}]")
    return out, got


def phase_ccd_plain_path(device):
    """``CCD_PLAIN_N`` bodies and ``CCD_PLAIN_BULLETS`` bullets on the
    terrain: one step on the kernels, then ``CCD_ONE_STEPS`` single steps,
    each from the kernels' state on the kernels and on the plain versions
    alone (while the bullets meet the pile and the field): every body within
    ``CCD_ONE_STEP_TOL`` after each."""
    world, _, shots = ccd_world(device, CCD_PLAIN_N, TERRAIN_PLAIN_PER_ROW, CCD_PLAIN_BULLETS)
    world = physics_step(world, CCD_CONFIG)
    one, swept = [], 0
    t0 = time.perf_counter()
    for _ in range(CCD_ONE_STEPS):
        on_k, diag = physics_step(world, CCD_CONFIG, return_diagnostics=True)
        swept = max(swept, sum(diag["swept_pairs"].values()))
        kernels.reset_launches()
        with plain_versions():
            on_p = physics_step(world, CCD_CONFIG)
        if any(kernels.launches().values()):
            raise AssertionError(f"plain path: kernels were launched: {kernels.launches()}")
        one.append(float((on_k.bodies.pos - on_p.bodies.pos).abs().max()))
        world = on_k
    say("plain path", f"terrain_ccd {CCD_PLAIN_N} + {CCD_PLAIN_BULLETS} bullets, "
        f"{CCD_ONE_STEPS} steps from the kernels' state on each ({swept} swept pairs a step, "
        f"{time.perf_counter() - t0:.1f} s): largest difference of any body's position "
        + ", ".join(f"{d:.2g}" for d in one) + f" m (limit {CCD_ONE_STEP_TOL})")
    if not max(one) <= CCD_ONE_STEP_TOL:
        raise AssertionError(f"plain path: one step of terrain_ccd parts by {max(one)} m "
                             f"(limit {CCD_ONE_STEP_TOL})")


def phase_main_path(device, smi):
    """The 10k pile through ``physics_step``; returns the launch counts."""
    _, got = drive("main", pile(N_CUBES, device), PILE_CONFIG, SETTLE_STEPS + TIMED_STEPS,
                   smi, N_CUBES, timed_from=SETTLE_STEPS)
    return got


def stands(what, start, world, ids, max_dx, max_apex_dy):
    """Fail unless every box of ``ids`` is within ``max_dx`` of its start in
    x (and z) and the highest box within ``max_apex_dy`` of its start in y."""
    dx, dy = moved(start, world, ids)
    if not (dx <= max_dx and dy <= max_apex_dy):
        raise AssertionError(f"{what}: does not stand: sideways {dx} (limit {max_dx}), "
                             f"apex {dy} (limit {max_apex_dy})")
    return f"stands: farthest sideways move {dx:.4f} m, apex moved {dy:.4f} m in y"


def phase_pyramid(device, smi):
    """The box-pyramid path: the base-100 2D-profile pyramid at full width,
    then its free 3D variant and the field of small pyramids. Returns the
    launch counts of the first."""
    config = PILE_CONFIG
    probe_capacity(device)
    world, ids = pyramid(device)
    start = world.bodies.pos.clone()
    world, got = drive("pyramid", world, config, PYRAMID_STEPS, smi, len(ids),
                       watch=(start, ids, PYRAMID_MAX_DX, PYRAMID_MAX_APEX_DY))
    say("pyramid", stands("pyramid", start, world, ids, PYRAMID_MAX_DX, PYRAMID_MAX_APEX_DY))

    world, ids = pyramid(device, dim3_depth=True)
    start = world.bodies.pos.clone()
    world, _ = drive("pyramid3d", world, config, VARIANT_STEPS, smi, len(ids))
    say("pyramid3d", stands("pyramid3d", start, world, ids, PYRAMID3D_MAX_DX,
                            PYRAMID3D_MAX_APEX_DY))

    n_many = MANY_GRID * MANY_GRID * MANY_BASE * (MANY_BASE + 1) // 2 + 1
    world, ids = scenes.many_pyramids(
        MANY_GRID, MANY_BASE, max_contacts=PYRAMID_CONTACTS_PER_BOX * n_many, device=device)
    start = world.bodies.pos.clone()
    world, _ = drive("many_pyramids", world, config, VARIANT_STEPS, smi, len(ids))
    per = MANY_BASE * (MANY_BASE + 1) // 2
    ground_row = [i for k, i in enumerate(ids) if (k // per) % MANY_GRID == 0]
    drop = float((start[:, 1] - world.bodies.pos[:, 1]).max())
    if not drop <= MANY_MAX_DROP:
        raise AssertionError(f"many_pyramids: a box dropped {drop} m (limit {MANY_MAX_DROP})")
    say("many_pyramids", "ground row " + stands(
        "many_pyramids", start, world, ground_row, MANY_MAX_DX, MANY_MAX_APEX_DY)
        + f"; largest drop of any box {drop:.4f} m")
    return got


def twice_equal(what, make, config, steps):
    """Run ``make()`` for ``steps`` steps twice; fail unless the final poses
    and velocities are bitwise equal. Returns the second run's world."""
    finals = []
    for _ in range(2):
        world = make()
        for _ in range(steps):
            world = physics_step(world, config)
        b = world.bodies
        finals.append([getattr(b, k).cpu() for k in ("pos", "quat", "lin_vel", "ang_vel")])
    for x, y in zip(*finals):
        if not torch.equal(x, y):
            raise AssertionError(f"determinism: two runs of {what} differ")
    say("determinism", f"{what} x {steps} steps twice: pos, quat, lin_vel, ang_vel bitwise equal")
    return world


def phase_determinism(device):
    twice_equal(f"pile {DETERMINISM_CUBES}", lambda: pile(DETERMINISM_CUBES, device),
                PILE_CONFIG, DETERMINISM_STEPS)
    # examples/many_shapes.py: its scene, its config, its checks.
    example = PhysicsConfig()
    world = twice_equal("many_shapes 150", lambda: scenes.many_shapes(device=device)[0],
                        example, EXAMPLE_SHAPES_STEPS)
    ids = scenes.many_shapes(device="cpu")[1]  # the same layout, for its body ids
    pos = world.bodies.pos[ids]
    if not (bool(torch.isfinite(pos).all()) and float(pos[:, 1].min()) > 0.0):
        raise AssertionError("many_shapes: diverged or fell through the plane")
    say("determinism", f"many_shapes OK: 150 mixed shapes, min y {float(pos[:, 1].min()):.2f}, "
        f"sleeping {int(world.bodies.sleeping[ids].sum())}/150")
    twice_equal("terrain_shapes({n}, per_row={per_row}, field={field})".format(
        **DETERMINISM_TERRAIN), lambda: terrain(device, **DETERMINISM_TERRAIN)[0],
        TERRAIN_CONFIG, DETERMINISM_TERRAIN_STEPS)
    twice_equal("terrain_ccd({n}, per_row={per_row}, bullets={bullets}, field={field})".format(
        **DETERMINISM_CCD), lambda: scenes.terrain_ccd(**DETERMINISM_CCD, device=device)[0],
        CCD_CONFIG, DETERMINISM_CCD_STEPS)
    rows, cols = DETERMINISM_HINGE_ROWS, DETERMINISM_HINGE_COLS
    # The reference's determinism scene and protocol: 500 steps at 64 Hz.
    twice_equal(f"falling_hinges {rows} x {cols}",
                lambda: scenes.falling_hinges(rows, cols, device=device)[0],
                GOLDEN_CONFIG, GOLDEN_STEPS)


# ---- the native 2D engine: Kernels U-Z ------------------------------------

DIM2_BASE = 100
DIM2_SLOTS_PER_BOX = 24  # the reference's 8 drop rows in the first steps (ROADMAP 3b)
DIM2_CONFIG = PhysicsConfig(substeps=4, max_colors=8)
DIM2_KERNEL_STEPS = 30
DIM2_STEPS, MANY2D_STEPS = 120, 30
MANY2D_GRID, MANY2D_BASE = 10, 10
DIM2_REST_Y, DIM2_REST_TOL = 0.5, 0.05
# The reference's curve, recorded on XLA:CPU by
# tests/torch_cases/record_pyramid2d_curve.py: the apex box's height and the
# lowest box's over 60 steps. Bands written down before the first chip run.
DIM2_CURVE = os.path.join(ROOT, "tests", "torch_cases", "pyramid2d_curve.npz")
# While the overflow colour drains (steps 1-30) the port on the CPU follows
# the reference to 3e-5 m; in the rebound after it the apex parts by up to
# 0.16 m by step 60 on the same arithmetic (the colouring of a few rows
# differs), so the band widens there.
DIM2_APEX_BAND_STEPS = 30
DIM2_APEX_BAND, DIM2_APEX_BAND_LATE, DIM2_LOWEST_BAND = 0.01, 0.3, 0.002
DIM2_PLAIN_STEPS, DIM2_PLAIN_EXACT_STEPS, DIM2_PLAIN_TIGHT_STEPS = 40, 8, 10
DIM2_PLAIN_TOL, DIM2_PLAIN_APEX_TOL = 2e-3, 0.05
DIM2_DETERMINISM_STEPS = 30
TOL_Y = 1e-5  # the overflow colour's twin sums with index_add_; cosf/sinf in the kernel
TOL_WRITEBACK = 1e-6  # cosf/sinf of the new angle in the kernel, torch.cos/sin in the twin
DIM2_RANDOM_PAIRS = 4096
# V's pair kinds, as kinds of _random_shape: 0 circle, 1-6 polygons, 7 plane.
DIM2_PAIR_KINDS = {"plane/plane": ((7,), (7,)), "poly/plane": ((1, 2, 3, 4, 5, 6), (7,)),
                   "plane/poly": ((7,), (1, 2, 3, 4, 5, 6)), "circle/circle": ((0,), (0,)),
                   "circle/poly": ((0,), (1, 2, 3, 4, 5, 6)),
                   "poly/circle": ((1, 2, 3, 4, 5, 6), (0,)),
                   "poly/poly": ((1, 2, 3, 4, 5, 6), (1, 2, 3, 4, 5, 6))}
# Operations a pair of each kind does in Kernel V (two 8 x 8 SATs, the
# incident edge and the clip; 8 edge projections; 8 vertex depths).
V_OPS = {"poly/poly": 1_500, "circle/poly": 250, "poly/plane": 120, "circle/circle": 20,
         "plane/plane": 0}
DIM2_KERNELS = ("grid_pairs_2d", "manifold_2d", "contact_rows_2d", "pack_2d", "solve_2d",
                "integrate_2d", "prepare_2d", "writeback_2d", "sleep_update_2d")
# Launches of each kernel in one 2D step (F's key join, G, J's labels and
# L's slots and finish besides).
DIM2_STEP_LAUNCHES = {
    "grid_pairs_2d": lambda cfg: 1,
    "compact_pairs": lambda cfg: 2,
    "manifold_2d": lambda cfg: 1,
    "contact_rows_2d": lambda cfg: 1,
    "pack_2d": lambda cfg: 2,
    "solve_2d": lambda cfg: (3 * cfg.substeps + cfg.solver.restitution_iterations)
    * cfg.max_colors,
    "integrate_2d": lambda cfg: 2 * cfg.substeps,
    "prepare_2d": lambda cfg: 1,
    "writeback_2d": lambda cfg: 1,
    "sleep_update_2d": lambda cfg: 1 if cfg.sleeping_enabled else 0,
    "contact_rows": lambda cfg: 1,
    "color_edges": lambda cfg: 5 + 2 * kg.ASSIGN_ROUNDS + 1 + 1,
    "islands": lambda cfg: 2,
}


def pyramid2d(device, base=None):
    base = base or DIM2_BASE
    n = base * (base + 1) // 2 + 1
    return scenes2d.box_pyramid_2d(base, max_contacts=DIM2_SLOTS_PER_BOX * n, device=device)


def many_pyramids2d(device):
    n = MANY2D_GRID * MANY2D_GRID * MANY2D_BASE * (MANY2D_BASE + 1) // 2 + 1
    return scenes2d.many_pyramids_2d(MANY2D_GRID, MANY2D_BASE,
                                     max_contacts=DIM2_SLOTS_PER_BOX * n, device=device)


def dim2_stages(world, config):
    """This step's inputs of every 2D kernel: (world with AABBs, poses,
    pairs, contacts, solver bodies, Z's table, constraints)."""
    poses = bp2.collider_poses(world)
    world = bp2.update_aabbs(world, config, poses)
    bp = bp2.broad_phase(world, config)
    contacts = nc2.narrow_phase(world, bp, config, poses)
    s, table = dyn2.prepare(world.bodies, world.gravity, config.substep_dt)
    return (world, poses, bp, contacts, s, table,
            sol2.prepare_constraints(world, contacts, s, config))


def v_kinds(plane, count, ca, cb, valid):
    """The number of valid pairs of each of V's kinds among ``(ca, cb)`` (an
    empty slot pairs collider 0 with itself)."""
    ca, cb = ca[valid], cb[valid]
    pa, pb = plane[ca], plane[cb]
    circ_a, circ_b = (count[ca] == 1) & ~pa, (count[cb] == 1) & ~pb
    both = ~pa & ~pb
    kinds = {"plane/plane": pa & pb, "poly/plane": pa ^ pb,
             "circle/circle": both & circ_a & circ_b, "circle/poly": both & (circ_a ^ circ_b),
             "poly/poly": both & ~circ_a & ~circ_b}
    return {k: int(v.sum()) for k, v in kinds.items()}


def v_ops(kinds):
    return sum(V_OPS[k] * n for k, n in kinds.items())


def solve_2d_all_modes(s, con, params):
    """Kernel Y through every colour in each mode from the same state, and
    its twin on CPU copies (its overflow colour sums with ``index_add_``,
    whose float atomics on the card add in no fixed order). Returns (max abs
    difference, the kernel's impulses before and after restitution)."""
    state_k, imp_k = s.state.clone(), con.imp.clone()
    state_t, imp_t = state_k.cpu(), imp_k.cpu()
    rows_t = [x.cpu() for x in (con.data, con.bucket_a, con.bucket_b, con.bucket_valid,
                                con.relax)]
    err = 0.0
    for mode in (ky.WARM, ky.BIAS, ky.RELAX, ky.RESTITUTION):
        before = imp_k.clone()
        for c in range(con.data.shape[0]):
            ky.solve_2d(mode, c, state_k, con.data, imp_k, con.bucket_a, con.bucket_b,
                        con.bucket_valid, con.relax, con.ovf_order, con.ovf_key, params)
            ky.solve_2d_twin(mode, c, state_t, rows_t[0], imp_t, *rows_t[1:], params)
        err = max(err, float((state_k.cpu() - state_t).abs().max()),
                  float((imp_k.cpu() - imp_t).abs().max()))
    return err, before, imp_k


def kernels_uvwxyz(world, config):
    """Kernels U-Z against their twins on ``world``'s step; {name:
    measurements}, and a note."""
    out = {}
    w2, poses, bp, contacts, s, table, con = dim2_stages(world, config)
    col = w2.colliders

    # --- U: grid sweep and global test (then L's slots and finish) ----------
    args_u = bp2.grid_pair_inputs(w2, config)
    got, want = ku.grid_pairs_2d(*args_u), ku.grid_pairs_2d_twin(*args_u)
    for name, x, y in zip(want._fields, got, want):
        compare(f"grid_pairs_2d {name}", x, y)
    skey, scol, sf, si, w, colt, g_idx, g_valid = args_u[:8]
    args_c = (skey, sf, si, w, colt, g_idx, g_valid)
    counts = ku.grid_counts_2d(*args_c)
    for name, x, y in zip(("bits", "cnt", "gflag", "window_overflow"), counts,
                          ku.grid_counts_2d_twin(*args_c)):
        compare(f"grid_counts_2d {name}", x, y)
    out["grid_pairs_2d"] = measured(
        0.0, lambda: ku.grid_counts_2d(*args_c), lambda: ku.grid_counts_2d_twin(*args_c),
        nbytes(skey, sf, si, *colt, g_idx, g_valid, *counts),
        12 * sweep_tests(skey, w) + 16 * g_idx.numel() * col.capacity,
    )

    # --- V: the step's manifolds ----------------------------------------------
    args_v = (bp.collider_a.long(), bp.collider_b.long(), poses.pos, poses.cs, col.poly_verts,
              col.vert_count, col.radius, col.is_plane)
    man = kv.manifold_2d(*args_v)
    for name, x, y in zip(kv.Manifold2D._fields, man, kv.manifold_2d_twin(*args_v)):
        compare(f"manifold_2d {name}", x, y)
    kinds = v_kinds(col.is_plane, col.vert_count, *args_v[:2], bp.valid)
    out["manifold_2d"] = measured(
        0.0, lambda: kv.manifold_2d(*args_v), lambda: kv.manifold_2d_twin(*args_v),
        nbytes(*args_v[:2], *man) + args_v[0].numel() * 2 * 90, v_ops(kinds),
    )

    # --- W: contact rows ------------------------------------------------------
    old = w2.contacts
    ks, order = torch.sort(torch.cat([old.pair_key, bp.pair_key]), stable=True)
    hit, survives = kf.contact_join(ks, order, old.capacity)
    rank = torch.cumsum((bp.valid & (hit == 0)).to(torch.int32), 0, dtype=torch.int32) - 1
    args_w = (w2.bodies, poses.body_cs, col, old, bp.valid, bp.collider_a, bp.collider_b, man,
              hit, survives, rank, nc2.row_params(config))
    rows_k, rows_t = kw.contact_rows_2d(*args_w), kw.contact_rows_2d_twin(*args_w)
    for name in kw.ROW_COLUMNS:
        compare(f"contact_rows_2d {name}", rows_k[name], rows_t[name].to(rows_k[name].dtype))
    c = old.capacity
    out["contact_rows_2d"] = measured(
        0.0, lambda: kw.contact_rows_2d(*args_w), lambda: kw.contact_rows_2d_twin(*args_w),
        nbytes(*rows_k.values(), bp.valid, bp.collider_a, bp.collider_b, *man, hit, survives,
               rank) + c * (2 * 40 + 2 * 32 + 48), 150 * c,
    )

    # --- X: packed rows -------------------------------------------------------
    ba, bb = contacts.body_a.long(), contacts.body_b.long()
    dyn_a, dyn_b = s.solve_mask[ba] > 0, s.solve_mask[bb] > 0
    solve = contacts.active & contacts.touching & ~contacts.is_sensor & (dyn_a | dyn_b)
    args_x = (w2.bodies, contacts, s.state, s.inv_mass, s.inv_inertia, dyn_a, dyn_b, solve,
              con.buckets, con.bucket_valid, *sol_m.contact_softness(config))
    packed = kx.pack_2d(*args_x)
    for name, x, y in zip(kx.Packed2D._fields, packed, kx.pack_2d_twin(*args_x)):
        compare(f"pack_2d {name}", x, y)
    slots = con.buckets.numel()
    out["pack_2d"] = measured(
        0.0, lambda: kx.pack_2d(*args_x), lambda: kx.pack_2d_twin(*args_x),
        nbytes(*packed, con.buckets, con.bucket_valid) + slots * 4 * 30, 120 * slots,
    )

    # --- Z's prologue, Z and Y: one substep's integration and every solver mode
    h = config.substep_dt
    b = w2.bodies
    prep = kz.prepare_2d(b, w2.gravity, h)
    for name, x, y in zip(("state", "inv_mass", "inv_inertia", "solve_mask", "table"), prep,
                          kz.prepare_2d_twin(b, w2.gravity, h)):
        compare(f"prepare_2d {name}", x, y)
    out["prepare_2d"] = measured(
        0.0, lambda: kz.prepare_2d(b, w2.gravity, h),
        lambda: kz.prepare_2d_twin(b, w2.gravity, h),
        nbytes(b.body_type, b.locked_axes, b.active, b.sleeping, b.lin_vel, b.force,
               b.const_force, b.ang_vel, b.torque, b.const_torque, b.inv_mass, b.inv_inertia,
               b.gravity_scale, b.lin_damping, b.ang_damping, b.max_lin_speed, b.max_ang_speed,
               w2.gravity, *prep), 30 * b.capacity,
    )
    for mode in (kz.VELOCITIES, kz.POSITIONS):
        compare(f"integrate_2d mode {mode}", kz.integrate_2d(s.state, table, h, mode),
                kz.integrate_2d_twin(s.state, table, h, mode))

    def run_z(fn):
        fn(fn(s.state, table, h, kz.VELOCITIES), table, h, kz.POSITIONS)

    out["integrate_2d"] = measured(
        0.0, lambda: run_z(kz.integrate_2d), lambda: run_z(kz.integrate_2d_twin),
        2 * (2 * nbytes(s.state) + nbytes(table)), 2 * 30 * s.state.shape[0],
    )
    params = sol2.solve_params(config)
    s1 = s.replace(state=kz.integrate_2d(s.state, table, h, kz.VELOCITIES))
    err_y, _, _ = solve_2d_all_modes(s1, con, params)
    reruns = [solve_2d_all_modes(s1, con, params)[2] for _ in range(2)]
    # --- K's 2D writeback and J's 2D sleep update, on the substep's state ----
    moved = kz.integrate_2d(s1.state, table, h, kz.POSITIONS)
    wb = kk.writeback_2d(b, moved)
    err_wb = 0.0
    for name, x, y in zip(("pos", "angle", "lin_vel", "ang_vel", "force", "torque"), wb,
                          kk.writeback_2d_twin(b, moved)):
        err_wb = max(err_wb, compare(f"writeback_2d {name}", x, y, TOL_WRITEBACK))
    out["writeback_2d"] = measured(
        err_wb, lambda: kk.writeback_2d(b, moved), lambda: kk.writeback_2d_twin(b, moved),
        nbytes(moved, b.pos, b.angle, b.com, b.lin_vel, b.ang_vel, b.active, b.sleeping,
               b.body_type, *wb), 100 * b.capacity,
    )
    b_new = b.replace(pos=wb[0], angle=wb[1], lin_vel=wb[2], ang_vel=wb[3])
    island, overflow = sleep_m.compute_islands(b_new, contacts, w2.joints)
    lin_t = config.sleep_linear_threshold * config.length_unit
    sparams = kj.SleepParams(lin_t * lin_t, config.sleep_angular_threshold ** 2, config.dt,
                             config.time_to_sleep)
    s_in = (b_new, island, overflow, sparams)
    slept = kj.sleep_update_2d(*s_in)
    for name, x, y in zip(("sleeping", "sleep_timer", "lin_vel", "ang_vel"), slept,
                          kj.sleep_update_2d_twin(*s_in)):
        compare(f"sleep_update_2d {name}", x, y)
    out["sleep_update_2d"] = measured(
        0.0, lambda: kj.sleep_update_2d(*s_in), lambda: kj.sleep_update_2d_twin(*s_in),
        nbytes(island, overflow, b_new.sleeping, b_new.active, b_new.body_type,
               b_new.sleep_disabled, b_new.lin_vel, b_new.ang_vel, b_new.sleep_timer, *slept),
        12 * b.capacity,
    )
    compare("solve_2d rerun", reruns[0], reruns[1])
    if err_y > TOL_Y:
        raise AssertionError(f"solve_2d: max abs err {err_y} > {TOL_Y}")
    colors = con.data.shape[0]

    def run_y(twin):
        st, imp = (s1.state.cpu(), con.imp.cpu()) if twin else (s1.state.clone(), con.imp.clone())
        rows = [x.cpu() for x in (con.data, con.bucket_a, con.bucket_b, con.bucket_valid,
                                  con.relax)] if twin else None

        def go():
            for color in range(colors):
                if twin:
                    ky.solve_2d_twin(ky.BIAS, color, st, rows[0], imp, *rows[1:], params)
                else:
                    ky.solve_2d(ky.BIAS, color, st, con.data, imp, con.bucket_a, con.bucket_b,
                                con.bucket_valid, con.relax, con.ovf_order, con.ovf_key,
                                params)
        return go

    rows_y = int(con.bucket_valid.sum())
    out["solve_2d"] = measured(
        err_y, run_y(False), run_y(True),
        4 * rows_y * (ky.D + 2 * ky.IMP + 3 + 2 * ky.STATE + 2 * 3), 500 * rows_y,
    )
    note = (f"{int(bp.num_pairs)} pairs ({kinds}), {rows_y} rows solved, "
            f"{int(con.bucket_valid[-1].sum())} of them in the overflow colour")
    return out, note


def random_v_pairs(device):
    """V against its twin on ``DIM2_RANDOM_PAIRS`` seeded random pairs of
    each of its kinds, bitwise; returns (label, arguments, output) of each
    kind's launch."""
    rng = np.random.default_rng(7)
    timed = []
    for seed, (label, (ka_, kb_)) in enumerate(DIM2_PAIR_KINDS.items()):
        kinds = np.stack([rng.choice(ka_, DIM2_RANDOM_PAIRS), rng.choice(kb_, DIM2_RANDOM_PAIRS)],
                         -1)
        ca, cb, t = random_pairs_2d.random_pairs(DIM2_RANDOM_PAIRS, 100 + seed, kinds=kinds,
                                          device=device)
        cs = torch.stack([torch.cos(t["angle"]), torch.sin(t["angle"])], -1).contiguous()
        args = (ca, cb, t["pos"], cs, t["verts"], t["count"], t["radius"], t["plane"])
        got = kv.manifold_2d(*args)
        for name, x, y in zip(kv.Manifold2D._fields, got, kv.manifold_2d_twin(*args)):
            compare(f"manifold_2d {label} {name}", x, y)
        timed.append((label, args, got))
    return timed


def phase_dim2_kernels(device):
    """U-Z against their twins at the base-100 2D pyramid's state after
    ``DIM2_KERNEL_STEPS`` steps (and after 2, most rows in the overflow
    colour; errors only), its bouncing copy for Y's restitution, and V on
    4,096 random pairs of each kind. Returns {name: measurements}."""
    world, _ = pyramid2d(device)
    early = None
    for i in range(DIM2_KERNEL_STEPS):
        world = physics_step_2d(world, DIM2_CONFIG)
        if i == 1:
            early = world
    torch.cuda.synchronize()
    out, note = kernels_uvwxyz(world, DIM2_CONFIG)
    say("dim2 kernels", show(f"pyramid2d base {DIM2_BASE} after {DIM2_KERNEL_STEPS} steps",
                             out) + f" ({note})")
    for tag, w in (("after 2 steps", early), ("bouncing", bouncing2d(world))):
        more, note = kernels_uvwxyz(w, DIM2_CONFIG)
        for name, v in more.items():
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"], v["max_abs_err"])
        say("dim2 kernels", f"[{tag}] U-Z against their twins: " + ", ".join(
            f"{k} err {v['max_abs_err']:.3g}" for k, v in more.items()) + f" ({note})")
    parts = []
    for label, args, got in random_v_pairs(device):
        kind = {"plane/poly": "poly/plane", "poly/circle": "circle/poly"}.get(label, label)
        b_ms, b_by = bound(nbytes(*args, *got), V_OPS[kind] * DIM2_RANDOM_PAIRS)
        parts.append(f"{label} {cuda_ms(lambda: kv.manifold_2d(*args)):.4f} ms "
                     f"(twin {cuda_ms(lambda: kv.manifold_2d_twin(*args)):.4f}, bound "
                     f"{b_ms:.5f} {b_by})")
    say("dim2 kernels", f"manifold_2d on {DIM2_RANDOM_PAIRS} random pairs of each kind, "
        "bitwise equal to its twin: " + "; ".join(parts))
    return out


def bouncing2d(world):
    """The 2D world with restitution 0.7 on every collider and every dynamic
    body awake and moving down at 3 m/s, so that Y's restitution mode acts."""
    b = world.bodies
    down = torch.tensor([0.0, -3.0], device=b.lin_vel.device)
    dyn = (b.body_type == BodyType.DYNAMIC)[:, None]
    return world.replace(
        bodies=b.replace(lin_vel=b.lin_vel + down * dyn, sleeping=torch.zeros_like(b.sleeping)),
        colliders=world.colliders.replace(
            restitution=torch.full_like(world.colliders.restitution, 0.7)))


def phase_dim2_golden(device):
    golden = np.load(os.path.join(ROOT, "tests", "golden", "pyramid2d_native.npz"))
    world, _ = scenes2d.box_pyramid_2d(6, device=device)
    pos, angle = [], []
    for i in range(GOLDEN_STEPS):
        world = physics_step_2d(world, GOLDEN_CONFIG)
        if (i + 1) % GOLDEN_STRIDE == 0:
            pos.append(world.bodies.pos.cpu().numpy())
            angle.append(world.bodies.angle.cpu().numpy())
    drift = float(np.abs(np.stack(pos) - golden["pos"]).max())
    adrift = float(np.abs(np.stack(angle) - golden["angle"]).max())
    say("dim2 golden", f"pyramid2d_native {GOLDEN_STEPS} steps at 1/64 s: max drift {drift:.3g} "
        f"m, angle {adrift:.3g} rad (limit {GOLDEN_TOL})")
    if not (drift < GOLDEN_TOL and adrift < GOLDEN_TOL):
        raise AssertionError(f"pyramid2d_native: drift {drift}, {adrift} >= {GOLDEN_TOL}")


def drive2d(what, world, ids, config, steps, smi, each_step=None, expect=None, vary=(),
            lowest_band=(DIM2_REST_Y - DIM2_REST_TOL, DIM2_REST_Y + DIM2_REST_TOL)):
    """``steps`` 2D steps with diagnostics. Fails on a dropped pair or an
    overflow drop (running maxima), a non-finite state, the lowest body
    outside ``lowest_band`` at the end, or launch counts other than the
    steps imply (``expect``, per-step counts, by default
    ``DIM2_STEP_LAUNCHES``; each kernel of ``vary`` at least once). Returns
    the world, the launches and the mean ms a step."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    idx = torch.tensor(ids, device=world.bodies.pos.device)
    max_dropped = max_overflow = max_rows = 0
    times = []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        world, diag = physics_step_2d(world, config, return_diagnostics=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        max_dropped = max(max_dropped, int(diag["dropped_pairs"]))
        max_overflow = max(max_overflow, int(diag["overflow_dropped"]))
        max_rows = max(max_rows, int(diag["num_overflow"]))
        if each_step is not None:
            each_step(i, world, idx)
    got = kernels.launches()
    peak = torch.cuda.max_memory_allocated()
    b = world.bodies
    for name in ("pos", "angle", "lin_vel", "ang_vel"):
        if not bool(torch.isfinite(getattr(b, name)).all()):
            raise AssertionError(f"{what}: non-finite {name}")
    if bool(world.diverged) or max_dropped or max_overflow:
        raise AssertionError(f"{what}: diverged {bool(world.diverged)}, dropped pairs "
                             f"{max_dropped}, overflow drops {max_overflow}")
    expect = {name: steps * n(config) for name, n in (expect or DIM2_STEP_LAUNCHES).items()}
    if ({k: got[k] for k in expect} != expect
            or any(v for k, v in got.items() if k not in expect and k not in vary)
            or not all(got[k] for k in vary)):
        raise AssertionError(f"{what}: launches {got} != expected {expect} (and {vary} > 0)")
    lowest = float(b.pos[idx, 1].min())
    if not lowest_band[0] <= lowest <= lowest_band[1]:
        raise AssertionError(f"{what}: lowest body at {lowest} m, outside {lowest_band}")
    ms = 1e3 * sum(times) / len(times)
    say(what, f"{len(ids)} bodies, {world.contacts.capacity} contact slots, {steps} steps at "
        f"{ms:.2f} ms/step (median {1e3 * sorted(times)[len(times) // 2]:.2f}, last "
        f"{1e3 * times[-1]:.2f}), {1e3 * len(ids) / ms:.0f} body-steps/s; peak "
        f"{peak / 2**20:.0f} MiB; dropped 0, overflow drops 0, most rows in the overflow "
        f"colour {max_rows}; lowest body {lowest:.4f} m; end: {int(diag['num_sleeping'])} "
        f"asleep; launches {got} [{smi}]")
    return world, got, ms


def phase_pyramid2d(device, smi):
    """The 2D pyramid path: the base-100 pyramid at 24 contact slots a box for
    ``DIM2_STEPS`` steps, its apex and lowest box held to the reference's
    curve over the curve's steps, then ``many_pyramids_2d(10, 10)``. Returns
    the first's launch counts."""
    curve = np.load(DIM2_CURVE)
    world, ids = pyramid2d(device)
    apex_id = int(curve["apex_id"])
    track = []

    def each_step(i, w, idx):
        if i < curve["apex"].shape[0]:
            track.append((float(w.bodies.pos[apex_id, 1]), float(w.bodies.pos[idx, 1].min())))

    world, got, _ = drive2d("pyramid2d", world, ids, DIM2_CONFIG, DIM2_STEPS, smi, each_step)
    track = np.asarray(track)
    apex_gap = np.abs(track[:, 0] - curve["apex"])
    low_gap = np.abs(track[:, 1] - curve["lowest"])
    early = apex_gap[:DIM2_APEX_BAND_STEPS].max(initial=0.0)
    late = apex_gap[DIM2_APEX_BAND_STEPS:].max(initial=0.0)
    say("pyramid2d", f"against the reference's curve over {track.shape[0]} steps: apex within "
        f"{early:.4f} m in steps 1-{DIM2_APEX_BAND_STEPS} (band {DIM2_APEX_BAND}) and "
        f"{late:.4f} m after (band {DIM2_APEX_BAND_LATE}), lowest box within "
        f"{low_gap.max():.4f} m (band {DIM2_LOWEST_BAND}); step: apex port, reference (m): "
        + "; ".join(f"{i + 1}: {track[i, 0]:.4f}, {curve['apex'][i]:.4f}"
                    for i in range(4, track.shape[0], 5)))
    if not (early <= DIM2_APEX_BAND and late <= DIM2_APEX_BAND_LATE
            and low_gap.max() <= DIM2_LOWEST_BAND):
        raise AssertionError(f"pyramid2d: off the reference's curve: apex {early}, {late}, "
                             f"lowest {low_gap.max()}")
    world, ids = many_pyramids2d(device)
    drive2d("many_pyramids2d", world, ids, DIM2_CONFIG, MANY2D_STEPS, smi)
    return got


@contextlib.contextmanager
def plain_versions_2d():
    """Within the block every wrapper of the 2D step is its plain PyTorch
    version (F's join, G and J included); no kernel is launched."""
    def solve_2d_plain(mode, color, state, data, imp, bucket_a, bucket_b, bucket_valid, relax,
                       ovf_order, ovf_key, params):
        return ky.solve_2d_twin(mode, color, state, data, imp, bucket_a, bucket_b,
                                bucket_valid, relax, params)

    def joint_color_2d_plain(color, last, state, data, lam, jtype, body_a, body_b, jcolor, mask,
                             ovf_order, ovf_key, hh):
        return kaa.joint_color_2d_twin(color, state, data, lam, jtype, body_a, body_b, jcolor,
                                       mask, hh)

    def joint_velocities_2d_plain(state, pre, data, body_a, body_b, mask, damp_order, damp_key,
                                  h):
        return kaa.joint_velocities_2d_twin(state, pre, data, body_a, body_b, mask, h)

    def swept_toi_2d_plain(swept, tab, n_bodies, rounds=None):
        return kab.swept_toi_2d_twin(swept, tab, n_bodies)

    swaps = [
        (ku, "grid_pairs_2d", ku.grid_pairs_2d_twin), (kv, "manifold_2d", kv.manifold_2d_twin),
        (kw, "contact_rows_2d", kw.contact_rows_2d_twin), (kx, "pack_2d", kx.pack_2d_twin),
        (ky, "solve_2d", solve_2d_plain), (kz, "integrate_2d", kz.integrate_2d_twin),
        (kz, "prepare_2d", kz.prepare_2d_twin), (kk, "writeback_2d", kk.writeback_2d_twin),
        (kj, "sleep_update_2d", kj.sleep_update_2d_twin),
        (kaa, "joint_rows_2d", kaa.joint_rows_2d_twin),
        (kaa, "joint_color_2d", joint_color_2d_plain),
        (kaa, "joint_velocities_2d", joint_velocities_2d_plain),
        (kab, "swept_toi_2d", swept_toi_2d_plain),
        (kf, "contact_join", kf.contact_join_twin),
        (kg, "color_edges", kg.color_edges_twin), (kg, "bucket_edges", kg.bucket_edges_twin),
        (sleep_m, "run_rank", kr.run_rank_twin),
        (kj, "island_table", kj.island_table_twin), (kj, "island_labels", kj.island_labels_twin),
    ]
    kept = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, plain in swaps:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for mod, name, fn in kept:
            setattr(mod, name, fn)


def trajectory2d(world, config, steps, idx):
    frames, overflow = [], []
    for _ in range(steps):
        world, diag = physics_step_2d(world, config, return_diagnostics=True)
        frames.append(world.bodies.pos[idx].clone())
        overflow.append(int(diag["num_overflow"]))
    return torch.stack(frames), overflow


def phase_dim2_plain_path(device):
    """The base-100 2D pyramid from its start for ``DIM2_PLAIN_STEPS`` steps
    on the kernels, then on their plain versions alone (on the card, no
    kernel launched): the rows in the overflow colour agree for
    ``DIM2_PLAIN_EXACT_STEPS`` steps, every box within ``DIM2_PLAIN_TOL`` for
    ``DIM2_PLAIN_TIGHT_STEPS``, the apexes within ``DIM2_PLAIN_APEX_TOL``
    throughout."""
    world, ids = pyramid2d(device)
    idx = torch.tensor(ids, device=device)
    apex = int(torch.argmax(world.bodies.pos[idx, 1]))
    on_k, ovf_k = trajectory2d(world, DIM2_CONFIG, DIM2_PLAIN_STEPS, idx)
    kernels.reset_launches()
    t0 = time.perf_counter()
    with plain_versions_2d():
        on_p, ovf_p = trajectory2d(world, DIM2_CONFIG, DIM2_PLAIN_STEPS, idx)
    seconds = time.perf_counter() - t0
    if any(kernels.launches().values()):
        raise AssertionError(f"dim2 plain path: kernels were launched: {kernels.launches()}")
    diff = (on_k - on_p).abs().amax(dim=(1, 2))
    apart = (on_k[:, apex, 1] - on_p[:, apex, 1]).abs()
    tight = float(diff[:DIM2_PLAIN_TIGHT_STEPS].max())
    say("dim2 plain path", f"pyramid2d base {DIM2_BASE}, {DIM2_PLAIN_STEPS} steps on the kernels "
        f"and on their plain versions ({seconds:.1f} s): largest difference of any box in the "
        f"first {DIM2_PLAIN_TIGHT_STEPS} steps {tight:.3g} m (limit {DIM2_PLAIN_TOL}), of the "
        f"apexes in all {float(apart.max()):.3g} m (limit {DIM2_PLAIN_APEX_TOL}); step: apex y "
        f"on kernels, on plain versions, largest difference, overflow rows on kernels, on "
        f"plain: " + "; ".join(
            f"{i + 1}: {float(on_k[i, apex, 1]):.4f}, {float(on_p[i, apex, 1]):.4f}, "
            f"{float(diff[i]):.2g}, {ovf_k[i]}, {ovf_p[i]}"
            for i in range(4, DIM2_PLAIN_STEPS, 5)))
    if ovf_k[:DIM2_PLAIN_EXACT_STEPS] != ovf_p[:DIM2_PLAIN_EXACT_STEPS]:
        raise AssertionError(f"dim2 plain path: overflow rows differ: {ovf_k} against {ovf_p}")
    if not (tight <= DIM2_PLAIN_TOL and float(apart.max()) <= DIM2_PLAIN_APEX_TOL):
        raise AssertionError(f"dim2 plain path: boxes {tight} m, apexes {float(apart.max())} m "
                             "apart")


def twice_equal_2d(what, make, config, steps):
    """Run ``make()`` for ``steps`` 2D steps twice; fail unless the final
    poses and velocities are bitwise equal."""
    finals = []
    for _ in range(2):
        world = make()
        for _ in range(steps):
            world = physics_step_2d(world, config)
        finals.append([getattr(world.bodies, k).cpu() for k in ("pos", "angle", "lin_vel",
                                                                 "ang_vel")])
    for x, y in zip(*finals):
        if not torch.equal(x, y):
            raise AssertionError(f"determinism: two runs of {what} differ")
    say("determinism", f"{what} x {steps} steps twice: pos, angle, lin_vel, ang_vel bitwise "
        "equal")


def phase_dim2_determinism(device):
    twice_equal_2d(f"pyramid2d base {DIM2_BASE}", lambda: pyramid2d(device)[0], DIM2_CONFIG,
                   DIM2_DETERMINISM_STEPS)
    twice_equal_2d(f"hinge_blocks_2d({HINGES2D_DETERMINISM_BLOCKS})",
                   lambda: hinges2d(device, HINGES2D_DETERMINISM_BLOCKS)[0], HINGES2D_CONFIG,
                   DIM2_DETERMINISM_STEPS)
    twice_equal_2d(f"pyramid_ccd_2d({CCD2D_BASE}, {CCD2D_BULLETS})",
                   lambda: ccd2d_world(device)[0], CCD2D_CONFIG, DIM2_DETERMINISM_STEPS)


# ---- the rest of the 2D step: Kernels AA (joints) and AB (swept CCD) -------

# The 2D hinged boxes: hinge_blocks_2d(84), 84 copies of FallingHinges (30
# rows of 4 boxes) on the 2D engine, 10,080 boxes and 7,560 revolute joints,
# 16 contact slots a box (the 3D hinges' path), the 2D pyramid's config.
HINGES2D_BLOCKS, HINGES2D_SLOTS_PER_BOX, HINGES2D_STEPS = 84, 16, 120
HINGES2D_CONFIG = DIM2_CONFIG
HINGES2D_KERNEL_STEPS, HINGES2D_OVERFLOW_STEPS = 30, 2
HINGES2D_PLAIN_BLOCKS, HINGES2D_DETERMINISM_BLOCKS = 8, 8
HALF2D = 0.25  # the hinged boxes' half extent
# Kernel AA against its twins: the kernel's cosf/sinf/atan2f against
# PyTorch's; the twins' shared-body sums are in the kernel's order.
TOL_AA = 1e-5
# Operations of one solved joint in a colour (two angle corrections, the
# positional correction, four cos/sin), of its damping, and of one body's
# projection.
AA_JOINT_OPS, AA_DAMP_OPS, AA_BODY_OPS = 150, 20, 10
# The 2D swept bullets: pyramid_ccd_2d(100, 32), the base-100 2D pyramid and
# 32 bullets (16 linear circles, 16 nonlinear spinning capsules) fired down
# at 300 m/s, 24 contact slots a body, the 2D pyramid's config with swept
# CCD: K = 32 against 5,083 colliders. AB against its twin on the whole grid
# of step 2; the pairs where neither collider turns along its sweep bit for
# bit, the rest within TOL_AB (cosf/sinf).
CCD2D_BASE, CCD2D_BULLETS, CCD2D_STEPS = 100, 32, 60
CCD2D_CONFIG = DIM2_CONFIG.replace(swept_ccd=True)
TOL_AB = 1e-5
# Operations of one round of AB besides its manifold (two poses at t, four
# cos/sin where a collider turns, the advancement).
AB_ROUND_OPS = 60
DIM2_JOINT_LAUNCHES = dict(
    DIM2_STEP_LAUNCHES,
    color_edges=lambda cfg: 2 * (5 + 2 * kg.ASSIGN_ROUNDS) + 1 + 1,
    solve_joints_2d=lambda cfg: 1 + cfg.substeps * (cfg.max_colors + 1),
)


def hinges2d(device, blocks=HINGES2D_BLOCKS):
    n = blocks * 30 * 4 + 1
    return scenes2d.hinge_blocks_2d(blocks, max_contacts=HINGES2D_SLOTS_PER_BOX * n,
                                    device=device)


def ccd2d_world(device, base=CCD2D_BASE, bullets=CCD2D_BULLETS):
    n = base * (base + 1) // 2 + 1 + bullets
    return scenes2d.pyramid_ccd_2d(base, bullets, max_contacts=DIM2_SLOTS_PER_BOX * n,
                                   device=device)


def anchor_gap_2d(world):
    """The largest distance between the two world anchors of an active 2D
    joint, in metres."""
    b, j = world.bodies, world.joints
    a, c = j.body_a.long(), j.body_b.long()

    def anchor(body, local):
        ang = b.angle[body]
        cs, sn = torch.cos(ang), torch.sin(ang)
        return b.pos[body] + torch.stack([cs * local[:, 0] - sn * local[:, 1],
                                          sn * local[:, 0] + cs * local[:, 1]], -1)

    gap = torch.where(j.active, (anchor(a, j.anchor_a) - anchor(c, j.anchor_b)).norm(dim=-1),
                      0.0)
    return float(gap.max())


def kernel_aa_against_twins(world, config, colors, overflow=False):
    """Kernel AA against its twins on ``world``'s next step: the rows
    bitwise; one substep (every colour at ``colors`` colours, the projection,
    the damping; with ``overflow`` every joint in the last colour) from the
    step's state after its substeps within ``TOL_AA``; two runs bitwise.
    Returns (max abs error, the substep's inputs, the joints in the overflow
    colour)."""
    p = step2.substepped(world, config)
    j, s = p.world.joints, p.s
    axis_cs = torch.stack([torch.cos(j.axis_angle), torch.sin(j.axis_angle)], -1).contiguous()
    args = (j, p.world.bodies, p.poses.body_cs.contiguous(), axis_cs, s.inv_mass, s.inv_inertia,
            s.solve_mask)
    for name, x, y in zip(("data", "mask", "dyn_a", "dyn_b"), kaa.joint_rows_2d(*args),
                          kaa.joint_rows_2d_twin(*args)):
        compare(f"joint_rows_2d {name}", x, y)
    jc = xpbd2.prepare_joints(p.world, s, p.poses, config.replace(max_colors=colors))
    if overflow:
        jc = shared_2d.all_in_overflow(jc, colors, s.state.shape[0])
    h = config.substep_dt
    runs = [shared_2d.joint_substep(jc, colors, h, False, s.state.clone(), jc.lam.clone())
            for _ in range(2)]
    if not (torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])):
        raise AssertionError("solve_joints_2d: two runs of a substep differ")
    want = shared_2d.joint_substep(jc, colors, h, True, s.state.clone(), jc.lam.clone())
    err = max(compare(f"solve_joints_2d state ({colors} colours)", runs[0][0], want[0], TOL_AA),
              compare(f"solve_joints_2d lam ({colors} colours)", runs[0][1], want[1],
                      TOL_AA * max(1.0, float(want[1].abs().max()))))
    return err, (jc, s, h, args), int((jc.color_j == colors - 1).sum())


def phase_dim2_joints_kernels(device):
    """Kernel AA against its twins on ``hinge_blocks_2d(84)`` after
    ``HINGES2D_KERNEL_STEPS`` steps, and after 2 with every joint in the
    overflow colour of 2 (a row's joints share its boxes there: the rows of
    4 are paths, which 2 colours colour properly); its times at the first.
    Returns {"solve_joints_2d": measurements}."""
    world, _ = hinges2d(device)
    early = None
    for i in range(HINGES2D_KERNEL_STEPS):
        world = physics_step_2d(world, HINGES2D_CONFIG)
        if i + 1 == HINGES2D_OVERFLOW_STEPS:
            early = world
    torch.cuda.synchronize()
    colors = HINGES2D_CONFIG.max_colors
    err, (jc, s, h, rows_args), _ = kernel_aa_against_twins(world, HINGES2D_CONFIG, colors)
    err2, _, in_overflow = kernel_aa_against_twins(early, HINGES2D_CONFIG, 2, overflow=True)
    n, active = s.state.shape[0], int((jc.mask > 0).sum())
    state_k, lam_k = s.state.clone(), jc.lam.clone()
    state_t, lam_t = s.state.clone(), jc.lam.clone()
    b_ms, b_by = bound(
        2 * nbytes(s.state, jc.lam) + nbytes(jc.data, jc.jtype, jc.body_a, jc.body_b, jc.color,
                                             jc.mask, jc.ovf_order, jc.ovf_key, jc.damp_order,
                                             jc.damp_key) + 4 * 3 * n,
        (AA_JOINT_OPS + AA_DAMP_OPS) * active + AA_BODY_OPS * n)
    r = dict(max_abs_err=max(err, err2),
             ms=cuda_ms(lambda: shared_2d.joint_substep(jc, colors, h, False, state_k, lam_k)),
             plain_ms=cuda_ms(lambda: shared_2d.joint_substep(jc, colors, h, True, state_t, lam_t)),
             bound_ms=b_ms, bound_by=b_by, library_ms=None,
             rows_ms=cuda_ms(lambda: kaa.joint_rows_2d(*rows_args)))
    say("dim2 joints kernels", f"hinge_blocks_2d({HINGES2D_BLOCKS}) after "
        f"{HINGES2D_KERNEL_STEPS} steps: {active} joints solved; rows bitwise; one substep "
        f"({colors} colours, projection, damping) max abs err {err:.3g}; after "
        f"{HINGES2D_OVERFLOW_STEPS} steps at 2 colours ({in_overflow} joints in the overflow "
        f"colour) {err2:.3g} (limit {TOL_AA}); reruns bitwise; substep {r['ms']:.4f} ms, twins "
        f"{r['plain_ms']:.4f} ms, rows {r['rows_ms']:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
    return {"solve_joints_2d": r}


def phase_hinges2d(device, smi):
    """The 2D hinged boxes at full width through ``physics_step_2d`` for
    ``HINGES2D_STEPS`` steps: every joint's anchors within
    ``HINGE_ANCHOR_TOL`` and no box more than 5 cm into the ground (every 10
    steps), 0 drops, Kernel AA launched ``1 + substeps * (colours + 1)``
    times a step. Returns the launch counts."""
    world, ids = hinges2d(device)
    gaps, lows = [], []

    def each_step(i, w, idx):
        if (i + 1) % 10:
            return
        gaps.append(anchor_gap_2d(w))
        lows.append(float(w.bodies.pos[idx, 1].min()))
        if not (gaps[-1] <= HINGE_ANCHOR_TOL and lows[-1] >= HALF2D - 0.05):
            raise AssertionError(f"hinges2d: step {i + 1}: anchors {gaps[-1]} m apart (limit "
                                 f"{HINGE_ANCHOR_TOL}), lowest box at {lows[-1]} m")

    world, got, _ = drive2d("hinges2d", world, ids, HINGES2D_CONFIG, HINGES2D_STEPS, smi,
                            each_step, expect=DIM2_JOINT_LAUNCHES,
                            lowest_band=(HALF2D - 0.05, 2.0))
    say("hinges2d", f"{int(world.joints.active.sum())} revolute joints; largest anchor "
        f"separation {max(gaps):.3g} m (limit {HINGE_ANCHOR_TOL}); every 10 steps: "
        + ", ".join(f"{g:.2g}" for g in gaps) + "; lowest box every 10 steps: "
        + ", ".join(f"{y:.3f}" for y in lows))
    return got


def phase_hinges2d_plain_path(device):
    """``hinge_blocks_2d(8)`` from its start for ``DIM2_PLAIN_STEPS`` steps on
    the kernels, then on their plain versions alone (no kernel launched):
    the overflow rows equal for ``DIM2_PLAIN_EXACT_STEPS`` steps, every box
    within ``DIM2_PLAIN_TOL`` for ``DIM2_PLAIN_TIGHT_STEPS``, the anchors
    within ``HINGE_ANCHOR_TOL`` on both."""
    world, ids = hinges2d(device, HINGES2D_PLAIN_BLOCKS)
    idx = torch.tensor(ids, device=device)
    on_k, ovf_k = trajectory2d(world, HINGES2D_CONFIG, DIM2_PLAIN_STEPS, idx)
    kernels.reset_launches()
    t0 = time.perf_counter()
    with plain_versions_2d():
        on_p, ovf_p = trajectory2d(world, HINGES2D_CONFIG, DIM2_PLAIN_STEPS, idx)
    seconds = time.perf_counter() - t0
    if any(kernels.launches().values()):
        raise AssertionError(f"hinges2d plain path: kernels were launched: {kernels.launches()}")
    diff = (on_k - on_p).abs().amax(dim=(1, 2))
    tight = float(diff[:DIM2_PLAIN_TIGHT_STEPS].max())
    say("hinges2d plain path", f"hinge_blocks_2d({HINGES2D_PLAIN_BLOCKS}), {DIM2_PLAIN_STEPS} "
        f"steps on the kernels and on their plain versions ({seconds:.1f} s): largest "
        f"difference of any box in the first {DIM2_PLAIN_TIGHT_STEPS} steps {tight:.3g} m "
        f"(limit {DIM2_PLAIN_TOL}), in all {float(diff.max()):.3g} m; step: largest difference, "
        "overflow rows on kernels, on plain: " + "; ".join(
            f"{i + 1}: {float(diff[i]):.2g}, {ovf_k[i]}, {ovf_p[i]}"
            for i in range(4, DIM2_PLAIN_STEPS, 5)))
    if ovf_k[:DIM2_PLAIN_EXACT_STEPS] != ovf_p[:DIM2_PLAIN_EXACT_STEPS]:
        raise AssertionError(f"hinges2d plain path: overflow rows differ: {ovf_k} against "
                             f"{ovf_p}")
    if not tight <= DIM2_PLAIN_TOL:
        raise AssertionError(f"hinges2d plain path: boxes {tight} m apart")


def ab_grid(world, config):
    """(tables, swept colliders, toi, body TOIs, rounds) of Kernel AB on
    ``world``'s next step's grid."""
    p = step2.substepped(world, config)
    tab, swept = ccd2.swept_tables(p.world, p.s, p.poses, config)
    rounds = torch.zeros((swept.numel() * tab.pos0.shape[0],), dtype=torch.int32,
                         device=swept.device)
    toi, body_toi = kab.swept_toi_2d(swept, tab, world.bodies.capacity, rounds)
    return p, tab, swept, toi, body_toi, rounds


def ab_work(tab, swept, rounds, n_bodies):
    """(bytes, operations) of Kernel AB on a grid: the tables and the swept
    list read once, the TOIs and body minima written once; each pair's
    rounds at V's operations for its kind plus ``AB_ROUND_OPS``."""
    m = tab.pos0.shape[0]
    ca = swept.long()[:, None].expand(-1, m).reshape(-1)
    cb = torch.arange(m, device=swept.device)[None, :].expand(swept.numel(), -1).reshape(-1)
    plane, count = tab.plane, tab.count
    pa, pb = plane[ca], plane[cb]
    circ_a, circ_b = (count[ca] == 1) & ~pa, (count[cb] == 1) & ~pb
    both = ~pa & ~pb
    kinds = {"plane/plane": pa & pb, "poly/plane": pa ^ pb,
             "circle/circle": both & circ_a & circ_b, "circle/poly": both & (circ_a ^ circ_b),
             "poly/poly": both & ~circ_a & ~circ_b}
    ran = rounds.abs().double()
    ops = sum(float(ran[mask].sum()) * (V_OPS[k] + AB_ROUND_OPS) for k, mask in kinds.items())
    return nbytes(swept, *tab) + 4 * rounds.numel() + 4 * n_bodies, ops


def phase_ccd2d(device, smi):
    """The 2D swept bullets at full width: Kernel AB against its twin on the
    whole grid of step 2, then ``CCD2D_STEPS`` steps through
    ``physics_step_2d`` with every step gated: no bullet's centre below the
    ground or inside a box; the ``ccd`` stage timed apart; then what the
    sweep's repairs did over those steps. Returns ({"swept_toi_2d":
    measurements}, launch counts)."""
    world, ids, shots = ccd2d_world(device)
    start = world
    world = physics_step_2d(world, CCD2D_CONFIG)
    p, tab, swept, toi, body_toi, rounds = ab_grid(world, CCD2D_CONFIG)
    n, m, k_n = world.bodies.capacity, tab.pos0.shape[0], swept.numel()
    if k_n != CCD2D_BULLETS:
        raise AssertionError(f"ccd2d: {k_n} swept colliders, not {CCD2D_BULLETS}")
    again = kab.swept_toi_2d(swept, tab, n)
    if not (torch.equal(toi, again[0]) and torch.equal(body_toi, again[1])):
        raise AssertionError("swept_toi_2d: two runs differ")
    if bool(((rounds < 0) & ~(toi < 1.0)).any()):
        raise AssertionError("swept_toi_2d: a pair whose rounds ran out returned t >= 1")
    (want, want_body), twin_ms = once_ms(lambda: kab.swept_toi_2d_twin(swept, tab, n))
    still = ((tab.dang[swept.long()][:, None] == 0) & (tab.dang[None, :] == 0)).reshape(-1)
    err = max(compare("swept_toi_2d still pairs", toi[still], want[still]),
              compare("swept_toi_2d turning pairs", toi[~still], want[~still], TOL_AB),
              compare("swept_toi_2d body minima", body_toi, want_body, TOL_AB))
    io, ops = ab_work(tab, swept, rounds, n)
    b_ms, b_by = bound(io, ops)
    r = dict(max_abs_err=err, ms=cuda_ms(lambda: kab.swept_toi_2d(swept, tab, n)),
             plain_ms=twin_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None, pairs=k_n * m,
             mean_rounds=float(rounds.abs().double().mean()))
    say("ccd2d", f"Kernel AB on the grid of step 2: {k_n} x {m} pairs ({int(still.sum())} with "
        f"no turning collider), {r['mean_rounds']:.3f} rounds a pair, {int((rounds < 0).sum())} "
        f"ran out, {int((toi < 1.0).sum())} pairs below 1; against the twin on the whole grid: "
        f"max abs err {err:.3g} (still pairs bitwise); kernel {r['ms']:.4f} ms, twin "
        f"{twin_ms:.3f} ms (one run), bound {b_ms:.5f} ms ({b_by}) [{smi}]")

    ccd_times = []
    sweep = ccd2.solve_swept_ccd_2d

    def timed_sweep(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sweep(*args)
        torch.cuda.synchronize()
        ccd_times.append(time.perf_counter() - t0)
        return out

    worst = [0, 0]

    def each_step(i, w, idx):
        pos = w.bodies.pos[shots]
        worst[0] += int((pos[:, 1] < 0.0).sum())
        worst[1] += int(shared_2d.inside_polygons(pos, w).sum())
        if worst[0] or worst[1]:
            raise AssertionError(f"ccd2d: step {i + 1}: {worst[0]} bullet centres below the "
                                 f"ground, {worst[1]} inside a box")

    step2.ccd_m.solve_swept_ccd_2d = timed_sweep
    try:
        world, got, ms = drive2d("ccd2d", start, ids, CCD2D_CONFIG, CCD2D_STEPS, smi,
                                 each_step, vary=("swept_toi_2d",),
                                 lowest_band=(DIM2_REST_Y - DIM2_REST_TOL, 1e9))
    finally:
        step2.ccd_m.solve_swept_ccd_2d = sweep
    ran_out, cut, alone = ccd2d_side_effects(start, shots)
    say("ccd2d", f"{len(shots)} bullets ({CCD2D_BULLETS // 2} linear circles, "
        f"{CCD2D_BULLETS // 2} nonlinear spinning capsules), {CCD2D_STEPS} steps: AB launched "
        f"{got['swept_toi_2d']} times; the ccd stage {1e3 * sum(ccd_times) / len(ccd_times):.3f} "
        f"ms a step (of {ms:.2f}); no bullet centre below the ground or inside a box in any "
        f"step; the sweep's repairs (ROADMAP 3b): pairs returning t < 1 without a hit "
        f"{sum(ran_out)} (most in a step {max(ran_out)}), bullets cut {sum(cut)}, of which with "
        f"no contact point in the next step {sum(alone)}; a step each: ran out {ran_out}, cut "
        f"{cut}, cut and no contact after {alone}")
    return {"swept_toi_2d": r}, got


def ccd2d_side_effects(world, shots):
    """The ``ccd2d`` run's steps again, counting per step the grid's pairs
    that return t < 1 without a hit (the second repair), the bullets whose
    delta position AB cut, and of those the ones with no contact point in
    the next step's narrowphase (stopped short of anything)."""
    n = world.bodies.capacity
    ran_out, cut, alone = [], [], []
    pending = torch.zeros(n, dtype=torch.bool, device=world.device)
    for step in range(CCD2D_STEPS + 1):
        p, tab, swept, toi, body_toi, rounds = ab_grid(world, CCD2D_CONFIG)
        if step:
            c = p.contacts
            live = c.active & (c.num_points > 0)
            touched = torch.zeros(n, dtype=torch.bool, device=world.device)
            touched[c.body_a[live].long()] = True
            touched[c.body_b[live].long()] = True
            alone.append(int((pending & ~touched).sum()))
        if step == CCD2D_STEPS:
            break
        ran_out.append(int((rounds < 0).sum()))
        pending = body_toi * ccd2.TOI_EPS < 1.0
        cut.append(int(pending.sum()))
        world = physics_step_2d(world, CCD2D_CONFIG)
    return ran_out, cut, alone


def phase_dim2_examples(device):
    """The five 2D joint examples' worlds with their own configs, step counts
    and checks (``tests/torch_cases/shared_2d.py`` holds them as
    ``examples/*_2d.py`` have them): the chain alone, and the four that share
    a config side by side in one world, 20 m apart, each checked at its own
    step count."""
    examples = shared_2d.EXAMPLES
    done = []
    for config, names in itertools.groupby(sorted(examples, key=lambda n: str(examples[n][1])),
                                           key=lambda n: str(examples[n][1])):
        names = list(names)
        b = SceneBuilder2D()
        ids = {name: shared_2d.add(name, b, 20.0 * k, 0.0)
               for k, name in enumerate(names)}
        n = sum(len(v) for v in ids.values())
        world = b.finalize(max_bodies=n, max_colliders=n, max_contacts=8 * n,
                           max_joints=n, device=device)
        config = PhysicsConfig(**examples[names[0]][1])
        kernels.reset_launches()
        for i in range(max(examples[name][2] for name in names)):
            world = physics_step_2d(world, config)
            for k, name in enumerate(names):
                if i + 1 == examples[name][2]:
                    pos = world.bodies.pos.cpu() - torch.tensor([20.0 * k, 0.0])
                    shared_2d.check(name, pos, world.bodies.angle.cpu(), ids[name])
                    done.append(f"{name} {i + 1} steps")
        if not kernels.launches()["solve_joints_2d"]:
            raise AssertionError(f"{names}: Kernel AA was not launched")
    say("dim2 examples", "own checks pass: " + ", ".join(done))


# ---- the 2D queries and the character: Kernels AC, AD and AE ---------------

# The query path at full width: box_pyramid_2d(100) (5,051 colliders) at 24
# contact slots a box after DIM2_KERNEL_STEPS steps. QUERY2D_RAYS seeded rays
# (half down onto the pyramid, a quarter level through it and a quarter from
# inside seeded boxes, in seeded directions) solid and hollow, as many points
# over it, and the five query shapes cast down onto it and intersected with
# it, and placed over box 1. Each kernel against its twin on the same inputs
# within TOL_Q2D; the twins follow the kernels' operations, so the errors
# are expected to be 0.
QUERY2D_RAYS, QUERY2D_MAX_DISTANCE, TOL_Q2D = 1024, 150.0, 1e-5
QUERY2D_SHAPES = (
    ("circle", lambda dev: q2d.shape_circle(0.4, device=dev)),
    ("capsule", lambda dev: q2d.shape_capsule(0.3, 1.0, device=dev)),
    ("rectangle", lambda dev: q2d.shape_rect(0.6, 0.3, device=dev)),
    ("rounded rectangle", lambda dev: q2d.shape_rect(0.5, 0.3, 0.1, device=dev)),
    ("6-gon", lambda dev: q2d.shape_polygon(
        [(0.5 * math.cos(a * math.pi / 3), 0.5 * math.sin(a * math.pi / 3)) for a in range(6)],
        device=dev)),
)
# The arithmetic operations (adds, multiplies, divides, square roots, mins
# and maxes; comparisons and selects not counted) that one ray needs on one
# collider in AC, by the collider's own vertex count n and radius r:
# AC_VERTEX_OPS per vertex (its world position), AC_EDGE_OPS per edge where
# n >= 2 (its length and normal, its rectangle's four faces, the exit face),
# AC_CORE_OPS per edge where n >= 3 (the core's face), AC_DISK_OPS per vertex
# where r > 0 (its disk), AC_PAIR_OPS once (the exit point and normal), and
# AC_PLANE_OPS on a half-space. Of one point on one collider in AD:
# AD_VERTEX_OPS per vertex (its world position and its edge's projection),
# AD_PAIR_OPS once (distance and surface point), AD_PLANE_OPS on a
# half-space. Of one round of AE besides V's manifold: AE_ROUND_OPS.
AC_VERTEX_OPS, AC_EDGE_OPS, AC_CORE_OPS, AC_DISK_OPS, AC_PAIR_OPS, AC_PLANE_OPS = (
    8, 67, 10, 29, 15, 16)
AD_VERTEX_OPS, AD_PAIR_OPS, AD_PLANE_OPS, AE_ROUND_OPS = 41, 24, 15, 20
QUERY2D_INSIDE_JITTER = 0.3  # how far an inside ray's origin is from its box's centre
COLLIDER_ROW_BYTES = 89  # position, cosine and sine, 8 vertices, count, radius, flag
# The controller: a capsule (r 0.4, segment 1 m, upright) moved by
# move_and_slide at 60 Hz for 120 frames across many_pyramids_2d(10, 10)'s
# floor from between two pyramids into the next, at 3 m/s and 1 m/s down
# into the floor; every frame's lowest point at most CONTROLLER_GROUND_TOL
# below the floor and the capsule at most skin + CONTROLLER_BOX_TOL inside a
# box, by AD and by AE's manifolds; the frames on the plain versions within
# TOL_CONTROLLER (expected 0: AE is bitwise, and the sums are the same
# torch calls in both runs).
CONTROLLER_FRAMES, CONTROLLER_DT = 120, 1.0 / 60.0
CONTROLLER_START, CONTROLLER_VELOCITY = (-8.4, 0.91), (3.0, -1.0)
CONTROLLER_RADIUS, CONTROLLER_HALF = 0.4, 0.5
CONTROLLER_GROUND_TOL, CONTROLLER_BOX_TOL, TOL_CONTROLLER = 0.02, 0.01, 1e-5
CONTROLLER_CONFIG = char2d.MoveAndSlideConfig2D()
Q2D_KERNELS = ("ray_cast_2d", "point_2d", "shape_cast_2d")
GRID_KERNELS = ("point_3d", "ray_cast_grid", "aabb_overlap", "shape_overlap")
TOOLS_KERNELS = ("toi_pair", "shape_manifold")


def query2d_inputs(seed, centres):
    """(rays f32[R, 4] of unit directions, points f32[R, 2]) over the base-100
    2D pyramid (x within 52 m of 0, up to 101 m high), on the CPU: the first
    half of the rays down from above it, the next quarter level from its
    left, the last quarter from within ``QUERY2D_INSIDE_JITTER`` of the
    centres of seeded boxes of ``centres`` f32[B, 2] in any direction."""
    rng = np.random.default_rng(seed)
    n = QUERY2D_RAYS
    down, level = n // 2, n // 4
    inside = n - down - level
    boxes = centres[rng.choice(np.arange(1, centres.shape[0]), inside, replace=False)]
    o = np.concatenate([np.stack([rng.uniform(-52, 52, down), np.full(down, 110.0)], 1),
                        np.stack([np.full(level, -60.0), rng.uniform(0.2, 100, level)], 1),
                        boxes + rng.uniform(-QUERY2D_INSIDE_JITTER, QUERY2D_INSIDE_JITTER,
                                            (inside, 2))])
    a = rng.uniform(0.0, 2.0 * np.pi, inside)
    d = np.concatenate([np.tile([[0.0, -1.0]], (down, 1)), np.tile([[1.0, 0.0]], (level, 1))])
    d = d + rng.uniform(-0.05, 0.05, d.shape)
    d = np.concatenate([d, np.stack([np.cos(a), np.sin(a)], 1)])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    p = np.stack([rng.uniform(-52, 52, n), rng.uniform(-1, 101, n)], 1)
    return (torch.from_numpy(np.concatenate([o, d], 1).astype(np.float32)),
            torch.from_numpy(p.astype(np.float32)))


def ae_ops(tables, shape, ran):
    """Operations of one AE launch: each collider's rounds and final
    manifold at V's operations for the pair's kind, plus ``AE_ROUND_OPS`` a
    round."""
    plane, count = tables[5], tables[3]
    circle = int(shape[1]) == 1
    kinds = {"poly/plane": plane,
             "circle/circle" if circle else "circle/poly": ~plane & (count == 1),
             "circle/poly" if circle else "poly/poly": ~plane & (count > 1)}
    n = ran.double() + 1.0
    return sum(float(n[mask].sum()) * (V_OPS[k] + AE_ROUND_OPS) for k, mask in kinds.items())


def ac_ops(tables, r_n):
    """Operations of one AC launch of ``r_n`` rays, from each collider's
    own vertex count and radius (see ``AC_VERTEX_OPS``)."""
    n, radius, plane = tables[3].double(), tables[4], tables[5]
    per = (n * AC_VERTEX_OPS + torch.where(n >= 2, n * AC_EDGE_OPS, 0.0)
           + torch.where(n >= 3, n * AC_CORE_OPS, 0.0)
           + torch.where(radius > 1e-12, n * AC_DISK_OPS, 0.0) + AC_PAIR_OPS)
    return r_n * float(torch.where(plane, float(AC_PLANE_OPS), per).sum())


def ad_ops(tables, p_n):
    """Operations of one AD launch of ``p_n`` points (see ``AD_VERTEX_OPS``)."""
    n, plane = tables[3].double(), tables[5]
    per = n * AD_VERTEX_OPS + AD_PAIR_OPS
    return p_n * float(torch.where(plane, float(AD_PLANE_OPS), per).sum())


def kernels_ac_ad_ae(world, rays, points, casts, overlaps):
    """AC, AD and AE against their twins and rerun: AC on every ray solid and
    hollow, AD on every point, AE on each cast (24 rounds) and on its
    manifold at its origin (0 rounds), and on the manifolds ``overlaps`` of
    the shapes placed over a box (0 rounds). Returns ({name: measurements},
    AE's mean rounds a collider)."""
    tables = q2d.collider_tables(world)
    m = tables[0].shape[0]
    out, err = {}, {}
    for solid in (True, False):
        got = kac.ray_cast_2d(rays, solid, *tables)
        if not all(torch.equal(a, b) for a, b in zip(got, kac.ray_cast_2d(rays, solid, *tables))):
            raise AssertionError("ray_cast_2d: two runs differ")
        want = kac.ray_cast_2d_twin(rays, solid, *tables)
        err["ray_cast_2d"] = max(err.get("ray_cast_2d", 0.0), *(
            compare(f"ray_cast_2d {name} (solid={solid})", a, b, TOL_Q2D)
            for name, a, b in zip(("t", "normal"), got, want)))
    got = kad.point_2d(points, *tables)
    if not all(torch.equal(a, b) for a, b in zip(got, kad.point_2d(points, *tables))):
        raise AssertionError("point_2d: two runs differ")
    want = kad.point_2d_twin(points, *tables)
    err["point_2d"] = max(compare(f"point_2d {name}", a, b, TOL_Q2D)
                          for name, a, b in zip(("distance", "point"), got, want))
    rounds = []
    for name, shape, query in casts:
        for n_rounds in (kae.ROUNDS, 0):
            ran = torch.zeros((m,), dtype=torch.int32, device=world.device)
            got = kae.shape_cast_2d(query, *shape, *tables, rounds=n_rounds, ran=ran)
            again = kae.shape_cast_2d(query, *shape, *tables, rounds=n_rounds)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"shape_cast_2d: two runs of the {name} differ")
            want = kae.shape_cast_2d_twin(query, *shape, *tables, n_rounds)
            err["shape_cast_2d"] = max(err.get("shape_cast_2d", 0.0), *(
                compare(f"shape_cast_2d {name} {field} ({n_rounds} rounds)", a, b, TOL_Q2D)
                for field, a, b in zip(kae.Cast2D._fields, got, want)))
            if n_rounds:
                rounds.append((name, shape, query, ran))
    for name, shape, query in overlaps:
        got = kae.shape_cast_2d(query, *shape, *tables, rounds=0)
        if not all(torch.equal(a, b) for a, b in zip(got, kae.shape_cast_2d(
                query, *shape, *tables, rounds=0))):
            raise AssertionError(f"shape_cast_2d: two runs of the {name} over box 1 differ")
        want = kae.shape_cast_2d_twin(query, *shape, *tables, 0)
        err["shape_cast_2d"] = max(err["shape_cast_2d"], *(
            compare(f"shape_cast_2d {name} over box 1 {field}", a, b, TOL_Q2D)
            for field, a, b in zip(kae.Cast2D._fields, got, want)))

    r_n, p_n = rays.shape[0], points.shape[0]
    io = 16 * r_n + COLLIDER_ROW_BYTES * m + 12 * r_n * m
    b_ms, b_by = bound(io, ac_ops(tables, r_n))
    out["ray_cast_2d"] = dict(
        max_abs_err=err["ray_cast_2d"], ms=cuda_ms(lambda: kac.ray_cast_2d(rays, True, *tables)),
        plain_ms=once_ms(lambda: kac.ray_cast_2d_twin(rays, True, *tables))[1],
        bound_ms=b_ms, bound_by=b_by, library_ms=None, rays=r_n)
    io = 8 * p_n + COLLIDER_ROW_BYTES * m + 12 * p_n * m
    b_ms, b_by = bound(io, ad_ops(tables, p_n))
    out["point_2d"] = dict(
        max_abs_err=err["point_2d"], ms=cuda_ms(lambda: kad.point_2d(points, *tables)),
        plain_ms=once_ms(lambda: kad.point_2d_twin(points, *tables))[1],
        bound_ms=b_ms, bound_by=b_by, library_ms=None, points=p_n)
    # AE's times: one 24-round cast of the rectangle (polygon pairs, the most
    # operations a round).
    name, shape, query, ran = rounds[2]
    b_ms, b_by = bound(4 * 8 + 64 + 8 + (COLLIDER_ROW_BYTES + 37) * m, ae_ops(tables, shape, ran))
    out["shape_cast_2d"] = dict(
        max_abs_err=err["shape_cast_2d"],
        ms=cuda_ms(lambda: kae.shape_cast_2d(query, *shape, *tables)),
        plain_ms=once_ms(lambda: kae.shape_cast_2d_twin(query, *shape, *tables, kae.ROUNDS))[1],
        bound_ms=b_ms, bound_by=b_by, library_ms=None, cast=name,
        mean_rounds=float(ran.double().mean()),
        manifold_ms=cuda_ms(lambda: kae.shape_cast_2d(query, *shape, *tables, rounds=0)))
    mean_rounds = {n: round(float(r.double().mean()), 4) for n, _, _, r in rounds}
    return out, mean_rounds


def phase_dim2_queries(device, smi):
    """The 2D query path on ``box_pyramid_2d(100)`` after ``DIM2_KERNEL_STEPS``
    steps, as a user calls it: ``cast_ray`` and ``ray_hits(4)`` solid and
    hollow, ``all_ray_hits`` with ``QUERY2D_RAYS`` rays solid and hollow,
    ``project_point`` solid and hollow, ``point_intersections``,
    ``all_point_hits`` with as many points, and ``cast_shape``,
    ``shape_hits(4)`` and ``shape_intersections`` of each of the five query
    shapes from above the pyramid, straight down: the launch counts are
    those of these calls alone (AC 6, AD 4, AE 15). Then each kernel against
    its twin (``kernels_ac_ad_ae``) and the times. Returns ({name:
    measurements}, launch counts)."""
    world, _ = pyramid2d(device)
    for _ in range(DIM2_KERNEL_STEPS):
        world = physics_step_2d(world, DIM2_CONFIG)
    rays, points = query2d_inputs(21, world.bodies.pos.cpu().numpy())
    rays, points = rays.to(device), points.to(device)
    rng = np.random.default_rng(22)
    shapes = [(name, make(device)) for name, make in QUERY2D_SHAPES]
    casts = [(name, shape, (float(rng.uniform(-40, 40)), 120.0), float(rng.uniform(-1, 1)),
              (float(rng.uniform(-0.05, 0.05)), -1.0)) for name, shape in shapes]
    above, down = (0.3, 110.0), (0.0, -1.0)
    torch.cuda.synchronize()

    kernels.reset_launches()
    one = [(q2d.cast_ray(world, above, down, QUERY2D_MAX_DISTANCE, solid),
            q2d.ray_hits(world, above, down, 4, QUERY2D_MAX_DISTANCE, solid))
           for solid in (True, False)]
    t_s, n_s = q2d.all_ray_hits(world, rays[:, :2], rays[:, 2:], True)
    t_h, _ = q2d.all_ray_hits(world, rays[:, :2], rays[:, 2:], False)
    inside_box = tuple(float(v) for v in world.bodies.pos[1].tolist())
    proj = [q2d.project_point(world, inside_box, solid) for solid in (True, False)]
    holding = q2d.point_intersections(world, inside_box, 4)
    dist, _ = q2d.all_point_hits(world, points)
    cast_results = [(q2d.cast_shape(world, shape, origin, angle, d, QUERY2D_MAX_DISTANCE),
                     q2d.shape_hits(world, shape, origin, angle, d, QUERY2D_MAX_DISTANCE, 4),
                     q2d.shape_intersections(world, shape, inside_box, angle, 8))
                    for _, shape, origin, angle, d in casts]
    torch.cuda.synchronize()
    got = kernels.launches()
    want = dict.fromkeys(kernels.launches(), 0)
    want.update(ray_cast_2d=6, point_2d=4, shape_cast_2d=3 * len(casts))
    if got != want:
        raise AssertionError(f"dim2 queries: launches {got}, expected {want}")

    texts = []
    for solid, (hit, many) in zip((True, False), one):
        if not (bool(hit.hit) and int(hit.collider) == int(many.collider[0])):
            raise AssertionError(f"dim2 queries: the ray down (solid={solid}) hit nothing or "
                                 "its two calls disagree")
        texts.append(f"ray down (solid={solid}) {float(hit.distance):.3f} m to "
                     f"{int(hit.collider)}, {int(many.hit.sum())} hits")
    if not (bool(proj[0]["is_inside"]) and float(proj[0]["distance"]) < 0.0
            and int(holding[0]) == 1 and bool(proj[1]["hit"])
            and abs(float(proj[1]["distance"])) <= 0.5 + 1e-3):
        raise AssertionError(f"dim2 queries: a point inside box 1 is not: {proj}, {holding}")
    for (name, *_), (hit, many, over) in zip(casts, cast_results):
        if not (bool(hit.hit) and int(hit.collider) == int(many.collider[0])
                and float(hit.distance) > 0.0 and 1 in over.tolist()):
            raise AssertionError(f"dim2 queries: the {name} cast hit nothing, its two calls "
                                 f"disagree or it does not overlap box 1")
        texts.append(f"{name} {float(hit.distance):.3f} m to {int(hit.collider)}, "
                     f"{int(many.hit.sum())} hits, overlaps {int((over >= 0).sum())} at box 1")
    down_rays, inside = QUERY2D_RAYS // 2, slice(QUERY2D_RAYS * 3 // 4, None)
    if not (bool((t_s[:down_rays] < q2d.BIG).any(1).all())
            and bool((t_h[:down_rays] < q2d.BIG).any(1).all())):
        raise AssertionError("dim2 queries: a ray down onto the pyramid hit nothing")
    if not (bool((t_s[inside] == 0.0).any(1).all())
            and bool(((t_h[inside] > 0.0) & (t_h[inside] < q2d.BIG)).any(1).all())):
        raise AssertionError("dim2 queries: a ray from inside a box did not start in it "
                             "(solid) or find no way out of it (hollow)")
    if not bool(torch.isfinite(dist).all()):
        raise AssertionError("dim2 queries: non-finite point distances")

    queries = [(name, shape, q2d.cast_query(world, origin, angle, d, QUERY2D_MAX_DISTANCE))
               for name, shape, origin, angle, d in casts]
    overlaps = [(name, shape, q2d.cast_query(world, inside_box, angle, (0.0, 0.0), 0.0))
                for name, shape, _, angle, _ in casts]
    out, mean_rounds = kernels_ac_ad_ae(world, rays, points, queries, overlaps)
    say("dim2 queries", f"box_pyramid_2d({DIM2_BASE}) after {DIM2_KERNEL_STEPS} steps, "
        f"{world.colliders.capacity} colliders: " + "; ".join(texts)
        + f"; {QUERY2D_RAYS} rays in one launch each way, {int((t_s < q2d.BIG).sum())} "
        f"(ray, collider) hits solid; {QUERY2D_RAYS} points, {int((dist < 0).sum())} inside a "
        f"collider; launches of these calls: {dict((k, got[k]) for k in Q2D_KERNELS)}; "
        f"against the twins (AC on every ray both ways, {QUERY2D_RAYS // 4} of them from inside "
        f"boxes, AD on every point, AE on the five casts at 24 rounds and 0 and on the five "
        f"shapes over box 1), reruns bitwise; AE's mean rounds a collider {mean_rounds}; "
        + show("times", out) + f" [{smi}]")
    return out, got


def capsule_samples(pos, k=9):
    """f32[F * k, 2]: k points along the upright capsule's segment at each
    frame's position ``pos`` f32[F, 2]."""
    s = torch.linspace(-CONTROLLER_HALF, CONTROLLER_HALF, k, device=pos.device)
    pts = pos[:, None, :] + torch.stack([torch.zeros_like(s), s], -1)[None]
    return pts.reshape(-1, 2)


def controller_frames(world, shape):
    """``CONTROLLER_FRAMES`` frames of ``move_and_slide``: (positions f32[F,
    2], velocities f32[F, 2], last normals f32[F, 2]), on the device."""
    pos = torch.tensor(CONTROLLER_START, device=world.device)
    vel = torch.tensor(CONTROLLER_VELOCITY, device=world.device)
    frames = []
    for _ in range(CONTROLLER_FRAMES):
        pos, v, n = char2d.move_and_slide(world, shape, pos, vel, CONTROLLER_DT,
                                          config=CONTROLLER_CONFIG)
        frames.append(torch.stack([pos, v, n]))
    return torch.stack(frames).unbind(1)


@contextlib.contextmanager
def plain_shape_casts_2d():
    """Within the block Kernel AE (all the controller launches) is its plain
    version."""
    def shape_cast_2d_plain(query, q_verts, q_count, q_radius, pos, cs, verts, count, radius,
                            plane, rounds=kae.ROUNDS, ran=None):
        return kae.shape_cast_2d_twin(query, q_verts, q_count, q_radius, pos, cs, verts, count,
                                      radius, plane, rounds)

    kept = kae.shape_cast_2d
    kae.shape_cast_2d = shape_cast_2d_plain
    try:
        yield
    finally:
        kae.shape_cast_2d = kept


def phase_controller_2d(device, smi):
    """The character controller at full width: ``many_pyramids_2d(10, 10)``
    (5,501 colliders) after ``DIM2_KERNEL_STEPS`` steps, a capsule driven by
    ``move_and_slide`` for ``CONTROLLER_FRAMES`` frames at 60 Hz across the
    floor into a pyramid (8 launches of AE a frame: two depenetrations of 2
    rounds, 4 slides); then each frame checked: the lowest point at most
    ``CONTROLLER_GROUND_TOL`` below the floor, and neither AD (points along
    the capsule's segment) nor AE's manifolds (``shape_intersections``, its
    separations) finding it more than ``skin + CONTROLLER_BOX_TOL`` inside a
    box; the frames rerun bitwise, and run on the plain versions within
    ``TOL_CONTROLLER``. Returns the launch counts."""
    world, _ = many_pyramids2d(device)
    for _ in range(DIM2_KERNEL_STEPS):
        world = physics_step_2d(world, DIM2_CONFIG)
    shape = q2d.shape_capsule(CONTROLLER_RADIUS, 2 * CONTROLLER_HALF, device=device)
    # The face the capsule walks into: the first hit of a ray along the floor.
    face = CONTROLLER_START[0] + float(q2d.cast_ray(world, (CONTROLLER_START[0], 0.3),
                                                    (1.0, 0.0)).distance)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    pos, vel, normal = controller_frames(world, shape)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = kernels.launches()
    want = dict.fromkeys(got, 0)
    want["shape_cast_2d"] = 8 * CONTROLLER_FRAMES
    if got != want:
        raise AssertionError(f"controller2d: launches {got}, expected {want}")

    ground = float((pos[:, 1] - CONTROLLER_HALF - CONTROLLER_RADIUS).min())
    boxes = ~world.colliders.is_plane & world.colliders.active
    dist, _ = q2d.all_point_hits(world, capsule_samples(pos))
    ad_depth = float((CONTROLLER_RADIUS - dist[:, boxes].amin(1)).max())
    ae_depth, overlapping = 0.0, 0
    for p in pos:
        m = q2d.manifold_vs_all(world, shape, p)
        ae_depth = max(ae_depth, float(-m.sep[boxes].min()))
        overlapping += int((q2d.shape_intersections(world, shape, p, 0.0, 8) >= 0).sum())
    limit = CONTROLLER_CONFIG.skin_width + CONTROLLER_BOX_TOL
    x_end = float(pos[-1, 0])
    if not (ground >= -CONTROLLER_GROUND_TOL and ad_depth <= limit and ae_depth <= limit):
        raise AssertionError(f"controller2d: lowest point {ground} m from the floor, "
                             f"{ad_depth} m (AD) and {ae_depth} m (AE) into a box")
    stop = face - CONTROLLER_RADIUS - CONTROLLER_CONFIG.skin_width
    if not abs(x_end - stop) <= 0.01:
        raise AssertionError(f"controller2d: the capsule ended at x = {x_end}, not at the "
                             f"pyramid's face ({face}) less its radius and the skin")
    again = controller_frames(world, shape)
    if not all(torch.equal(a, b) for a, b in zip((pos, vel, normal), again)):
        raise AssertionError("controller2d: two runs of the frames differ")
    kernels.reset_launches()
    t1 = time.perf_counter()
    with plain_shape_casts_2d():
        plain = controller_frames(world, shape)
    plain_s = time.perf_counter() - t1
    if any(kernels.launches().values()):
        raise AssertionError(f"controller2d: kernels launched on the plain versions: "
                             f"{kernels.launches()}")
    apart = max(float((a - b).abs().max()) for a, b in zip((pos, vel, normal), plain))
    if not apart <= TOL_CONTROLLER:
        raise AssertionError(f"controller2d: the plain run parts by {apart}")
    blocked = int((normal.abs().sum(1) > 0).sum())
    say("controller2d", f"many_pyramids_2d({MANY2D_GRID}, {MANY2D_BASE}) after "
        f"{DIM2_KERNEL_STEPS} steps, {world.colliders.capacity} colliders: a capsule, "
        f"{CONTROLLER_FRAMES} frames of move_and_slide at 60 Hz from x {CONTROLLER_START[0]} "
        f"at {CONTROLLER_VELOCITY} m/s: {1e3 * seconds / CONTROLLER_FRAMES:.2f} ms a frame, "
        f"AE launched {got['shape_cast_2d']} times; ends at x {x_end:.4f} (the pyramid's face "
        f"{face:.4f} less the radius and the skin: {stop:.4f}), blocked in {blocked} frames; "
        f"lowest point {ground:.4f} m "
        f"from the floor (limit -{CONTROLLER_GROUND_TOL}); deepest into a box {ad_depth:.4f} m "
        f"by AD, {ae_depth:.4f} m by AE (limit {limit}), {overlapping} overlaps found by "
        f"shape_intersections; rerun bitwise; the plain versions ({plain_s:.1f} s) within "
        f"{apart:.3g} (limit {TOL_CONTROLLER}) [{smi}]")
    return got


def phase_dim2_showcase(device):
    """``examples/native_2d_showcase.py``'s world and checks, up to its
    render: a mixed 2D pile settles in 240 steps, a kicked circle moves, a ray
    and its predicate variant, a probe cast onto the pile, and a capsule
    walked into a wall by ``move_and_slide`` (from clear of the pile)."""
    cfg = PhysicsConfig(substeps=4, max_colors=4)
    b = SceneBuilder2D()
    ground = b.add_body(body_type=BodyType.STATIC)
    b.half_space(ground, normal=(0.0, 1.0))
    wall = b.add_body(pos=(6.0, 2.0), body_type=BodyType.STATIC)
    b.box(wall, 0.5, 2.0)
    drops = []
    for kind, pos in (("circle", (0.0, 1.0)), ("box", (0.1, 2.2)), ("capsule", (-0.1, 3.6)),
                      ("pentagon", (0.05, 5.0))):
        body = b.add_body(pos=pos)
        {"circle": lambda: b.circle(body, 0.45), "box": lambda: b.box(body, 0.45, 0.45),
         "capsule": lambda: b.capsule(body, 0.25, 0.8),
         "pentagon": lambda: b.regular_polygon(body, 0.5, 5)}[kind]()
        drops.append(body)
    world = b.finalize(device=device)
    for _ in range(240):
        world = physics_step_2d(world, cfg)
    pos = world.bodies.pos.cpu()
    if not (bool(torch.isfinite(pos).all()) and bool((pos[drops, 1] > 0.1).all())
            and bool((pos[drops, 1] < 4.0).all())):
        raise AssertionError(f"dim2 showcase: the pile did not settle: {pos[drops]}")
    world = forces2d.apply_linear_impulse(world, drops[0], (3.0, 0.0))
    for _ in range(30):
        world = physics_step_2d(world, cfg)
    if not float(world.bodies.pos[drops[0], 0]) > float(pos[drops[0], 0]) + 0.2:
        raise AssertionError("dim2 showcase: the kicked circle did not move")
    hit = q2d.cast_ray(world, (0.0, 10.0), (0.0, -1.0))
    ground_hit = q2d.cast_ray_predicate(world, (0.0, 10.0), (0.0, -1.0),
                                        predicate=lambda w, ids: w.colliders.is_plane[ids])
    probe = q2d.cast_shape(world, q2d.shape_circle(0.3, device=device), (0.0, 10.0), 0.0,
                           (0.0, -1.0), 20.0)
    if not (bool(hit.hit) and float(hit.distance) < 10.0 + 1e-3
            and int(ground_hit.collider) == 0 and abs(float(ground_hit.distance) - 10.0) < 1e-3
            and bool(probe.hit) and float(probe.distance) < float(ground_hit.distance)):
        raise AssertionError(f"dim2 showcase: queries {hit}, {ground_hit}, {probe}")
    # The example starts the character at x 2.5, where its pentagon comes to
    # rest or not by chaos: the reference compiled one IEEE operation at a
    # time rests it at x 2.75 and fails the example's own check (ROADMAP 3b).
    # The character starts 1 m right of the pile's rightmost body where that
    # is further right.
    start = max(2.5, float(world.bodies.pos[drops, 0].max()) + 1.0)
    shape = q2d.shape_capsule(0.4, 1.0, device=device)
    cpos = torch.tensor([start, 0.91], device=device)
    for _ in range(30):
        cpos, _, _ = char2d.move_and_slide(world, shape, cpos, (2.0, -0.5), 1.0 / 15)
    cp = cpos.tolist()
    if not (cp[1] > 0.85 and 4.0 < cp[0] <= 5.5 - 0.4 + 0.03):
        raise AssertionError(f"dim2 showcase: the character ended at {cp}")
    say("dim2 showcase", f"native_2d_showcase's checks pass up to its render: pile settled "
        f"(highest {float(pos[drops, 1].max()):.3f} m), kicked circle moved, ray "
        f"{float(hit.distance):.3f} m, ground {float(ground_hit.distance):.3f} m, probe "
        f"{float(probe.distance):.3f} m, character from x {start:.3f} to ({cp[0]:.3f}, "
        f"{cp[1]:.3f})")


# ---- the 3D extension points: user shapes, hooks, custom joints ----------------------

EXT_SEMI = (0.5, 0.25, 0.5)  # examples/custom_collider.py's ellipsoid
CUSTOM_CODE = CUSTOM_SHAPE_BASE  # the ellipsoid, the first custom shape
CUSTOM_PAIRS = tuple((t, CUSTOM_CODE) for t in (0, 1, 2, 4, 5, 8, CUSTOM_CODE))
EXT_CONFIG = PhysicsConfig(substeps=4, shape_pairs=TERRAIN_PAIRS + CUSTOM_PAIRS,
                           sap_window=TERRAIN_WINDOW)
EXT_STEPS, EXT_KERNEL_STEPS = 60, 40
EXT_CENTRES = 256         # of the 1,024 points, at ellipsoid centres
EXT_PLAIN_ROWS = 64       # rays and points the plain versions take
EXT_PLAIN_PAIRS = 2048    # pairs of each custom bucket the plain versions take
EXT_RANDOM_PLANE = 4096   # seeded ellipsoid/half-space poses for O's custom instance
HOOK_STEPS, HOOK_BELT_SPEED, HOOK_EVERY = 180, 2.0, 10
# The hooked pile's gate, from the JAX reference's own reading of the same
# pile cut to 2,000 cubes (tests/torch_cases/hook_pile_reference.py, seeds
# 0-2, on the CPU): at step 180 up to 6.7 % of its cubes on the ground move
# along +x at 0.5 m/s or less (cubes of the collapsing upper layers land by
# the pile's edges and knock them outward, the slowest at -6.07 m/s), and the
# median is 2 m/s within 3e-4. The gate: at most HOOK_SLOW_SHARE of the cubes
# on the ground at 0.5 m/s or less, the median within HOOK_MEDIAN_TOL.
HOOK_SLOW_SHARE, HOOK_MEDIAN_TOL = 0.067, 0.01
PENDULUMS, PENDULUM_STEPS, PENDULUM_REST, PENDULUM_TOL = 1024, 120, 2.5, 0.05
# Operations of one support call of the ellipsoid (9 multiplies, a 3-term
# dot, a max, a square root, 3 divisions), and around each call in AJ's
# Frank-Wolfe step and in AF's two iterations.
ELLIPSOID_OPS, AJ_STEP_OPS, AF_STEP_OPS = 16, 30, 25
CUSTOM_KERNELS = ("custom_aabbs", "custom_convex_manifold", "custom_plane_manifold",
                  "custom_hull_manifold", "ray_support", "custom_point")
REPLACES.update({
    "custom_aabbs": ("cuda", "avian_tpu_torch/csrc/custom_shape.cuh",
                     "avian_tpu/geometry/shapes.py:55"),
    "custom_convex_manifold": ("cuda", "avian_tpu_torch/csrc/custom_shape.cuh",
                               "avian_tpu/geometry/convex.py:468"),
    "custom_plane_manifold": ("cuda", "avian_tpu_torch/csrc/custom_shape.cuh",
                              "avian_tpu/geometry/convex.py:702"),
    "custom_hull_manifold": ("cuda", "avian_tpu_torch/csrc/custom_shape.cuh",
                             "avian_tpu/geometry/convex.py:881"),
    "ray_support": ("cuda", "avian_tpu_torch/csrc/custom_shape.cuh",
                    "avian_tpu/queries/raycast.py:324"),
    "custom_point": ("cuda", "avian_tpu_torch/csrc/custom_shape.cuh",
                     "avian_tpu/queries/point.py:135"),
})


def custom_terrain(device):
    """``terrain_shapes(TERRAIN_N, per_row=TERRAIN_PER_ROW, seed=TERRAIN_SEED)``'s
    builder calls with every fourth dynamic body's collider the example's
    ellipsoid (a rock's draws are still made, so that every other body is the
    terrain's), at 24 contact slots a body. Returns (world, ids, the
    ellipsoids' ids)."""
    rng = np.random.default_rng(TERRAIN_SEED)
    field, per_row, n = TERRAIN_FIELD, TERRAIN_PER_ROW, TERRAIN_N
    heights = scenes.terrain_heights(field)
    b = SceneBuilder()
    ground = b.add_body(body_type=BodyType.STATIC)
    b.heightfield(ground, heights, float(field - 1), float(field - 1))
    x0 = -6.5 - (per_row - 12) * 0.55
    mass, inertia = shared_ext.ellipsoid_mass_inertia(*EXT_SEMI)
    ids, ellipsoids = [], []
    for k in range(n):
        x = (k % per_row) * 1.1 + x0 + rng.uniform(-0.05, 0.05)
        z = ((k // per_row) % per_row) * 1.1 + x0 + rng.uniform(-0.05, 0.05)
        y = float(scenes.terrain_height_at(heights, x, z)) + 1.0 + (k // (per_row * per_row)) * 1.5
        body = b.add_body(pos=(x, y, z))
        kind = k % 7
        rock = rng.normal(size=(12, 3)) if kind == 5 else None
        if k % 4 == 3:
            b.custom_collider(body, shape=shared_ext.ELLIPSOID, params=EXT_SEMI, mass=mass,
                              inertia=inertia)
            ellipsoids.append(body)
        elif kind == 0:
            b.sphere(body, 0.4)
        elif kind == 1:
            b.box(body, 0.35, 0.35, 0.35)
        elif kind == 2:
            b.capsule(body, 0.25, 0.5)
        elif kind == 3:
            b.cylinder(body, 0.3, 0.7)
        elif kind == 4:
            b.cone(body, 0.35, 0.7)
        elif kind == 5:
            b.convex_hull(body, (0.4 * rock / np.linalg.norm(rock, axis=1, keepdims=True))
                          .astype(np.float32))
        else:
            b.round_cuboid(body, 0.5, 0.5, 0.5, 0.05)
        ids.append(body)
    world = b.finalize(max_bodies=n + 1, max_colliders=n + 2 * (field - 1) ** 2,
                       max_contacts=TERRAIN_SLOTS_PER_BODY * (n + 1), device=device)
    return world, ids, ellipsoids


def ext_steps(what, world, config, steps, seen, drops=None, **kw):
    """``steps`` steps through ``physics_step`` with diagnostics; fails on a
    dropped pair or an overflow drop (unless ``drops``, a list, gathers
    their running maxima) or a non-finite state, and gathers the canonical
    pairs launched into ``seen``. Returns (world, ms a step)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        world, diag = physics_step(world, config, return_diagnostics=True, **kw)
        dropped, overflow = int(diag["dropped_pairs"]), int(diag["overflow_dropped"])
        if drops is not None:
            drops[:] = [max(drops[0], dropped), max(drops[1], overflow)]
        elif dropped or overflow:
            raise AssertionError(f"{what}: dropped {dropped} pairs, {overflow} overflow rows")
        seen.update(pair for pair, n in diag["manifold_pairs"].items() if n)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / max(steps, 1)
    b = world.bodies
    if not all(bool(torch.isfinite(getattr(b, f)).all()) for f in ("pos", "quat", "lin_vel")):
        raise AssertionError(f"{what}: non-finite state")
    return world, ms


def custom_bucket_against_twin(bk):
    """A custom bucket's kernel on all its pairs against the plain version
    on the first ``EXT_PLAIN_PAIRS``: (max abs err, kernel inputs, twin)."""
    got = bk.run()
    n = min(EXT_PLAIN_PAIRS, bk.slots.shape[0])
    sub = tuple(x[:n] for x in bk.inputs[:6]) + (bk.inputs[6],)
    want = kcs._pair_twin(bk.kind, *sub)
    err = 0.0
    for name, g, w in zip(("normal", "point_a", "point_b", "separation", "feature_id", "count"),
                          got, want):
        err = max(err, compare(f"{bk.name} {bk.pair} {name}", g[:n], w))
    return err


def custom_pair_work(bk):
    """(bytes, operations) of one custom bucket of M or P, as ``pair_work``
    counts M's and P's from the launch's own inputs: each input and output
    once; M's operations a pair, or P's a pair and a hull and a vertex of
    each pair's own hull (params lane 1; 12 bytes a vertex read); and the
    support calls of each custom side at ``ELLIPSOID_OPS`` each."""
    pa, prm_a = bk.inputs[0], bk.inputs[2]
    k = pa.shape[0]
    io = nbytes(*bk.inputs[:6]) + k * 148
    sides = 2 if bk.pair[0] >= CUSTOM_SHAPE_BASE else 1
    ops = k * sides * kcs.PAIR_SUPPORT_CALLS * ELLIPSOID_OPS
    if bk.name == "custom_hull_manifold":
        verts = int(prm_a[:, 1].sum())
        io += 12 * verts
        ops += (k * (OPS_PER_PAIR["hull_manifold"] + OPS_PER_HULL["hull_manifold"])
                + OPS_PER_HULL_VERTEX["hull_manifold"] * verts)
    else:
        ops += k * OPS_PER_PAIR["convex_manifold"]
    return io, ops


def random_plane_poses(device, k=EXT_RANDOM_PLANE, seed=13):
    """``k`` seeded poses of an ellipsoid of seeded semi-axes 0 - 1.1 of its
    largest semi-axis above a tilted half-space: O's custom instance's
    inputs (pa, qa, na, pb, qb, prm_b) with 7 parameter lanes."""
    rng = np.random.default_rng(seed)
    semi = rng.uniform(0.15, 0.6, (k, 3)).astype(np.float32)
    qa = rng.normal(size=(k, 4)) * [0.1, 0.1, 0.1, 1.0]
    qa = (qa / np.linalg.norm(qa, axis=1, keepdims=True)).astype(np.float32)
    qb = rng.normal(size=(k, 4))
    qb = (qb / np.linalg.norm(qb, axis=1, keepdims=True)).astype(np.float32)
    pa = rng.uniform(-1.0, 1.0, (k, 3)).astype(np.float32)
    up = quat_m.rotate(torch.from_numpy(qa), torch.tensor([0.0, 1.0, 0.0]).expand(k, 3)).numpy()
    pb = pa + up * (semi.max(1) * rng.uniform(0.0, 1.1, k))[:, None]
    na = np.zeros((k, 7), np.float32)
    na[:, 1] = 1.0
    prm = np.zeros((k, 7), np.float32)
    prm[:, :3] = semi
    return tuple(torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
                 for x in (pa, qa, na, pb.astype(np.float32), qb, prm))


def example_worlds(device):
    """``examples/custom_collider.py``'s world (9 ellipsoids on a half-space,
    300 steps: every body 0.15 < y < 0.8, a ray down onto the first at y 0.5
    within 0.06) and ``tests/test_custom_shapes.py::
    test_ellipsoid_vs_box_and_ellipsoid``'s (300 steps: e2 at y 1.3 within
    0.08, e3 above 0.45), with their own checks. Returns (the example's world,
    a line)."""
    seen = set()
    world, ids = shared_ext.custom_collider_world(SceneBuilder, shared_ext.ELLIPSOID,
                                                  device=device)
    world, ms = ext_steps("custom collider example", world, PhysicsConfig(max_colors=8), 300,
                          seen)
    y = world.bodies.pos[ids, 1]
    if not (bool((y > 0.15).all()) and bool((y < 0.8).all())):
        raise AssertionError(f"custom collider example: rest heights {y.tolist()}")
    world = bp_m.update_aabbs(world, PhysicsConfig(), world.custom_shapes)
    target = world.bodies.pos[ids[0]].tolist()
    hit = cast_ray(world, (target[0], 3.0, target[2]), (0.0, -1.0, 0.0))
    if not (bool(hit.hit) and abs(float(hit.point[1]) - 2.0 * EXT_SEMI[1]) < 0.06):
        raise AssertionError(f"custom collider example: the ray down hit {hit}")
    if (3, CUSTOM_CODE) not in seen:
        raise AssertionError("custom collider example: O's custom instance never launched")
    pworld, (e1, box, e2, e3) = shared_ext.custom_pairs_world(SceneBuilder, shared_ext.ELLIPSOID,
                                                              device=device)
    pworld, _ = ext_steps("ellipsoids on a box", pworld, PhysicsConfig(max_colors=4), 300, seen)
    p = pworld.bodies.pos
    if not (abs(float(p[e2, 1]) - 1.3) < 0.08 and float(p[e3, 1]) > 0.45):
        raise AssertionError(f"ellipsoids on a box: e2 at {p[e2].tolist()}, e3 at "
                             f"{p[e3].tolist()}")
    line = (f"custom_collider example: 9 ellipsoids rest at y {float(y.min()):.3f}-"
            f"{float(y.max()):.3f}, the ray down hits y {float(hit.point[1]):.4f} ({ms:.2f} ms a "
            f"step); ellipsoid on a box at y {float(p[e2, 1]):.4f}, over an ellipsoid at "
            f"{float(p[e3, 1]):.4f}")
    return world, line


def phase_hooks_and_joints(device, smi):
    """Hooks: ``cube_pile(10_000)`` at 16 N for 180 steps with the conveyor's
    ``modify_contacts`` on the ground (body 0) and a ``filter_pairs`` that
    drops every pair of a cube whose index is divisible by 10: every such
    cube falls through the ground, and of the others resting on it at most
    ``HOOK_SLOW_SHARE`` (the reference's reading) move +x at 0.5 m/s or
    less, their median at the belt's 2 m/s; the
    one-way platform's and the conveyor belt's
    example worlds with their checks. Custom joints: 1,024 copies of
    ``examples/custom_constraint.py``'s pendulum side by side in a world with
    no joint slots, 120 steps, every pair within 0.05 m of its rest length,
    and the example's own world and checks."""

    class DropTens:
        def filter_pairs(self, world, ca, cb, valid):
            body = world.colliders.body_idx
            ba, bb = body[ca.long()], body[cb.long()]
            return valid & ~((ba % HOOK_EVERY == 0) & (ba > 0)) & ~((bb % HOOK_EVERY == 0) & (bb > 0))

    class Hooks(DropTens, shared_ext.Conveyor):
        pass

    world = pile(N_CUBES, device)
    seen, drops = set(), [0, 0]
    # The filtered cubes fall through the pile: their pairs take slots of
    # the broadphase's buffer before the filter drops them, so at 16 N some
    # pairs find no slot; the run reports how many.
    world, hook_ms = ext_steps("hooks", world, PILE_CONFIG.replace(sleep_early_out=False),
                               HOOK_STEPS, seen, drops=drops, hooks=Hooks(0, HOOK_BELT_SPEED))
    pos, vel = world.bodies.pos[1:], world.bodies.lin_vel[1:]
    idx = torch.arange(1, world.bodies.capacity, device=device)
    dropped = (idx % HOOK_EVERY == 0) & world.bodies.active[1:]
    # On the ground: a cube's centre within 5 cm of its half extent above the
    # plane and no vertical motion to speak of.
    resting = (~dropped & ((pos[:, 1] - 0.5).abs() < 0.05) & (vel[:, 1].abs() < 0.1)
               & world.bodies.active[1:])
    if not bool((pos[dropped, 1] < 0.0).all()):
        raise AssertionError(f"hooks: {int((pos[dropped, 1] >= 0).sum())} filtered cubes above "
                             "the ground")
    # At step 180 the upper layers are still coming down, and where they land
    # by the pile's edges they knock cubes on the ground outward faster than
    # the belt carries them, in the reference as here: the gate is the
    # reference's reading (HOOK_SLOW_SHARE).
    slowest = float(vel[resting, 0].min())
    quantiles = torch.quantile(vel[resting, 0], torch.tensor([0.01, 0.5], device=device)).tolist()
    slow = int((vel[resting, 0] <= 0.5).sum())
    on_ground = int(resting.sum())
    if not (on_ground > 100 and slow <= HOOK_SLOW_SHARE * on_ground
            and abs(quantiles[1] - HOOK_BELT_SPEED) < HOOK_MEDIAN_TOL):
        raise AssertionError(f"hooks: {on_ground} cubes on the ground, slowest along +x "
                             f"{slowest} m/s, 1 % and 50 % quantiles {quantiles}, "
                             f"{slow} at most 0.5 m/s")
    oworld, (above, below) = shared_ext.one_way_world(SceneBuilder, device=device)
    oworld, _ = ext_steps("one-way platform", oworld, PhysicsConfig(), 240, seen,
                          hooks=shared_ext.OneWay())
    ya, yb = float(oworld.bodies.pos[above, 1]), float(oworld.bodies.pos[below, 1])
    if not (abs(ya - 0.4) < 0.05 and abs(yb - 0.4) < 0.05):
        raise AssertionError(f"one-way platform: the balls end at y {ya} and {yb}")
    bworld, box = shared_ext.belt_world(SceneBuilder, -3.0, 0.6, dict(
        max_bodies=4, max_colliders=4, max_contacts=16), device=device)
    bworld, _ = ext_steps("conveyor belt", bworld, PhysicsConfig(), 180, seen,
                          hooks=shared_ext.Conveyor())
    bx, bv = float(bworld.bodies.pos[box, 0]), float(bworld.bodies.lin_vel[box, 0])
    if not (bx > -2.0 and bv > 0.5):
        raise AssertionError(f"conveyor belt: the box ends at x {bx} at {bv} m/s")

    jworld, anchors, cubes = shared_ext.pendulums_world(SceneBuilder, PENDULUMS, device=device)
    if jworld.joints.capacity:
        raise AssertionError("pendulums: the world has joint slots")
    con = shared_ext.CenterDistance(anchors, cubes, PENDULUM_REST)
    jworld, joint_ms = ext_steps("pendulums", jworld, PhysicsConfig(), PENDULUM_STEPS, seen,
                                 custom_joints=con)
    p = jworld.bodies.pos
    d = (p[cubes] - p[anchors]).norm(dim=1)
    gap = float((d - PENDULUM_REST).abs().max())
    low = float(p[cubes, 1].max())
    if not gap < PENDULUM_TOL:
        raise AssertionError(f"pendulums: rest length off by {gap}")
    eworld, (anchor, cube) = shared_ext.pendulum_world(SceneBuilder, device=device)
    eworld, _ = ext_steps("custom constraint example", eworld, PhysicsConfig(), 180, seen,
                          custom_joints=shared_ext.CenterDistance(anchor, cube, PENDULUM_REST))
    ep = eworld.bodies.pos
    ed = float((ep[cube] - ep[anchor]).norm())
    if not (abs(ed - PENDULUM_REST) < 0.05 and float(ep[cube, 1]) < -1.0):
        raise AssertionError(f"custom constraint example: |d| {ed}, cube at {ep[cube].tolist()}")
    say("extensions", f"hooks: cube_pile({N_CUBES}) {HOOK_STEPS} steps at {hook_ms:.2f} ms a "
        f"step with the conveyor on the ground and every tenth cube filtered: "
        f"{int(dropped.sum())} filtered cubes all below the ground (highest "
        f"{float(pos[dropped, 1].max()):.1f} m), {int(resting.sum())} cubes on the ground at "
        f"median {quantiles[1]:.3f} m/s along +x, {on_ground - slow} of them faster than 0.5, "
        f"{slow} ({slow / on_ground:.4f}) not (slowest {slowest:.3f}, 1 % quantile "
        f"{quantiles[0]:.3f}), at most "
        f"{drops[0]} pairs dropped and {drops[1]} overflow rows in a step; "
        f"one-way platform balls at y {ya:.3f} and {yb:.3f}; conveyor box at x {bx:.3f}, "
        f"{bv:.3f} m/s. Custom joints: {PENDULUMS} pendulums, {PENDULUM_STEPS} steps at "
        f"{joint_ms:.2f} ms a step, no joint slots, rest length within {gap:.2e} m, highest "
        f"cube y {low:.3f}; the example's |d| {ed:.4f} m, cube y {float(ep[cube, 1]):.3f} [{smi}]")


def phase_extensions(device, smi):
    """User shapes at full width: ``custom_terrain`` (2,500 of its 10,000 bodies
    the example's ellipsoid) at 24 N, window 64: 40 steps, then every custom
    kernel held to its plain version on the same inputs (E's custom pass on
    every custom collider, M's and P's instances on each custom bucket, O's
    on seeded ellipsoid/half-space poses, AJ on ``EXT_PLAIN_ROWS`` rays, AF's
    on ``EXT_PLAIN_ROWS`` points), then 20 more steps (every body above the
    field, every custom pair bucket launched), 1,024 rays (768 down, 256
    level) and their ``pick_batch``, and 1,024 points (256 at ellipsoid
    centres, each inside its ellipsoid) through ``all_hits`` and
    ``all_point_hits``; the example worlds with their checks; hooks and
    custom joints (``phase_hooks_and_joints``). The custom kernels' launches
    are counted over the steps, casts and queries, the comparisons
    excluded. Returns (measured rows, launches)."""
    t0 = time.perf_counter()
    world, ids, ellipsoids = custom_terrain(device)
    build_s = custom_build.library(world.custom_shapes).build_s  # built in phase_build
    seen = set()
    kernels.reset_launches()
    world, ms40 = ext_steps("custom terrain", world, EXT_CONFIG, EXT_KERNEL_STEPS, seen)
    counts = kernels.launches()
    shapes = world.custom_shapes
    out = {}

    # E's custom pass.
    col, cfg = world.colliders, EXT_CONFIG
    args = (cfg.dt, cfg.narrow_phase.default_speculative_margin,
            cfg.narrow_phase.contact_tolerance * cfg.length_unit)
    lo, hi, pos, quat = ke.collider_aabbs(world.bodies, col, *args)
    order, spans = kcs.buckets(col.shape_type, shapes)
    code, a, b = spans[0]
    cols = order[a:b].contiguous()
    rows = [t.clone() for t in (lo, hi, lo, hi)]
    kcs.custom_aabbs(shapes, code, cols, world.bodies, col, pos, quat, *args, rows[0], rows[1])
    kcs.custom_aabbs_twin(shapes, code, cols, world.bodies, col, pos, quat, *args, rows[2],
                          rows[3])
    err = max(compare("E custom min", rows[0], rows[2]), compare("E custom max", rows[1], rows[3]))
    k_n = cols.shape[0]
    out["custom_aabbs"] = measured(
        err, lambda: kcs.custom_aabbs(shapes, code, cols, world.bodies, col, pos, quat, *args,
                                      rows[0], rows[1]),
        lambda: kcs.custom_aabbs_twin(shapes, code, cols, world.bodies, col, pos, quat, *args,
                                      rows[2], rows[3]), k_n * 108, k_n * (ELLIPSOID_OPS + 60))

    # M's and P's custom instances on the step's buckets.
    w2, pos, quat = bp_m.update_aabbs_and_poses(world, cfg, shapes)
    bp = bp_m.broad_phase(w2, cfg)
    buckets = [bk for bk in manifold_buckets(col.shape_type, col.params, pos, quat,
                                             bp.collider_a.long(), bp.collider_b.long(),
                                             bp.valid, cfg.shape_pairs, w2.convex_verts, shapes)
               if bk.module is kcs]
    if {bk.pair for bk in buckets} != set(CUSTOM_PAIRS):
        raise AssertionError(f"extensions: custom buckets {[bk.pair for bk in buckets]}")
    for name in ("custom_convex_manifold", "custom_hull_manifold"):
        mine = [bk for bk in buckets if bk.name == name]
        err = max(custom_bucket_against_twin(bk) for bk in mine)
        io, ops = (sum(x) for x in zip(*map(custom_pair_work, mine)))
        out[name] = measured(err, lambda: [bk.run() for bk in mine],
                             lambda: [bk.run(twin=True) for bk in mine], io, ops)
        out[name]["pairs"] = sum(bk.slots.shape[0] for bk in mine)

    # O's custom instance on seeded poses.
    inputs = random_plane_poses(device)
    pool = w2.convex_verts
    kind = (shapes, (3, CUSTOM_CODE))
    got = kcs.custom_plane_manifold(kind, *inputs, pool)
    want = kcs._pair_twin(kind, *inputs, pool)
    err = max(compare(f"O custom {i}", g, w) for i, (g, w) in enumerate(zip(got, want)))
    k_n = inputs[0].shape[0]
    out["custom_plane_manifold"] = measured(
        err, lambda: kcs.custom_plane_manifold(kind, *inputs, pool),
        lambda: kcs._pair_twin(kind, *inputs, pool), nbytes(*inputs) + k_n * 148,
        k_n * (OPS_PER_PAIR["plane_patch_manifold"] + 9 * ELLIPSOID_OPS))

    # AJ and AF's custom instance on a subset of the rays and points.
    o, d = query_rays(seed=31)
    rays = torch.cat([o, d], 1).to(device).contiguous()
    sub = rays[:EXT_PLAIN_ROWS].contiguous()
    m = col.capacity
    posc, quatc, prm = pos.contiguous(), quat.contiguous(), col.params.contiguous()

    def aj(fn, work=None):
        t = torch.full((EXT_PLAIN_ROWS, m), kt.BIG, device=device)
        n = torch.zeros((EXT_PLAIN_ROWS, m, 3), device=device)
        extra = () if work is None else (work,)
        return fn(shapes, code, cols, sub, True, posc, quatc, prm, t, n, *extra)

    work = torch.zeros((1,), dtype=torch.int64, device=device)
    got, want = aj(kcs.ray_support, work), aj(kcs.ray_support_twin)
    err = max(compare("AJ t", got[0], want[0]), compare("AJ normal", got[1], want[1]))
    calls = int(work)
    out["ray_support"] = measured(err, lambda: aj(kcs.ray_support), lambda: aj(kcs.ray_support_twin),
                                  nbytes(sub, cols) + EXT_PLAIN_ROWS * k_n * 16 + k_n * 76,
                                  calls * (ELLIPSOID_OPS + AJ_STEP_OPS))
    out["ray_support"]["support_calls"] = calls
    rng = np.random.default_rng(32)
    others = torch.from_numpy(np.stack([rng.uniform(-25, 25, 1024 - EXT_CENTRES),
                                        rng.uniform(0.0, 6.0, 1024 - EXT_CENTRES),
                                        rng.uniform(-25, 25, 1024 - EXT_CENTRES)], 1)
                              .astype(np.float32)).to(device)
    centre_ids = torch.tensor(ellipsoids[:EXT_CENTRES], device=device)

    def query_points(w):
        """1,024 points: the first ``EXT_CENTRES`` ellipsoids' centres in
        ``w``, then seeded points over the field."""
        return torch.cat([w.bodies.pos[centre_ids], others]).contiguous()

    psub = query_points(world)[:EXT_PLAIN_ROWS].contiguous()

    def af(fn):
        dist = torch.full((EXT_PLAIN_ROWS, m), kaf.BIG, device=device)
        cl = torch.zeros((EXT_PLAIN_ROWS, m, 3), device=device)
        ins = torch.zeros((EXT_PLAIN_ROWS, m), dtype=torch.bool, device=device)
        return fn(shapes, code, cols, psub, posc, quatc, prm, dist, cl, ins)

    got, want = af(kcs.custom_point), af(kcs.custom_point_twin)
    err = max(compare(f"AF custom {i}", g, w) for i, (g, w) in enumerate(zip(got, want)))
    pairs = EXT_PLAIN_ROWS * k_n
    out["custom_point"] = measured(err, lambda: af(kcs.custom_point),
                                   lambda: af(kcs.custom_point_twin),
                                   nbytes(psub, cols) + pairs * 17 + k_n * 76,
                                   pairs * kcs.POINT_SUPPORT_CALLS * (ELLIPSOID_OPS + AF_STEP_OPS))
    compare_s = time.perf_counter() - t0

    # The rest of the user's run: 20 more steps, the rays, the picks, the points.
    kernels.reset_launches()
    world, ms20 = ext_steps("custom terrain", world, EXT_CONFIG, EXT_STEPS - EXT_KERNEL_STEPS,
                            seen)
    missing = set(CUSTOM_PAIRS) - seen
    if missing:
        raise AssertionError(f"extensions: custom buckets never launched: {sorted(missing)}")
    above, reach = on_the_field("custom terrain", world, ids)
    o, d = o.to(device), d.to(device)
    picks = picking.pick_batch(world, o, d)
    hits = raycast.first_hits(world, o, vec.normalize_or_rn(d, torch.eye(3, device=device)[0]))
    if not torch.equal(picks.collider, hits.collider):
        raise AssertionError("extensions: pick_batch differs from the first ray hits")
    ell_cols = set(cols.tolist())
    on_ellipsoids = sum(int(c) in ell_cols for c in hits.collider.tolist())
    points = query_points(world)
    dist, _, inside = qpoint.all_point_hits(world, points)
    body_of = world.colliders.body_idx.long()
    owner = torch.full((world.bodies.capacity,), -1, dtype=torch.long, device=device)
    owner[body_of[cols.long()]] = cols.long()
    mine = owner[centre_ids]
    rows_c = torch.arange(EXT_CENTRES, device=device)
    if not bool(inside[rows_c, mine].all()):
        raise AssertionError(f"extensions: {int((~inside[rows_c, mine]).sum())} ellipsoid centres "
                             "outside their ellipsoid")
    projected = project_point(world, points[0])
    if not (bool(projected["is_inside"]) and int(projected["collider"]) == int(mine[0])):
        raise AssertionError(f"extensions: project_point of a centre gave {projected}")
    listed = point_intersections(world, points[0])
    if int(mine[0]) not in listed.tolist():
        raise AssertionError("extensions: point_intersections missed the ellipsoid")
    torch.cuda.synchronize()
    counts = {k: counts[k] + v for k, v in kernels.launches().items()}

    kernels.reset_launches()
    _, line = example_worlds(device)
    counts = {k: counts[k] + v for k, v in kernels.launches().items()}
    zero = [k for k in CUSTOM_KERNELS if not counts[k]]
    if zero:
        raise AssertionError(f"extensions: custom kernels never launched: {zero}")
    phase_hooks_and_joints(device, smi)
    say("extensions", f"custom terrain ({TERRAIN_N} bodies, {len(ellipsoids)} ellipsoids "
        f"{EXT_SEMI}, 24 N, window {TERRAIN_WINDOW}): custom unit built in {build_s:.1f} s; "
        f"{EXT_KERNEL_STEPS} steps at {ms40:.2f} ms, then {EXT_STEPS - EXT_KERNEL_STEPS} at "
        f"{ms20:.2f} ms a step; custom buckets {sorted(seen & set(CUSTOM_PAIRS))}; lowest body "
        f"{above:.4f} m above the field; {on_ellipsoids} of 1,024 rays first hit an ellipsoid, "
        f"pick_batch equal; {EXT_CENTRES} centres inside their ellipsoids; E's custom pass, M, P, "
        f"O, AJ and AF's custom instances against their plain versions in {compare_s:.1f} s "
        f"(AJ {out['ray_support']['support_calls']} support calls for {EXT_PLAIN_ROWS} rays): "
        + show("times", out) + f"; launches {dict((k, counts[k]) for k in CUSTOM_KERNELS)}; {line} [{smi}]")
    return out, counts

# The batched step (phase ``batched``): the reference bench's batched scene
# (``bench.py:128-162``, BASELINE config 5), 4,096 copies of
# ``cube_pile(27)`` at 8 N with gravity jittered per scene.
BATCH_SCENES, BATCH_CUBES = 4096, 27
BATCH_SLOTS = 8 * BATCH_CUBES
BATCH_CONFIG = PhysicsConfig(substeps=4, max_colors=4, sap_window=8, shape_pairs=(
    (int(ShapeType.BOX), int(ShapeType.BOX)), (int(ShapeType.BOX), int(ShapeType.PLANE))))
BATCH_STEPS = 60           # through the sleep onset (the first scenes sleep at step 50)
BATCH_MAX_STEPS = 120      # then on until every scene sleeps (256 on the CPU: the last at 81)
BATCH_AWAKE = (5, 45)      # steps timed as awake steps, [from, to)
BATCH_KERNEL_STEP = 20     # E, B, L and K held to their plain versions on this step's world
BATCH_ALONE = 16           # seeded scenes stepped alone through physics_step
BATCH_PLAIN_SCENES, BATCH_PLAIN_STEPS = 64, 20
BATCH_SYNC_STEP = 10       # the step whose host reads are counted
BATCH_BELOW_TOL = 0.05     # a cube's centre no lower than half its side less this
BATCH_KERNELS = ("collider_aabbs", "grid_sweep", "compact_pairs", "body_pass")


def batched_piles(device, scenes_n):
    """``(batched world, gravity jitter f32[scenes_n])``: the bench's batched
    scene, its jitter 1 + 0.1 N(0, 1) from a seeded generator."""
    world, _ = scenes.cube_pile(BATCH_CUBES, max_contacts=BATCH_SLOTS, device=device)
    gen = torch.Generator().manual_seed(0)
    jitter = (1.0 + 0.1 * torch.randn(BATCH_SCENES, generator=gen))[:scenes_n].to(device)
    batched = replicate_world(world, scenes_n)
    return batched.replace(gravity=batched.gravity * jitter[:, None]), jitter


def scene_of(batched, i):
    """Scene ``i`` of a batched world as a world of its own."""
    def group(g):
        return g.replace(**{k: v[i].clone() for k, v in vars(g).items()})

    return batched.replace(
        bodies=group(batched.bodies), colliders=group(batched.colliders),
        contacts=group(batched.contacts), joints=group(batched.joints),
        gravity=batched.gravity[i].clone(), time=batched.time[i].clone(),
        diverged=batched.diverged[i].clone(), convex_verts=batched.convex_verts[i].clone())


def batched_kernels(batched, config):
    """E, B, L and K at the batched shapes: each against its plain version on
    the flat world of ``batched`` (every scene's pairs inside the scene);
    {name: measurements}."""
    out = {}
    flat = flatten(batched)
    b = flat.bodies
    m_s = batched.colliders.capacity
    dt, spec = config.dt, config.narrow_phase.default_speculative_margin
    tol = config.narrow_phase.contact_tolerance * config.length_unit

    # E: poses and AABBs, then the scene keys with each scene's cell size.
    e_in = (b, flat.colliders, dt, spec, tol)
    got = ke.collider_aabbs(*e_in)
    err_e = 0.0
    for name, x, y in zip(("aabb_min", "aabb_max", "pos", "quat"), got,
                          ke.collider_aabbs_twin(*e_in)):
        err_e = max(err_e, compare(f"batched collider_aabbs {name}", x, y, TOL_E))
    w2 = bp_m.update_aabbs(flat, config)
    col2 = w2.colliders
    cell, in_sweep, _ = bp_m.sweep_cell(col2, BATCH_SCENES)
    k_in = (b, col2, cell, in_sweep)
    got_k = ke.cell_keys(*k_in)
    want_k = ke.cell_keys_twin(*k_in)
    compare("batched cell_keys ckey", got_k[0], want_k[0])
    err_e = max(err_e, compare("batched cell_keys fpack", got_k[1], want_k[1], TOL_E))
    compare("batched cell_keys ipack", got_k[2], want_k[2])
    scene = got_k[0] >> 31
    if not torch.equal(scene, torch.arange(col2.capacity, device=scene.device).repeat_interleave(8)
                       // m_s):
        raise AssertionError("batched cell_keys: a key carries another collider's scene")

    def run_e(f_aabb, f_keys):
        f_aabb(*e_in)
        f_keys(*k_in)

    out["collider_aabbs"] = measured(
        err_e, lambda: run_e(ke.collider_aabbs, ke.cell_keys),
        lambda: run_e(ke.collider_aabbs_twin, ke.cell_keys_twin),
        nbytes(col2.body_idx, col2.shape_type, col2.params, col2.local_pos, col2.local_quat,
               col2.speculative_margin, col2.collision_margin, b.pos, b.quat, b.lin_vel, *got)
        + nbytes(cell, in_sweep, col2.layer_members, col2.layer_filter, b.body_type, b.active,
                 *got_k),
        180 * col2.capacity,
    )

    # B: the sweep over the scene-sorted keys.
    g = bp_m.grid_entries(w2, config)
    args = (g.skey, g.sf, g.si, g.window)
    bk, rk = kb.grid_sweep(*args)
    bt, rt = kb.grid_sweep_twin(*args)
    compare("batched grid_sweep bits", bk, bt)
    compare("batched grid_sweep rank", rk, rt)
    out["grid_sweep"] = measured(
        0.0, lambda: kb.grid_sweep(*args), lambda: kb.grid_sweep_twin(*args),
        nbytes(g.skey, g.sf, g.si, bk, rk),
        16 * sweep_tests(g.skey, g.window) + 4 * g.skey.numel(),
    )

    # L: each scene's globals, slots, counts and drops.
    l_in = bp_m.compaction_args(w2, g, bk, rk)
    pairs = kl.compact_pairs(*l_in)
    for name, x, y in zip(kl.Pairs._fields, pairs, kl.compact_pairs_twin(*l_in)):
        compare(f"batched compact_pairs {name}", x, y)
    valid = pairs.valid
    if not torch.equal((pairs.collider_a // m_s)[valid], (pairs.collider_b // m_s)[valid]):
        raise AssertionError("batched compact_pairs: a pair joins two scenes")
    c_s, g_cap, j_keys = l_in[11], l_in[6].shape[-1], l_in[9]
    out["compact_pairs"] = measured(
        0.0, lambda: kl.compact_pairs(*l_in), lambda: kl.compact_pairs_twin(*l_in),
        nbytes(bk, rk, g.skey, l_in[3], *l_in[5], l_in[6], l_in[7], l_in[8], j_keys, *pairs),
        bk.numel() + 20 * g_cap * col2.capacity
        + BATCH_SCENES * c_s * (4 + 2 * math.ceil(math.log2(j_keys.numel() + 1))),
    )

    # K: prepare with each scene's gravity, and writeback.
    h = config.substep_dt
    p_in = (b, flat.gravity, h)
    got_p = kk.prepare_bodies(*p_in)
    err_k = 0.0
    for name, x, y in zip(("state", "inv_mass", "inv_inertia", "solve_mask", "table"), got_p,
                          kk.prepare_bodies_twin(*p_in)):
        err_k = max(err_k, compare(f"batched prepare_bodies {name}", x, y))
    moved_state = kc.integrate_bodies(
        kc.integrate_bodies(got_p[0], got_p[4], h, kc.VELOCITIES), got_p[4], h, kc.POSITIONS)
    wb_out = kk.writeback_bodies(b, moved_state)
    for name, x, y in zip(("pos", "quat", "lin_vel", "ang_vel", "force", "torque"), wb_out,
                          kk.writeback_bodies_twin(b, moved_state)):
        err_k = max(err_k, compare(f"batched writeback_bodies {name}", x, y))

    def run_k(f_prep, f_wb):
        f_prep(*p_in)
        f_wb(b, moved_state)

    out["body_pass"] = measured(
        err_k, lambda: run_k(kk.prepare_bodies, kk.writeback_bodies),
        lambda: run_k(kk.prepare_bodies_twin, kk.writeback_bodies_twin),
        nbytes(b.body_type, b.locked_axes, b.active, b.sleeping, b.gyroscopic, b.quat,
               b.inv_inertia, b.lin_vel, b.ang_vel, b.force, b.torque, b.const_force,
               b.const_local_force, b.const_torque, b.const_local_torque, b.const_lin_acc,
               b.const_local_lin_acc, b.const_ang_acc, b.const_local_ang_acc, b.inv_mass,
               b.gravity_scale, b.lin_damping, b.ang_damping, b.max_lin_speed, b.max_ang_speed,
               flat.gravity, *got_p)
        + nbytes(moved_state, b.pos, b.quat, b.com, b.lin_vel, b.ang_vel, b.active, b.sleeping,
                 b.body_type, *wb_out),
        330 * b.capacity,
    )
    return out, f"{int(valid.sum())} pairs in {BATCH_SCENES} scenes, cell sizes " \
        f"{float(cell.min()):.4f}-{float(cell.max()):.4f} m"


def phase_batched(device, smi):
    """The batched step at full width: ``BATCH_SCENES`` x ``cube_pile(27)``
    (114,688 bodies and colliders, 884,736 contact slots) through
    ``make_batched_step`` for ``BATCH_STEPS`` steps and on until every scene
    sleeps (at most ``BATCH_MAX_STEPS``), the launches counted over them.
    Fails on a dropped pair or overflow drop in any scene (running maxima), a
    non-finite state, a cube below the plane, a scene awake at the last step,
    a kernel of the path never launched, or a batched step with more host
    reads than a single-world step (PyTorch's sync debug mode, step
    ``BATCH_SYNC_STEP``). Then: E, B, L and K against their plain versions
    on step ``BATCH_KERNEL_STEP``'s flat world; ``BATCH_ALONE`` seeded scenes
    stepped alone through ``physics_step``, bit for bit the batched scenes at
    every step (no kernel reduces across scenes, and every kernel is
    deterministic); the first ``BATCH_PLAIN_SCENES`` scenes rerun on the plain
    versions for ``BATCH_PLAIN_STEPS`` steps, within ``PLAIN_TOL`` of the
    kernels. Returns (measured rows, launches)."""
    t_phase = time.perf_counter()
    config = BATCH_CONFIG
    batched, jitter = batched_piles(device, BATCH_SCENES)
    start = batched
    step = make_batched_step(config)
    gen = torch.Generator().manual_seed(1)
    alone_ids = torch.randperm(BATCH_SCENES, generator=gen)[:BATCH_ALONE].tolist()
    alone_idx = torch.tensor(alone_ids, device=device)
    plain_n = BATCH_PLAIN_SCENES
    worst_drop = torch.zeros((BATCH_SCENES,), dtype=torch.int32, device=device)
    alone_pos, alone_stepped, plain_ref, seconds, stepped_n = [], [], [], [], []
    expect = dict.fromkeys(kernels.WRAPPERS, 0)
    low = float("inf")
    syncs_batched = at_kernel_step = None
    torch.cuda.synchronize()
    kernels.reset_launches()
    awake_at = []
    for i in range(BATCH_MAX_STEPS):
        if i >= BATCH_STEPS and awake_at[-1] == 0:
            break
        if i + 1 == BATCH_SYNC_STEP:
            (batched, diag), syncs_batched = counting_syncs(
                lambda: step(batched, return_diagnostics=True))
            dt_s = None
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batched, diag = step(batched, return_diagnostics=True)
            torch.cuda.synchronize()
            dt_s = time.perf_counter() - t0
        if BATCH_AWAKE[0] <= i < BATCH_AWAKE[1] and dt_s is not None:
            seconds.append(dt_s)
        worst_drop = torch.maximum(worst_drop, torch.maximum(diag["dropped_pairs"],
                                                             diag["overflow_dropped"]))
        stepped_n.append(int(diag["stepped"].sum()))
        alone_pos.append(batched.bodies.pos[alone_idx].clone())
        alone_stepped.append(diag["stepped"][alone_idx].clone())
        if i < BATCH_PLAIN_STEPS:
            plain_ref.append(batched.bodies.pos[:plain_n].clone())
        low = min(low, float(batched.bodies.pos[:, 1:, 1].min()))
        if bool(diag["stepped"].any()):
            for pair, n in diag["manifold_pairs"].items():
                expect[PAIR_KERNELS[pair][1]] += int(n > 0)
            for name, per_step in STEP_LAUNCHES.items():
                expect[name] += per_step(config, False)
        if i + 1 == BATCH_KERNEL_STEP:
            at_kernel_step = batched
        awake_at.append(int((diag["num_sleeping"] != BATCH_CUBES).sum()))
    steps_run = len(awake_at)
    launches = kernels.launches()
    kernels_out, note = batched_kernels(at_kernel_step, config)
    del at_kernel_step
    b = batched.bodies
    for name in ("pos", "quat", "lin_vel", "ang_vel"):
        if not bool(torch.isfinite(getattr(b, name)).all()):
            raise AssertionError(f"batched: non-finite {name}")
    if bool(batched.diverged.any()):
        raise AssertionError("batched: a scene diverged")
    if int(worst_drop.max()) != 0:
        raise AssertionError(f"batched: {int((worst_drop > 0).sum())} scenes dropped pairs or "
                             f"overflow rows (most {int(worst_drop.max())})")
    if low < 0.5 - BATCH_BELOW_TOL:
        raise AssertionError(f"batched: a cube's centre at {low} m, below the plane")
    if awake_at[-1]:
        raise AssertionError(f"batched: {awake_at[-1]} scenes awake after {steps_run} steps")
    if launches != expect:
        raise AssertionError(f"batched: launches {launches} != expected {expect}")
    if any(launches[name] == 0 for name in BATCH_KERNELS):
        raise AssertionError(f"batched: a kernel of the path never launched: {launches}")
    first_asleep = [next((i for i in range(steps_run) if not bool(alone_stepped[i][k])),
                         steps_run) for k in range(BATCH_ALONE)]

    # The seeded scenes alone, bit for bit.
    t0 = time.perf_counter()
    syncs_alone = None
    for k, sid in enumerate(alone_ids):
        world = scene_of(start, sid)
        for i in range(steps_run):
            if k == 0 and i + 1 == BATCH_SYNC_STEP:
                (world, d), syncs_alone = counting_syncs(
                    lambda: physics_step(world, config, return_diagnostics=True))
            else:
                world, d = physics_step(world, config, return_diagnostics=True)
            if not (torch.equal(world.bodies.pos, alone_pos[i][k])
                    and bool(d["stepped"]) == bool(alone_stepped[i][k])):
                gap = float((world.bodies.pos - alone_pos[i][k]).abs().max())
                raise AssertionError(f"batched: scene {sid} alone parts from its batched copy at "
                                     f"step {i + 1} by {gap} m")
        for group in ("bodies", "contacts", "joints"):
            for name, x in vars(getattr(world, group)).items():
                if not torch.equal(x, getattr(getattr(batched, group), name)[sid]):
                    raise AssertionError(f"batched: scene {sid} alone differs in {group}.{name}")
    alone_s = time.perf_counter() - t0
    if len(syncs_batched) > len(syncs_alone):
        raise AssertionError(f"batched: {len(syncs_batched)} host reads a step ({syncs_batched}) "
                             f"against {len(syncs_alone)} alone ({syncs_alone})")

    # The first scenes on the plain versions.
    small, _ = batched_piles(device, plain_n)
    frames = []
    kernels.reset_launches()
    t0 = time.perf_counter()
    with plain_versions():
        for _ in range(BATCH_PLAIN_STEPS):
            small = step(small)
            frames.append(small.bodies.pos.clone())
    plain_s = time.perf_counter() - t0
    if any(kernels.launches().values()):
        raise AssertionError(f"batched plain path: kernels were launched: {kernels.launches()}")
    # The plain versions on the card sum Kernel D's deltas with atomics
    # (``index_add_``), in another order than the kernel, and the landing
    # piles amplify that: held as the other plain paths are, every cube
    # within PLAIN_TOL over the first PLAIN_TIGHT_STEPS steps and within
    # PLAIN_APEX_TOL over all.
    gaps = [float((x - y).abs().max()) for x, y in zip(frames, plain_ref)]
    plain_gap, tight_gap = max(gaps), max(gaps[:PLAIN_TIGHT_STEPS])
    if not (tight_gap <= PLAIN_TOL and plain_gap <= PLAIN_APEX_TOL):
        raise AssertionError(f"batched plain path: {tight_gap} m from the kernels' trajectory "
                             f"in {PLAIN_TIGHT_STEPS} steps (limit {PLAIN_TOL}), {plain_gap} m in "
                             f"{BATCH_PLAIN_STEPS} (limit {PLAIN_APEX_TOL}); by step: {gaps}")

    awake_ms = 1e3 * sum(seconds) / len(seconds)
    envs = BATCH_SCENES * 1e3 / awake_ms
    say("batched", f"{BATCH_SCENES} x cube_pile({BATCH_CUBES}) = {b.capacity * BATCH_SCENES} "
        f"bodies, {batched.contacts.capacity * BATCH_SCENES} contact slots, {steps_run} steps: "
        f"awake step (steps {BATCH_AWAKE[0] + 1}-{BATCH_AWAKE[1]}, {len(seconds)} timed) "
        f"{awake_ms:.3f} ms (median {1e3 * sorted(seconds)[len(seconds) // 2]:.3f}), "
        f"{envs:.0f} env-steps/s, {envs * BATCH_CUBES:.0f} body-steps/s; scenes stepping at "
        f"steps 45-{steps_run}: {stepped_n[44:]}; awake at step {BATCH_STEPS}: "
        f"{awake_at[BATCH_STEPS - 1]}, every scene asleep after step {steps_run}, the seeded "
        f"ones asleep from step {sorted(first_asleep)}; gravity x {float(jitter.min()):.3f}-"
        f"{float(jitter.max()):.3f}; dropped 0 and overflow drops 0 in every scene, lowest "
        f"centre {low:.4f} m; host reads at step {BATCH_SYNC_STEP}: {len(syncs_batched)} "
        f"batched {syncs_batched}, {len(syncs_alone)} alone {syncs_alone}; {BATCH_ALONE} "
        f"scenes alone bit for bit through {steps_run} steps ({alone_s:.1f} s); {plain_n} "
        f"scenes on the plain versions {BATCH_PLAIN_STEPS} steps ({plain_s:.1f} s), largest "
        f"gap to the kernels by step: "
        + ", ".join(f"{g:.2g}" for g in gaps) + " m; "
        f"E, B, L, K at step {BATCH_KERNEL_STEP}: {note}; "
        + show("times", kernels_out)
        + f"; launches {dict((k, launches[k]) for k in BATCH_KERNELS)}; "
        f"phase {time.perf_counter() - t_phase:.1f} s [{smi}]")
    return kernels_out, launches


def main():
    smi = phase_device()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    timed("build", phase_build)
    measured_by_kernel = timed("kernels", phase_kernels, device)
    timed("golden", phase_golden, device)
    main_launches = timed("main", phase_main_path, device, smi)
    pyramid_launches = timed("pyramid", phase_pyramid, device, smi)
    hinge_launches = timed("hinges", phase_hinges, device, smi)
    shapes_launches = timed("shapes", phase_shapes, device, smi)
    timed("cylinder stack", phase_cylinder_stack, device)
    terrain_launches = timed("terrain", phase_terrain, device, smi)
    scene_launches = timed("scenes", phase_reference_scenes, device)
    measured_ccd, ccd_launches = timed("ccd", phase_ccd, device, smi)
    measured_by_kernel.update(measured_ccd)
    timed("ccd scenes", phase_ccd_reference, device)
    measured_queries, query_launches, query_world = timed("queries", phase_queries, device, smi)
    measured_by_kernel.update(measured_queries)
    measured_grid, grid_launches = timed("grid queries", phase_grid_queries, device, smi,
                                         query_world)
    measured_by_kernel.update(measured_grid)
    measured_tools, tools_launches = timed("tools3d", phase_tools3d, device, smi, query_world)
    measured_by_kernel.update(measured_tools)
    del query_world
    measured_ext, ext_launches = timed("extensions", phase_extensions, device, smi)
    measured_by_kernel.update(measured_ext)
    measured_batched, batched_launches = timed("batched", phase_batched, device, smi)
    measured_by_kernel.update(timed("dim2 kernels", phase_dim2_kernels, device))
    timed("dim2 golden", phase_dim2_golden, device)
    dim2_launches = timed("pyramid2d", phase_pyramid2d, device, smi)
    timed("dim2 plain path", phase_dim2_plain_path, device)
    measured_by_kernel.update(timed("dim2 joints kernels", phase_dim2_joints_kernels, device))
    hinges2d_launches = timed("hinges2d", phase_hinges2d, device, smi)
    timed("hinges2d plain path", phase_hinges2d_plain_path, device)
    measured_ccd2d, ccd2d_launches = timed("ccd2d", phase_ccd2d, device, smi)
    measured_by_kernel.update(measured_ccd2d)
    timed("dim2 examples", phase_dim2_examples, device)
    measured_q2d, q2d_launches = timed("dim2 queries", phase_dim2_queries, device, smi)
    measured_by_kernel.update(measured_q2d)
    controller_launches = timed("controller2d", phase_controller_2d, device, smi)
    timed("dim2 showcase", phase_dim2_showcase, device)
    timed("dim2 determinism", phase_dim2_determinism, device)
    timed("plain path", phase_plain_path, device)
    timed("hinges plain path", phase_hinges_plain_path, device)
    timed("shapes plain path", phase_shapes_plain_path, device)
    timed("terrain plain path", phase_terrain_plain_path, device)
    timed("ccd plain path", phase_ccd_plain_path, device)
    timed("determinism", phase_determinism, device)
    say("time", ", ".join(f"{k} {v} s" for k, v in seconds.items())
        + f"; {round(sum(seconds.values()), 1)} s in all")
    rows = []
    for name, (route, source, replaces) in REPLACES.items():
        # ``launches``: the path that exercises the kernel most (the terrain
        # for P, the reference scenes for Q, the mixed shapes for M, N, O,
        # the swept-CCD terrain for R, the queries for S and T, the 2D
        # pyramid for U-Z, the 2D hinged boxes for AA, the 2D swept bullets
        # for AB, the 2D queries for AC, AD and AE, the 3D tools for AI and S's
        # manifold mode; the hinged boxes for the
        # others).
        main = {"hull_manifold": terrain_launches, "plane_hull_manifold": scene_launches,
                "swept_toi": ccd_launches, "shape_cast": query_launches,
                "ray_cast": query_launches, **dict.fromkeys(DIM2_KERNELS, dim2_launches),
                "solve_joints_2d": hinges2d_launches, "swept_toi_2d": ccd2d_launches,
                **dict.fromkeys(Q2D_KERNELS, q2d_launches),
                **dict.fromkeys(GRID_KERNELS, grid_launches),
                **dict.fromkeys(TOOLS_KERNELS, tools_launches),
                **dict.fromkeys(CUSTOM_KERNELS, ext_launches)}.get(
            name, shapes_launches if name in OPS_PER_PAIR else hinge_launches)
        rows.append(dict(name=name, route=route, source=source, replaces=replaces,
                         launches=main[name], pile_launches=main_launches[name],
                         pyramid_launches=pyramid_launches[name],
                         hinge_launches=hinge_launches[name],
                         shapes_launches=shapes_launches[name],
                         terrain_launches=terrain_launches[name],
                         scene_launches=scene_launches[name],
                         ccd_launches=ccd_launches[name], query_launches=query_launches[name],
                         grid_query_launches=grid_launches[name],
                         tools3d_launches=tools_launches[name],
                         pyramid2d_launches=dim2_launches[name],
                         hinges2d_launches=hinges2d_launches[name],
                         ccd2d_launches=ccd2d_launches[name],
                         queries2d_launches=q2d_launches[name],
                         controller2d_launches=controller_launches[name],
                         extension_launches=ext_launches[name],
                         batched_launches=batched_launches[name],
                         **measured_by_kernel[name]))
    # E, B, L and K again at the batched step's shapes (4,096 scenes), with
    # the launches of its run.
    for name in BATCH_KERNELS:
        route, source, replaces = REPLACES[name]
        rows.append(dict(name=f"{name} (batched {BATCH_SCENES} x {BATCH_CUBES})", route=route,
                         source=source, replaces=replaces, launches=batched_launches[name],
                         batched_launches=batched_launches[name], **measured_batched[name]))
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
