"""Hand-written Hopper kernels of the port, each with its plain PyTorch twin:

- ``box_manifold`` (Kernel A, CUDA): box/box and box/plane manifolds;
- ``grid_sweep`` (Kernel B, CUDA): the broadphase's same-cell window sweep;
- ``integrate_bodies`` (Kernel C, Triton): substep integration;
- ``solve_color`` (Kernel D, CUDA): one color of the contact solver;
- ``collider_aabbs`` (Kernel E, CUDA): collider poses, AABBs and cell keys;
- ``contact_rows`` (Kernel F, CUDA): contact persistence and warm-start carry;
- ``color_edges`` (Kernel G, CUDA): edge coloring, bucketing and the run rank;
- ``pack_constraints`` (Kernel H, CUDA): the packed constraint rows;
- ``solve_joints`` (Kernel I, CUDA): the joint rows of a step and the XPBD
  joint solver of a substep;
- ``islands`` (Kernel J, CUDA): island labels and the sleep update;
- ``body_pass`` (Kernel K, CUDA): solver-body prepare and writeback;
- ``compact_pairs`` (Kernel L, CUDA): broadphase compaction, global pass,
  joint probe and pair keys;
- ``convex_manifold`` (Kernel M, CUDA): manifolds of the support-mapped
  pairs (cylinders, cones, segments, capsule/box);
- ``round_manifold`` (Kernel N, CUDA): the analytic sphere and capsule pairs;
- ``plane_patch_manifold`` (Kernel O, CUDA): cylinder, cone or segment on a
  half-space;
- ``hull_manifold`` (Kernel P, CUDA): manifolds of a pool-backed convex shape
  (hull, round cuboid, triangle) against any shape but a half-space;
- ``plane_hull_manifold`` (Kernel Q, CUDA): a pool-backed convex shape on a
  half-space;
- ``swept_toi`` (Kernel R, CUDA): swept-CCD times of impact;
- ``shape_cast`` (Kernel S, CUDA): shape casts;
- ``ray_cast`` (Kernel T, CUDA): ray casts;
- ``grid_pairs_2d`` (Kernel U, CUDA): the 2D engine's grid sweep and global
  test (its compaction is Kernel L's);
- ``manifold_2d`` (Kernel V, CUDA): the 2D rounded-polygon manifolds;
- ``contact_rows_2d`` (Kernel W, CUDA): 2D contact persistence;
- ``pack_2d`` (Kernel X, CUDA): the 2D packed constraint rows;
- ``solve_2d`` (Kernel Y, CUDA): one colour of the 2D contact solver;
- ``integrate_2d`` (Kernel Z, CUDA): 2D substep integration;
- ``prepare_2d`` (Kernel Z's prologue, CUDA): the 2D solver bodies and
  Z's table;
- ``writeback_2d`` (Kernel K's 2D pass, CUDA): the 2D writeback and force
  clear;
- ``sleep_update_2d`` (Kernel J's 2D pass, CUDA): the 2D sleep update;
- ``solve_joints_2d`` (Kernel AA, CUDA): the 2D joint rows of a step and the
  2D XPBD joint solver of a substep;
- ``swept_toi_2d`` (Kernel AB, CUDA): the 2D swept-CCD times of impact;
- ``ray_cast_2d`` (Kernel AC, CUDA): the 2D ray casts;
- ``point_2d`` (Kernel AD, CUDA): the 2D point projections;
- ``shape_cast_2d`` (Kernel AE, CUDA): the 2D shape casts and query
  manifolds;
- ``point_3d`` (Kernel AF, CUDA): point projections;
- ``ray_cast_grid`` (Kernel AG, CUDA): grid-accelerated ray casts;
- ``aabb_overlap`` (Kernel AH, CUDA): AABB intersections;
- ``shape_overlap`` (Kernel S's overlap mode, CUDA): shape intersections;
- ``shape_manifold`` (Kernel S's manifold mode, CUDA): the query shape's
  manifolds, which the character's depenetration reads;
- ``toi_pair`` (Kernel AI, CUDA): times of impact of pairs of shapes.

``build`` compiles ``csrc/*.cu`` at first use. A kernel may have several
entry wrappers (one per launch kind); each adds one to its ``launches``
where it launches, and nowhere else. ``launches()`` sums them per kernel
and ``reset_launches`` zeroes them all.
"""

from avian_tpu_torch.kernels import box_manifold as _a
from avian_tpu_torch.kernels import grid_sweep as _b
from avian_tpu_torch.kernels import integrate_bodies as _c
from avian_tpu_torch.kernels import solve_color as _d
from avian_tpu_torch.kernels import collider_aabbs as _e
from avian_tpu_torch.kernels import contact_rows as _f
from avian_tpu_torch.kernels import color_edges as _g
from avian_tpu_torch.kernels import pack_constraints as _h
from avian_tpu_torch.kernels import run_rank as _r
from avian_tpu_torch.kernels import solve_joints as _i
from avian_tpu_torch.kernels import islands as _j
from avian_tpu_torch.kernels import body_pass as _k
from avian_tpu_torch.kernels import compact_pairs as _l
from avian_tpu_torch.kernels import convex_manifold as _mo
from avian_tpu_torch.kernels import round_manifold as _n
from avian_tpu_torch.kernels import hull_manifold as _pq
from avian_tpu_torch.kernels import swept_toi as _rr
from avian_tpu_torch.kernels import shape_cast as _s
from avian_tpu_torch.kernels import ray_cast as _t
from avian_tpu_torch.kernels import grid_pairs_2d as _u
from avian_tpu_torch.kernels import manifold_2d as _v
from avian_tpu_torch.kernels import contact_rows_2d as _w
from avian_tpu_torch.kernels import pack_2d as _x
from avian_tpu_torch.kernels import solve_2d as _y
from avian_tpu_torch.kernels import integrate_2d as _z
from avian_tpu_torch.kernels import solve_joints_2d as _aa
from avian_tpu_torch.kernels import swept_toi_2d as _ab
from avian_tpu_torch.kernels import ray_cast_2d as _ac
from avian_tpu_torch.kernels import point_2d as _ad
from avian_tpu_torch.kernels import shape_cast_2d as _ae
from avian_tpu_torch.kernels import point_3d as _af
from avian_tpu_torch.kernels import ray_cast_grid as _ag
from avian_tpu_torch.kernels import aabb_overlap as _ah
from avian_tpu_torch.kernels import toi_pair as _ai

WRAPPERS = {
    "box_manifold": (_a.box_manifold,),
    "grid_sweep": (_b.grid_sweep,),
    "integrate_bodies": (_c.integrate_bodies,),
    "solve_color": (_d.solve_color,),
    "collider_aabbs": (_e.collider_aabbs, _e.cell_keys),
    "contact_rows": (_f.contact_join, _f.contact_rows),
    "color_edges": (_g.color_edges, _g.bucket_edges, _r.run_rank),
    "pack_constraints": (_h.constraint_flags, _h.pack_constraints),
    "solve_joints": (_i.joint_rows, _i.joint_color, _i.joint_velocities),
    "islands": (_j.island_table, _j.island_labels, _j.sleep_update),
    "body_pass": (_k.prepare_bodies, _k.writeback_bodies),
    "compact_pairs": (_l.compact_pairs,),
    "convex_manifold": (_mo.convex_manifold,),
    "round_manifold": (_n.round_manifold,),
    "plane_patch_manifold": (_mo.plane_patch_manifold,),
    "hull_manifold": (_pq.hull_manifold,),
    "plane_hull_manifold": (_pq.plane_hull_manifold,),
    "swept_toi": (_rr.swept_toi,),
    "shape_cast": (_s.shape_cast,),
    "ray_cast": (_t.ray_cast,),
    "grid_pairs_2d": (_u.grid_counts_2d,),
    "manifold_2d": (_v.manifold_2d,),
    "contact_rows_2d": (_w.contact_rows_2d,),
    "pack_2d": (_x.pack_2d,),
    "solve_2d": (_y.solve_2d,),
    "integrate_2d": (_z.integrate_2d,),
    "prepare_2d": (_z.prepare_2d,),
    "writeback_2d": (_k.writeback_2d,),
    "sleep_update_2d": (_j.sleep_update_2d,),
    "solve_joints_2d": (_aa.joint_rows_2d, _aa.joint_color_2d, _aa.joint_velocities_2d),
    "swept_toi_2d": (_ab.swept_toi_2d,),
    "ray_cast_2d": (_ac.ray_cast_2d,),
    "point_2d": (_ad.point_2d,),
    "shape_cast_2d": (_ae.shape_cast_2d,),
    "point_3d": (_af.point_3d,),
    "ray_cast_grid": (_ag.ray_cast_grid,),
    "aabb_overlap": (_ah.aabb_overlap,),
    "shape_overlap": (_s.shape_overlap,),
    "shape_manifold": (_s.shape_manifold,),
    "toi_pair": (_ai.toi_pair,),
}


def reset_launches() -> None:
    for fns in WRAPPERS.values():
        for fn in fns:
            fn.launches = 0


def launches() -> dict:
    return {name: sum(fn.launches for fn in fns) for name, fns in WRAPPERS.items()}
