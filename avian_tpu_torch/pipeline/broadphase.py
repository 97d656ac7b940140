"""Broadphase: uniform-grid cell list into a fixed-capacity pair buffer
(port of ``avian_tpu/pipeline/broadphase.py``).

The algorithm and its outputs are the reference's: cell size = largest
in-grid AABB extent, up to 8 cell entries per collider, a stable sort of
the packed cell keys, a same-cell window sweep with canonical-cell
deduplication (Kernel B, ``kernels/grid_sweep.py``), compaction in
(entry, window position) order, then a dense pass against at most 16
"global" colliders (half-spaces and colliders > 4x the median extent), and
the pairs of two bodies joined by a ``collision_disabled`` joint dropped.
Slots, pair keys and ``dropped`` match the reference exactly. The flat
world of B scenes that ``parallel.make_batched_step`` steps
(``World.scene_count``) gets what ``jax.vmap`` gives each scene: its own
cell size, median extent, globals, slots (``C / B`` each), ``num_pairs``
and ``dropped`` (i32[B]), and no pair across two scenes. Poses, AABBs
and key emission are Kernel E (``kernels/collider_aabbs.py``); the sorts are
``torch.sort`` (the reference calls ``lax.sort`` there); compaction, the
global pass, the joint probe and the keys are Kernel L
(``kernels/compact_pairs.py``), with no read to the host.
"""

from dataclasses import dataclass

import torch

from avian_tpu_torch.core.config import PhysicsConfig
from avian_tpu_torch.core.state import World
from avian_tpu_torch.geometry import shapes
from avian_tpu_torch.kernels import collider_aabbs as ke
from avian_tpu_torch.kernels import compact_pairs as kl
from avian_tpu_torch.kernels import custom_shapes as kcs
from avian_tpu_torch.kernels import grid_sweep as kb

MAX_GLOBALS = 16


@dataclass(frozen=True)
class BroadPhaseResult:
    """Candidate collider pairs, compacted into C slots."""

    collider_a: torch.Tensor  # i32[C]
    collider_b: torch.Tensor  # i32[C]
    pair_key: torch.Tensor    # i64[C]; -1 for empty slots
    valid: torch.Tensor       # bool[C]
    num_pairs: torch.Tensor   # i32[] (i32[B] for B scenes: ``World.time``'s shape)
    dropped: torch.Tensor     # i32[] candidates that fit in no slot (i32[B])


@dataclass(frozen=True)
class GridEntries:
    """The cell-sorted grid table Kernel B sweeps."""

    skey: torch.Tensor  # i64[8M] sorted scene and cell keys (Kernel E)
    scol: torch.Tensor  # i64[8M] collider of each sorted entry
    sf: torch.Tensor    # f32[8M, 6]
    si: torch.Tensor    # i32[8M, 7]
    window: int
    is_global: torch.Tensor  # bool[M]
    dyn: torch.Tensor        # bool[M]


def update_aabbs_and_poses(world: World, config: PhysicsConfig, custom_shapes=()):
    """``(world with this step's AABBs, collider pos f32[M,3], quat f32[M,4])``:
    world pose of each collider = body pose o local offset, and its AABB
    expanded for speculative contacts (reference :85, :96). One launch of
    Kernel E, then one of its custom pass for each of ``custom_shapes``
    that has colliders, which writes their AABBs over E's rows."""
    col = world.colliders
    args = (config.dt, config.narrow_phase.default_speculative_margin,
            config.narrow_phase.contact_tolerance * config.length_unit)
    lo, hi, pos, quat = ke.collider_aabbs(world.bodies, col, *args)
    if custom_shapes:
        order, spans = kcs.buckets(col.shape_type, custom_shapes)
        for code, start, end in spans:
            kcs.custom_aabbs(custom_shapes, code, order[start:end].contiguous(), world.bodies,
                             col, pos, quat, *args, lo, hi)
    return world.replace(colliders=col.replace(aabb_min=lo, aabb_max=hi)), pos, quat


def collider_poses(world: World):
    """``(pos f32[M,3], quat f32[M,4])``: each collider's world pose (reference
    ``update_collider_poses`` :85), from Kernel E's pose path; the AABBs it
    computes beside them are dropped."""
    return update_aabbs_and_poses(world, PhysicsConfig())[1:]


def update_aabbs(world: World, config: PhysicsConfig, custom_shapes=()) -> World:
    """World AABBs, expanded for speculative contacts (reference :96)."""
    return update_aabbs_and_poses(world, config, custom_shapes)[0]


def sweep_window(config: PhysicsConfig, m: int) -> int:
    """The window of Kernel B's sweep. Up to 32 it is the reference's; the
    port also takes 33..64 (one 64-bit candidate mask per grid entry), which
    the reference refuses (ROADMAP 3b: the window cliff)."""
    w = min(config.sap_window, max(8 * m - 1, 1))
    if w > kb.MAX_WINDOW:
        raise ValueError(
            f"sap_window={config.sap_window} > {kb.MAX_WINDOW}: the candidate bitmask is "
            "one u64 per grid entry"
        )
    return w


def sweep_cell(col, scenes=1):
    """``(cell f32[B], in_sweep bool[M], is_global bool[M])`` of the colliders
    of ``scenes`` B scenes of M / B (B = 1 for a world): each scene's grid
    cell size (1.001 x its largest in-sweep AABB extent, on the device) and
    which colliders go through the grid; half-spaces and colliders > 4x
    their scene's median extent are "global" (reference :217-243)."""
    m = col.capacity // scenes
    ext_axis = (col.aabb_max - col.aabb_min).reshape(scenes, m, 3)
    ext_c = ext_axis.amax(dim=-1)
    active = col.active.reshape(scenes, m)
    is_plane = ext_c > shapes.BIG
    finite = active & ~is_plane
    n_finite = finite.sum(dim=1, keepdim=True)
    ext_sorted = torch.sort(torch.where(finite, ext_c, float("inf")), dim=1).values
    median_ext = ext_sorted.gather(1, torch.clamp(n_finite // 2, 0, m - 1))
    is_big = finite & (ext_c > 4.0 * torch.clamp(median_ext, min=1e-6))
    is_global = is_plane | is_big
    in_sweep = active & ~is_global
    cell = 1.001 * torch.clamp(
        torch.where(in_sweep[..., None], ext_axis, 0.0).reshape(scenes, -1).amax(dim=1),
        min=1e-3,
    )
    return cell, in_sweep.reshape(-1), is_global.reshape(-1)


def grid_entries(world: World, config: PhysicsConfig) -> GridEntries:
    """Emit, sort and gather the grid entries (reference :217-279)."""
    col = world.colliders
    scenes = world.scene_count
    w = sweep_window(config, col.capacity // scenes)
    cell, in_sweep, is_global = sweep_cell(col, scenes)
    ckey, fpack, ipack = ke.cell_keys(world.bodies, col, cell, in_sweep)
    skey, order = torch.sort(ckey, stable=True)
    scol = order // 8
    return GridEntries(
        skey=skey.contiguous(),
        scol=scol,
        sf=fpack[scol].contiguous(),
        si=ipack[scol].contiguous(),
        window=w,
        is_global=is_global,
        dyn=ipack[:, 6] > 0,
    )


def compaction_args(world: World, g: GridEntries, bits, rank) -> tuple:
    """Kernel L's arguments after Kernel B's sweep: the global colliders of
    the dense pass (each scene's own, at most MAX_GLOBALS, lowest index
    first: [B, G]), the colliders' filter columns and the joint-disabled
    body pairs."""
    col = world.colliders
    scenes = world.scene_count
    m = col.capacity // scenes
    score = (g.is_global & col.active).to(torch.int32).reshape(scenes, m)
    local = torch.argsort(-score, dim=1, stable=True)[:, :min(MAX_GLOBALS, m)]
    g_valid = score.gather(1, local) > 0
    global_overflow = torch.clamp(score.sum(dim=1) - local.shape[1], min=0).to(torch.int64)
    g_idx = local + torch.arange(scenes, device=local.device)[:, None] * m
    n_bodies = world.bodies.capacity
    return (
        bits, rank, g.skey, g.scol.contiguous(), g.window,
        kl.Colliders(col.aabb_min, col.aabb_max, col.active, g.is_global, g.dyn,
                     col.body_idx, col.layer_members, col.layer_filter),
        g_idx.contiguous(), g_valid.contiguous(), global_overflow,
        kl.joint_keys(world.joints, n_bodies), n_bodies, world.contacts.capacity // scenes,
    )


def broad_phase(world: World, config: PhysicsConfig) -> BroadPhaseResult:
    """Grid cell-list broadphase (reference ``broad_phase`` :179)."""
    g = grid_entries(world, config)
    bits, rank = kb.grid_sweep(g.skey, g.sf, g.si, g.window)
    pairs = kl.compact_pairs(*compaction_args(world, g, bits, rank))
    # The counts of Kernel L's B scenes shaped as the world's own: 0-d for a world.
    return BroadPhaseResult(*pairs._replace(num_pairs=pairs.num_pairs.reshape(world.time.shape),
                                            dropped=pairs.dropped.reshape(world.time.shape)))
