"""Broadphase: uniform-grid cell list into a fixed-capacity pair buffer
(port of ``avian_tpu/pipeline/broadphase.py``).

The algorithm and its outputs are the reference's: cell size = largest
in-grid AABB extent, up to 8 cell entries per collider, a stable sort of
the packed cell keys, a same-cell window sweep with canonical-cell
deduplication (Kernel B, ``kernels/grid_sweep.py``), compaction in
(entry, window position) order, then a dense pass against at most 16
"global" colliders (half-spaces and colliders > 4x the median extent), and
the pairs of two bodies joined by a ``collision_disabled`` joint dropped.
Slots, pair keys and ``dropped`` match the reference exactly. Poses, AABBs
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
from avian_tpu_torch.kernels import grid_sweep as kb

MAX_GLOBALS = 16


@dataclass(frozen=True)
class BroadPhaseResult:
    """Candidate collider pairs, compacted into C slots."""

    collider_a: torch.Tensor  # i32[C]
    collider_b: torch.Tensor  # i32[C]
    pair_key: torch.Tensor    # i64[C]; -1 for empty slots
    valid: torch.Tensor       # bool[C]
    num_pairs: torch.Tensor   # i32[]
    dropped: torch.Tensor     # i32[] candidates that fit in no slot


@dataclass(frozen=True)
class GridEntries:
    """The cell-sorted grid table Kernel B sweeps."""

    skey: torch.Tensor  # i32[8M] sorted cell keys
    scol: torch.Tensor  # i64[8M] collider of each sorted entry
    sf: torch.Tensor    # f32[8M, 6]
    si: torch.Tensor    # i32[8M, 7]
    window: int
    is_global: torch.Tensor  # bool[M]
    dyn: torch.Tensor        # bool[M]


def update_aabbs_and_poses(world: World, config: PhysicsConfig):
    """``(world with this step's AABBs, collider pos f32[M,3], quat f32[M,4])``:
    world pose of each collider = body pose o local offset, and its AABB
    expanded for speculative contacts (reference :85, :96). One launch of
    Kernel E."""
    col = world.colliders
    lo, hi, pos, quat = ke.collider_aabbs(
        world.bodies, col, config.dt,
        config.narrow_phase.default_speculative_margin,
        config.narrow_phase.contact_tolerance * config.length_unit,
    )
    return world.replace(colliders=col.replace(aabb_min=lo, aabb_max=hi)), pos, quat


def collider_poses(world: World):
    """``(pos f32[M,3], quat f32[M,4])``: each collider's world pose (reference
    ``update_collider_poses`` :85), from Kernel E's pose path; the AABBs it
    computes beside them are dropped."""
    return update_aabbs_and_poses(world, PhysicsConfig())[1:]


def update_aabbs(world: World, config: PhysicsConfig) -> World:
    """World AABBs, expanded for speculative contacts (reference :96)."""
    return update_aabbs_and_poses(world, config)[0]


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


def sweep_cell(col):
    """``(cell f32[], in_sweep bool[M], is_global bool[M])``: the grid's cell
    size (1.001 x the largest in-sweep AABB extent, on the device) and which
    colliders go through the grid; half-spaces and colliders > 4x the median
    extent are "global" (reference :217-243)."""
    m = col.capacity
    ext_axis = col.aabb_max - col.aabb_min
    ext_c = ext_axis.amax(dim=-1)
    is_plane = ext_c > shapes.BIG
    finite = col.active & ~is_plane
    n_finite = finite.sum()
    ext_sorted = torch.sort(torch.where(finite, ext_c, float("inf"))).values
    median_ext = ext_sorted[torch.clamp(n_finite // 2, 0, m - 1)]
    is_big = finite & (ext_c > 4.0 * torch.clamp(median_ext, min=1e-6))
    is_global = is_plane | is_big
    in_sweep = col.active & ~is_global
    cell = 1.001 * torch.clamp(
        torch.where(in_sweep[:, None], ext_axis, 0.0).max(), min=1e-3
    )
    return cell, in_sweep, is_global


def grid_entries(world: World, config: PhysicsConfig) -> GridEntries:
    """Emit, sort and gather the grid entries (reference :217-279)."""
    col = world.colliders
    w = sweep_window(config, col.capacity)
    cell, in_sweep, is_global = sweep_cell(col)
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
    the dense pass (at most MAX_GLOBALS, lowest index first), the colliders'
    filter columns and the joint-disabled body pairs."""
    col = world.colliders
    score = (g.is_global & col.active).to(torch.int32)
    g_idx = torch.argsort(-score, stable=True)[:min(MAX_GLOBALS, col.capacity)].contiguous()
    g_valid = (score[g_idx] > 0).contiguous()
    global_overflow = torch.clamp(score.sum() - g_idx.shape[0], min=0).to(torch.int64)
    n_bodies = world.bodies.capacity
    return (
        bits, rank, g.skey, g.scol.contiguous(), g.window,
        kl.Colliders(col.aabb_min, col.aabb_max, col.active, g.is_global, g.dyn,
                     col.body_idx, col.layer_members, col.layer_filter),
        g_idx, g_valid, global_overflow, kl.joint_keys(world.joints, n_bodies), n_bodies,
        world.contacts.capacity,
    )


def broad_phase(world: World, config: PhysicsConfig) -> BroadPhaseResult:
    """Grid cell-list broadphase (reference ``broad_phase`` :179)."""
    g = grid_entries(world, config)
    bits, rank = kb.grid_sweep(g.skey, g.sf, g.si, g.window)
    return BroadPhaseResult(*kl.compact_pairs(*compaction_args(world, g, bits, rank)))
