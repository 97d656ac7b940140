"""Broadphase: uniform-grid cell list into a fixed-capacity pair buffer
(port of ``avian_tpu/pipeline/broadphase.py``).

The algorithm and its outputs are the reference's: cell size = largest
in-grid AABB extent, up to 8 cell entries per collider, a stable sort of
the packed cell keys, a same-cell window sweep with canonical-cell
deduplication (Kernel B, ``kernels/grid_sweep.py``), compaction in
(entry, window position) order, then a dense pass against at most 16
"global" colliders (half-spaces and colliders > 4x the median extent).
Slots, pair keys and ``dropped`` match the reference exactly. Poses, AABBs
and key emission are Kernel E (``kernels/collider_aabbs.py``); the sort is
``torch.sort`` (the reference calls ``lax.sort`` there); the extent
reductions, the compaction and the global pass are plain PyTorch.
"""

from dataclasses import dataclass

import torch

from avian_tpu_torch.core import types
from avian_tpu_torch.core.config import PhysicsConfig
from avian_tpu_torch.core.state import World
from avian_tpu_torch.geometry import shapes
from avian_tpu_torch.kernels import collider_aabbs as ke
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


def update_aabbs(world: World, config: PhysicsConfig) -> World:
    """World AABBs, expanded for speculative contacts (reference :96)."""
    return update_aabbs_and_poses(world, config)[0]


def sweep_window(config: PhysicsConfig, m: int) -> int:
    w = min(config.sap_window, max(8 * m - 1, 1))
    if w > 32:
        raise ValueError(
            f"sap_window={config.sap_window} > 32: the candidate bitmask is "
            "one u32 per grid entry"
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


def broad_phase(world: World, config: PhysicsConfig) -> BroadPhaseResult:
    """Grid cell-list broadphase (reference ``broad_phase`` :179)."""
    col = world.colliders
    m = col.capacity
    c_cap = world.contacts.capacity
    dev = col.aabb_min.device
    g = grid_entries(world, config)
    w = g.window
    n_e = g.skey.shape[0]

    bits, rank = kb.grid_sweep(g.skey, g.sf, g.si, w)
    window_overflow = ((rank > w) & (g.skey != kb.SENTINEL)).sum()

    # Compaction in (entry, k) order: row-major nonzero of the bit matrix.
    shifts = torch.arange(w, dtype=torch.int32, device=dev)
    cand = ((bits[:, None] >> shifts[None, :]) & 1) != 0
    e_idx, k_idx = torch.nonzero(cand, as_tuple=True)
    total_grid = e_idx.shape[0]
    n_grid = min(total_grid, c_cap)
    ga = g.scol[e_idx[:n_grid]]
    gb = g.scol[torch.clamp(e_idx[:n_grid] + k_idx[:n_grid] + 1, max=n_e - 1)]

    # Dense pass of the global colliders against every collider.
    g_cap = min(MAX_GLOBALS, m)
    g_score = (g.is_global & col.active).to(torch.int32)
    g_idx = torch.argsort(-g_score, stable=True)[:g_cap]
    g_valid = g_score[g_idx] > 0
    global_overflow = torch.clamp(g_score.sum() - g_cap, min=0)
    all_i = torch.arange(m, device=dev)
    body = col.body_idx
    mem, fil = col.layer_members, col.layer_filter
    g_overlap = (
        (col.aabb_min[g_idx][:, None, :] <= col.aabb_max[None, :, :])
        & (col.aabb_min[None, :, :] <= col.aabb_max[g_idx][:, None, :])
    ).all(dim=-1)
    glob_ok = (
        g_valid[:, None]
        & col.active[None, :]
        & (g_idx[:, None] != all_i[None, :])
        & (~g.is_global[None, :] | (all_i[None, :] < g_idx[:, None]))
        & g_overlap
        & (body[g_idx][:, None] != body[None, :])
        & ((mem[g_idx][:, None] & fil[None, :]) != 0)
        & ((mem[None, :] & fil[g_idx][:, None]) != 0)
        & (g.dyn[g_idx][:, None] | g.dyn[None, :])
    )
    gl_id = torch.nonzero(glob_ok.reshape(-1), as_tuple=True)[0]
    total_glob = gl_id.shape[0]
    n_glob = max(0, min(total_glob, c_cap - total_grid))
    gl_id = gl_id[:n_glob]

    ca = torch.zeros((c_cap,), dtype=torch.int64, device=dev)
    cb = torch.zeros((c_cap,), dtype=torch.int64, device=dev)
    got = torch.zeros((c_cap,), dtype=torch.bool, device=dev)
    ca[:n_grid] = ga
    cb[:n_grid] = gb
    got[:n_grid] = True
    if n_glob:
        ca[total_grid:total_grid + n_glob] = gl_id % m
        cb[total_grid:total_grid + n_glob] = g_idx[gl_id // m]
        got[total_grid:total_grid + n_glob] = True

    lo = torch.minimum(ca, cb)
    hi = torch.maximum(ca, cb)
    key = torch.where(got, lo * m + hi, -1)
    dropped = (
        max(total_grid + total_glob - c_cap, 0) + window_overflow + global_overflow
    )
    return BroadPhaseResult(
        collider_a=ca.to(torch.int32),
        collider_b=cb.to(torch.int32),
        pair_key=key,
        valid=got,
        num_pairs=got.sum().to(torch.int32),
        dropped=dropped.to(torch.int32),
    )
