"""Broadphase: uniform-grid cell list into a fixed-capacity pair buffer
(port of ``avian_tpu/pipeline/broadphase.py``).

The algorithm and its outputs are the reference's: cell size = largest
in-grid AABB extent, up to 8 cell entries per collider, a stable sort of
the packed cell keys, a same-cell window sweep with canonical-cell
deduplication (Kernel B, ``kernels/grid_sweep.py``), compaction in
(entry, window position) order, then a dense pass against at most 16
"global" colliders (half-spaces and colliders > 4x the median extent).
Slots, pair keys and ``dropped`` match the reference exactly. The rest is
plain PyTorch: key emission, the sort, the compaction and the global pass.
"""

from dataclasses import dataclass

import torch

from avian_tpu_torch.core import types
from avian_tpu_torch.core.config import PhysicsConfig
from avian_tpu_torch.core.state import World
from avian_tpu_torch.geometry import shapes
from avian_tpu_torch.kernels import grid_sweep as kb
from avian_tpu_torch.math import quat as quat_m
from avian_tpu_torch.math import vec

MAX_GLOBALS = 16

_CELL_OFFSETS = [[dx, dy, dz] for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]


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


def update_collider_poses(world: World):
    """World pose of each collider = body pose o local offset."""
    col = world.colliders
    b = world.bodies
    body = col.body_idx.long()
    bq = b.quat[body]
    pos = b.pos[body] + quat_m.rotate(bq, col.local_pos)
    return pos, quat_m.mul(bq, col.local_quat)


def update_aabbs(world: World, config: PhysicsConfig) -> World:
    """World AABBs, expanded for speculative contacts (reference :96)."""
    col = world.colliders
    pos, quat = update_collider_poses(world)
    lo, hi = shapes.world_aabb(col.shape_type, col.params, pos, quat)
    v = world.bodies.lin_vel[col.body_idx.long()]
    speed = vec.length(v)
    spec = torch.clamp(
        col.speculative_margin, max=config.narrow_phase.default_speculative_margin
    )
    expand = (
        torch.minimum(speed * config.dt, spec)
        + col.collision_margin
        + config.narrow_phase.contact_tolerance * config.length_unit
    )
    e = expand[:, None]
    return world.replace(colliders=col.replace(aabb_min=lo - e, aabb_max=hi + e))


def sweep_window(config: PhysicsConfig, m: int) -> int:
    w = min(config.sap_window, max(8 * m - 1, 1))
    if w > 32:
        raise ValueError(
            f"sap_window={config.sap_window} > 32: the candidate bitmask is "
            "one u32 per grid entry"
        )
    return w


def grid_entries(world: World, config: PhysicsConfig) -> GridEntries:
    """Emit, sort and gather the grid entries (reference :217-279)."""
    col = world.colliders
    b = world.bodies
    m = col.capacity
    dev = col.aabb_min.device
    w = sweep_window(config, m)

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

    body = col.body_idx.long()
    dyn = (b.body_type[body] == types.BodyType.DYNAMIC) & b.active[body]

    cell = 1.001 * torch.clamp(
        torch.where(in_sweep[:, None], ext_axis, 0.0).max(), min=1e-3
    )
    # Coordinates beyond i32 only occur for colliders outside the grid.
    lim = 2.0e9
    i0 = torch.floor(col.aabb_min / cell).clamp(-lim, lim).to(torch.int32)
    i1 = torch.floor(col.aabb_max / cell).clamp(-lim, lim).to(torch.int32)
    offsets = torch.tensor(_CELL_OFFSETS, dtype=torch.int32, device=dev)
    cc = i0[:, None, :] + offsets[None, :, :]
    entry_ok = (cc <= i1[:, None, :]).all(dim=-1) & in_sweep[:, None]
    ckey = torch.where(entry_ok, kb.cell_key(cc), kb.SENTINEL).reshape(-1)
    skey, order = torch.sort(ckey, stable=True)
    scol = order // 8

    fpack = torch.cat([col.aabb_min, col.aabb_max], dim=-1)
    ipack = torch.cat(
        [
            i0,
            col.body_idx[:, None],
            col.layer_members[:, None],
            col.layer_filter[:, None],
            dyn[:, None].to(torch.int32),
        ],
        dim=-1,
    )
    return GridEntries(
        skey=skey.contiguous(),
        scol=scol,
        sf=fpack[scol].contiguous(),
        si=ipack[scol].contiguous(),
        window=w,
        is_global=is_global,
        dyn=dyn,
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
