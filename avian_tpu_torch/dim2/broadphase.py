"""2D broadphase: uniform-grid cell list into a fixed-capacity pair buffer
(port of ``avian_tpu/dim2/broadphase.py`` and ``broadphase_impl.py``).

The reference's algorithm and outputs: cell size 1.001 x the largest in-grid
AABB extent, so every AABB covers at most 4 cells; one entry a covered cell
with 15 + 15-bit cell keys; a stable sort of the keys (``torch.sort``, as the
reference calls ``argsort(stable=True)``); then Kernel U
(``kernels/grid_pairs_2d.py``): the same-cell window sweep with
canonical-cell deduplication, compaction, the dense pass against at most 16
"global" colliders (half-spaces and colliders > 4x the median extent), the
joint-disabled probe and the pair keys. Poses and AABBs are tensor
operations. Slots, keys and ``dropped`` equal the reference's.
"""

from dataclasses import dataclass

import torch

from avian_tpu_torch.core import types
from avian_tpu_torch.core.config import PhysicsConfig
from avian_tpu_torch.dim2.narrowphase import rotate
from avian_tpu_torch.dim2.state import MAX_POLY_VERTS, World2D
from avian_tpu_torch.kernels import compact_pairs as kl
from avian_tpu_torch.kernels import grid_pairs_2d as ku

MAX_GLOBALS = 16
_CELL_OFFSETS = ((0, 0), (0, 1), (1, 0), (1, 1))


@dataclass(frozen=True)
class BroadPhaseResult2D:
    collider_a: torch.Tensor  # i32[C]
    collider_b: torch.Tensor  # i32[C]
    pair_key: torch.Tensor    # i64[C]; -1 for empty slots
    valid: torch.Tensor       # bool[C]
    num_pairs: torch.Tensor   # i32[]
    dropped: torch.Tensor     # i32[]


@dataclass(frozen=True)
class Poses2D:
    """This step's trigonometry, computed once: each body's and each
    collider's (cos, sin), and each collider's world position."""

    body_cs: torch.Tensor  # f32[N, 2]
    pos: torch.Tensor      # f32[M, 2]
    cs: torch.Tensor       # f32[M, 2]


def collider_poses(world: World2D) -> Poses2D:
    """World pose of each collider = body pose o local offset (reference
    ``update_collider_poses`` :48)."""
    col, b = world.colliders, world.bodies
    body = col.body_idx.long()
    body_cs = torch.stack([torch.cos(b.angle), torch.sin(b.angle)], -1)
    bcs = body_cs[body]
    pos = b.pos[body] + rotate(bcs[:, 0], bcs[:, 1], col.local_pos)
    angle = b.angle[body] + col.local_angle
    cs = torch.stack([torch.cos(angle), torch.sin(angle)], -1)
    return Poses2D(body_cs, pos.contiguous(), cs.contiguous())


def update_aabbs(world: World2D, config: PhysicsConfig, poses: Poses2D) -> World2D:
    """World AABBs expanded for speculative contacts (reference :59)."""
    col = world.colliders
    c, s = poses.cs[:, 0, None], poses.cs[:, 1, None]
    wv = poses.pos[:, None, :] + rotate(c, s, col.poly_verts)
    vmask = (torch.arange(MAX_POLY_VERTS, device=wv.device)[None, :]
             < col.vert_count[:, None])[..., None]
    r = col.radius[:, None]
    lo = torch.where(vmask, wv, float("inf")).amin(dim=1) - r
    hi = torch.where(vmask, wv, -float("inf")).amax(dim=1) + r
    plane = col.is_plane[:, None]
    lo = torch.where(plane, -1e12, lo)
    hi = torch.where(plane, 1e12, hi)
    v = world.bodies.lin_vel[col.body_idx.long()]
    speed = torch.sqrt(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1])
    spec = torch.clamp(col.speculative_margin,
                       max=config.narrow_phase.default_speculative_margin)
    expand = (torch.minimum(speed * config.dt, spec) + col.collision_margin
              + config.narrow_phase.contact_tolerance * config.length_unit)
    e = torch.where(col.is_plane, 0.0, expand)[:, None]
    return world.replace(colliders=col.replace(aabb_min=lo - e, aabb_max=hi + e))


def sweep_window(config: PhysicsConfig, m: int) -> int:
    """The reference's window, ``min(sap_window, 4M - 1)``, at most 32."""
    w = min(config.sap_window, max(4 * m - 1, 1))
    if w > ku.MAX_WINDOW:
        raise ValueError(
            f"sap_window={config.sap_window} > 32: the candidate bitmask is one u32 per "
            "grid entry"
        )
    return w


def grid_pair_inputs(world: World2D, config: PhysicsConfig) -> tuple:
    """Kernel U's arguments: the emitted, sorted and gathered grid entries
    (reference ``broadphase_impl.py`` :37-72), the global colliders of the
    dense pass (at most ``MAX_GLOBALS``, lowest index first), the colliders'
    filter columns and the joint-disabled body pairs."""
    col = world.colliders
    b = world.bodies
    m = col.capacity
    dev = col.aabb_min.device
    w = sweep_window(config, m)

    ext_axis = col.aabb_max - col.aabb_min
    ext_c = ext_axis.amax(dim=-1)
    finite = col.active & ~col.is_plane
    ext_sorted = torch.sort(torch.where(finite, ext_c, float("inf"))).values
    median_ext = ext_sorted[torch.clamp(finite.sum() // 2, 0, m - 1)]
    is_big = finite & (ext_c > 4.0 * torch.clamp(median_ext, min=1e-6))
    is_global = col.is_plane | is_big
    in_sweep = col.active & ~is_global

    body = col.body_idx.long()
    dyn = (b.body_type[body] == types.BodyType.DYNAMIC) & b.active[body]
    cell = 1.001 * torch.clamp(torch.where(in_sweep[:, None], ext_axis, 0.0).max(), min=1e-3)
    i0 = torch.floor(col.aabb_min / cell).to(torch.int32)
    i1 = torch.floor(col.aabb_max / cell).to(torch.int32)
    cc = i0[:, None, :] + torch.tensor(_CELL_OFFSETS, dtype=torch.int32, device=dev)[None]
    entry_ok = (cc <= i1[:, None, :]).all(dim=-1) & in_sweep[:, None]
    ckey = torch.where(entry_ok, ku.cell_key(cc), ku.SENTINEL).reshape(-1)
    skey, order = torch.sort(ckey, stable=True)
    scol = order // 4
    fpack = torch.cat([col.aabb_min, col.aabb_max], dim=-1)
    ipack = torch.cat([i0, col.body_idx[:, None], col.layer_members[:, None],
                       col.layer_filter[:, None], dyn[:, None].to(torch.int32)], dim=-1)

    score = (is_global & col.active).to(torch.int32)
    g_idx = torch.argsort(-score, stable=True)[:min(MAX_GLOBALS, m)].contiguous()
    g_valid = (score[g_idx] > 0).contiguous()
    global_overflow = torch.clamp(score.sum() - g_idx.shape[0], min=0).to(torch.int64)
    return (
        skey.contiguous(), scol.contiguous(), fpack[scol].contiguous(),
        ipack[scol].contiguous(), w,
        kl.Colliders(col.aabb_min, col.aabb_max, col.active, is_global, dyn,
                     col.body_idx, col.layer_members, col.layer_filter),
        g_idx, g_valid, global_overflow, kl.joint_keys(world.joints, b.capacity),
        b.capacity, world.contacts.capacity,
    )


def broad_phase(world: World2D, config: PhysicsConfig) -> BroadPhaseResult2D:
    """Grid cell-list broadphase (reference ``broad_phase`` :97)."""
    return BroadPhaseResult2D(*ku.grid_pairs_2d(*grid_pair_inputs(world, config)))
