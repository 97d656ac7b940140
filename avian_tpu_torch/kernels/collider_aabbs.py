"""Kernel E, ``collider_aabbs``: collider poses, speculative AABBs and the
broadphase's grid cell keys.

Replaces ``avian_tpu/pipeline/broadphase.py::update_collider_poses`` (:85)
and ``update_aabbs`` (:96) with ``avian_tpu/geometry/shapes.py::world_aabb``
(:71), and the key emission of ``broad_phase`` (:217-279). Two launches, one
thread per collider each:

- ``collider_aabbs``: world pose = body pose o local offset, the rotated
  AABB of the shape's local box (sphere, capsule ``(r, h + r, r)``, box,
  cylinder and cone ``(r, h, r)``, segment ``(h, 0, 0)``, a pool-backed
  convex shape its params' ``(hx, hy, hz)``, half-space, padded slot; a
  sphere's is not rotated), and the symmetric expansion
  ``min(|v| dt, speculative margin) + collision margin + tolerance``. It
  also returns the world pose, which the narrowphase reuses.
- ``cell_keys``: ``floor(aabb / cell)``, the up to 8 cell keys packed
  10+10+10 bits (``SENTINEL`` elsewhere), and the per-collider rows
  ``fpack``/``ipack`` that Kernel B reads after the sort, for B scenes of
  M / B colliders with one cell size each (B = 1 for a world, B > 1 for the
  flat world that ``parallel.make_batched_step`` steps). A key is an int64
  with the collider's scene above its 31 bits (``scene_key``): the keys
  sort into B runs that no pair crosses, and a world's, scene 0's, are the
  reference's 32-bit ones.

Between the two, the cell size needs the largest in-sweep extent and the
median extent; those reductions stay torch calls (the reference calls
``jnp.max``/``jnp.sort`` there), and the cell sizes reach the second launch
as a pointer, never through the host.

On the H100 both launches are bound by bytes (about 170 and 180 per
collider); each is one pass with no intermediate in device memory, where the
plain version makes some 60 elementwise launches. The kernel divides with
``__fdiv_rn`` and clamps to +-2e9 before the cast to int, so every key is the
plain version's.

The plain PyTorch versions, ``collider_aabbs_twin`` and ``cell_keys_twin``,
run on CPU tensors; on a CUDA tensor the wrappers launch the kernel or raise.
"""

import torch

from avian_tpu_torch.core import types
from avian_tpu_torch.geometry import shapes
from avian_tpu_torch.kernels.grid_sweep import F_COLS, I_COLS, SENTINEL, cell_key, scene_key
from avian_tpu_torch.math import quat as quat_m
from avian_tpu_torch.math import vec

_CELL_OFFSETS = [[dx, dy, dz] for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]
_CELL_LIMIT = 2.0e9  # coordinates beyond i32 only occur outside the grid


def collider_aabbs_twin(bodies, col, dt, spec_default, tol):
    """Plain PyTorch version; see ``collider_aabbs``."""
    body = col.body_idx.long()
    bq = bodies.quat[body]
    pos = bodies.pos[body] + quat_m.rotate(bq, col.local_pos)
    quat = quat_m.mul(bq, col.local_quat)
    lo, hi = shapes.world_aabb(col.shape_type, col.params, pos, quat)
    speed = vec.length(bodies.lin_vel[body])
    spec = torch.clamp(col.speculative_margin, max=spec_default)
    expand = torch.minimum(speed * dt, spec) + col.collision_margin + tol
    e = expand[:, None]
    return lo - e, hi + e, pos, quat


def collider_aabbs(bodies, col, dt, spec_default, tol):
    """(aabb_min f32[M,3], aabb_max f32[M,3], pos f32[M,3], quat f32[M,4]) of
    the colliders ``col`` on the bodies ``bodies``."""
    dev = col.params.device
    if dev.type == "cpu":
        return collider_aabbs_twin(bodies, col, dt, spec_default, tol)
    if dev.type != "cuda":
        raise RuntimeError(f"collider_aabbs: unsupported device {dev}")
    from avian_tpu_torch.kernels import build

    m, n = col.capacity, bodies.capacity
    f32, i32 = torch.float32, torch.int32
    build.require("collider_aabbs", dev, (
        ("body_idx", col.body_idx, (m,), i32), ("shape_type", col.shape_type, (m,), i32),
        ("params", col.params, (m, 8), f32), ("local_pos", col.local_pos, (m, 3), f32),
        ("local_quat", col.local_quat, (m, 4), f32),
        ("speculative_margin", col.speculative_margin, (m,), f32),
        ("collision_margin", col.collision_margin, (m,), f32),
        ("pos", bodies.pos, (n, 3), f32), ("quat", bodies.quat, (n, 4), f32),
        ("lin_vel", bodies.lin_vel, (n, 3), f32),
    ))
    lo = torch.empty((m, 3), dtype=f32, device=dev)
    hi = torch.empty((m, 3), dtype=f32, device=dev)
    pos = torch.empty((m, 3), dtype=f32, device=dev)
    quat = torch.empty((m, 4), dtype=f32, device=dev)
    if m == 0:
        return lo, hi, pos, quat
    build.launch(
        "avian_collider_aabbs", dev, m, col.body_idx, col.shape_type, col.params,
        col.local_pos, col.local_quat, col.speculative_margin, col.collision_margin,
        bodies.pos, bodies.quat, bodies.lin_vel, float(dt), float(spec_default),
        float(tol), lo, hi, pos, quat,
    )
    collider_aabbs.launches += 1
    return lo, hi, pos, quat


collider_aabbs.launches = 0


def _scene_size(col, cell):
    """M / B: the colliders of each scene of the cell sizes ``cell`` f32[B]."""
    m = col.capacity
    if cell.dim() != 1 or cell.shape[0] == 0 or m % cell.shape[0]:
        raise ValueError(f"cell_keys: {m} colliders in scenes of cells {tuple(cell.shape)}")
    return max(m // cell.shape[0], 1)


def cell_keys_twin(bodies, col, cell, in_sweep):
    """Plain PyTorch version; see ``cell_keys``."""
    dev = col.aabb_min.device
    scene = torch.arange(col.capacity, device=dev) // _scene_size(col, cell)
    cell_c = cell[scene][:, None]
    body = col.body_idx.long()
    dyn = (bodies.body_type[body] == types.BodyType.DYNAMIC) & bodies.active[body]
    lim = _CELL_LIMIT
    i0 = torch.floor(col.aabb_min / cell_c).clamp(-lim, lim).to(torch.int32)
    i1 = torch.floor(col.aabb_max / cell_c).clamp(-lim, lim).to(torch.int32)
    offsets = torch.tensor(_CELL_OFFSETS, dtype=torch.int32, device=dev)
    cc = i0[:, None, :] + offsets[None, :, :]
    entry_ok = (cc <= i1[:, None, :]).all(dim=-1) & in_sweep[:, None]
    ckey = scene_key(scene[:, None], torch.where(entry_ok, cell_key(cc), SENTINEL)).reshape(-1)
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
    return ckey, fpack, ipack


def cell_keys(bodies, col, cell, in_sweep):
    """Grid entries of the colliders: ``ckey`` i64[8M] (entry ``8 i + j`` is
    collider ``i``'s cell ``min-cell + offset j``, ``SENTINEL`` where the
    AABB does not reach it or the collider is not in the sweep, with the
    collider's scene above them: ``scene_key``), ``fpack`` f32[M, 6] (AABB)
    and ``ipack`` i32[M, 7] (min-cell, body, layer members, layer filter,
    dynamic). ``cell`` f32[B] is the cell size of each of B scenes of M / B
    colliders, on the colliders' device; ``in_sweep`` bool[M]."""
    dev = col.aabb_min.device
    if dev.type == "cpu":
        return cell_keys_twin(bodies, col, cell, in_sweep)
    if dev.type != "cuda":
        raise RuntimeError(f"cell_keys: unsupported device {dev}")
    from avian_tpu_torch.kernels import build

    m, n = col.capacity, bodies.capacity
    f32, i32 = torch.float32, torch.int32
    m_scene = _scene_size(col, cell)
    build.require("cell_keys", dev, (
        ("aabb_min", col.aabb_min, (m, 3), f32), ("aabb_max", col.aabb_max, (m, 3), f32),
        ("cell", cell, (cell.shape[0],), f32), ("in_sweep", in_sweep, (m,), torch.bool),
        ("body_idx", col.body_idx, (m,), i32),
        ("layer_members", col.layer_members, (m,), i32),
        ("layer_filter", col.layer_filter, (m,), i32),
        ("body_type", bodies.body_type, (n,), i32), ("active", bodies.active, (n,), torch.bool),
    ))
    ckey = torch.empty((8 * m,), dtype=torch.int64, device=dev)
    fpack = torch.empty((m, F_COLS), dtype=f32, device=dev)
    ipack = torch.empty((m, I_COLS), dtype=i32, device=dev)
    if m == 0:
        return ckey, fpack, ipack
    build.launch(
        "avian_cell_keys", dev, m, m_scene, col.aabb_min, col.aabb_max, cell, in_sweep,
        col.body_idx, col.layer_members, col.layer_filter, bodies.body_type,
        bodies.active, ckey, fpack, ipack,
    )
    cell_keys.launches += 1
    return ckey, fpack, ipack


cell_keys.launches = 0
