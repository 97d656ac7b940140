"""Grid-accelerated ray casts and persistent casters (port of
``avian_tpu/queries/accel.py``; the reference's per-step BVH rebuild and its
``RayCaster`` / ``ShapeCaster`` components).

``build_query_grid`` rebuilds the broadphase's uniform grid over the stored
AABBs: the cell size, the grid and global colliders of
``pipeline/broadphase.py::sweep_cell``, Kernel E's packed cell keys
(``kernels/collider_aabbs.py::cell_keys``) and one stable ``torch.sort``.
``cast_ray_grid`` walks it with Kernel AG (``kernels/ray_cast_grid.py``), R
rays a launch; it matches the brute-force ``cast_ray`` for hits within
``max_cells`` cells whose runs fit ``cell_window``.

``RayCasters`` and ``ShapeCasters`` hold persistent casters, in the world
frame or attached to a body (origin and direction in the body's frame).
``update_ray_casters`` casts all of them in one launch of AG, each with its
own ``solid`` flag (the reference drops it, ROADMAP 3b);
``update_shape_casters`` makes one ``cast_shape`` (Kernel S) a caster.
"""

from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch

from avian_tpu_torch.core.state import _Columns
from avian_tpu_torch.kernels import collider_aabbs as ke
from avian_tpu_torch.kernels import ray_cast_grid as kag
from avian_tpu_torch.math import quat as quat_m
from avian_tpu_torch.math import vec
from avian_tpu_torch.pipeline.broadphase import MAX_GLOBALS, collider_poses, sweep_cell
from avian_tpu_torch.queries.filter import QueryFilter, collider_query_mask
from avian_tpu_torch.api.custom_shapes import refuse
from avian_tpu_torch.queries.raycast import RayHit, ray_kinds
from avian_tpu_torch.queries.shapecast import ShapeHit, cast_shape

BIG = kag.BIG


@dataclass(frozen=True)
class QueryGrid:
    """The sorted cell list over the collider AABBs (rebuilt per call, like
    the reference's BVH rebuild)."""

    cell: torch.Tensor          # f32[] cell size
    skey: torch.Tensor          # i32[8M] sorted packed cell keys
    scol: torch.Tensor          # i32[8M] collider of each sorted entry
    global_idx: torch.Tensor    # i32[G] the dense pass's colliders (half-spaces, huge)
    global_valid: torch.Tensor  # bool[G]


def build_query_grid(world) -> QueryGrid:
    """The grid of the stored AABBs (``update_aabbs`` must have run): cell
    size 1.001 x the largest in-grid extent, up to 8 cells an AABB, the
    entries sorted by key (stable), and the global colliders lowest index
    first, at most ``MAX_GLOBALS``."""
    refuse(world, "the query grid (Kernel AG)")
    col = world.colliders
    m = col.capacity
    cell, in_grid, is_global = sweep_cell(col)
    ckey, _, _ = ke.cell_keys(world.bodies, col, cell, in_grid)
    skey, order = torch.sort(ckey, stable=True)
    score = (is_global & col.active).to(torch.int32)
    g_idx = torch.argsort(-score, stable=True)[:min(MAX_GLOBALS, m)]
    return QueryGrid(cell=cell.to(torch.float32).contiguous(), skey=skey.contiguous(),
                     scol=(order // 8).to(torch.int32).contiguous(),
                     global_idx=g_idx.to(torch.int32).contiguous(),
                     global_valid=(score[g_idx] > 0).contiguous())


def grid_tables(world, grid: QueryGrid, qfilter: QueryFilter) -> kag.GridTables:
    """What Kernel AG reads: the grid, and the colliders' ray kinds, query
    mask, poses, params and the vertex pool."""
    col = world.colliders
    pos, quat = collider_poses(world)
    return kag.GridTables(
        grid.cell, grid.skey, grid.scol, grid.global_idx, grid.global_valid,
        ray_kinds(world).to(torch.int32).contiguous(),
        collider_query_mask(col, qfilter).contiguous(), pos.contiguous(), quat.contiguous(),
        col.params.contiguous(), world.convex_verts.contiguous())


def _column(x, n, dtype, device):
    """``x`` (a scalar or one value a ray) as a [n] tensor."""
    return torch.as_tensor(x, dtype=dtype).to(device).expand(n).contiguous()


def cast_ray_grid(world, grid: QueryGrid, origin, direction, max_distance, solid=True,
                  qfilter: QueryFilter = None, max_cells: int = 64,
                  cell_window: int = 32) -> RayHit:
    """Grid-accelerated first-hit ray cast: one ray (``origin``,
    ``direction`` [3]) or R rays at once ([R, 3]; ``max_distance`` and
    ``solid`` one for all or one a ray), in one launch of Kernel AG. Matches
    ``cast_ray`` for hits within ``max_cells * cell`` of travel whose cells'
    runs fit ``cell_window``; the first visited cell wins ties."""
    refuse(world, "cast_ray_grid (Kernel AG)")
    qfilter = qfilter if qfilter is not None else QueryFilter()
    dev = world.device
    col = world.colliders
    o = torch.as_tensor(origin, dtype=torch.float32).to(dev)
    one = o.dim() == 1
    o = o.reshape(-1, 3)
    d = torch.as_tensor(direction, dtype=torch.float32).to(dev).reshape(-1, 3)
    d = vec.normalize_or_rn(d, torch.tensor([1.0, 0.0, 0.0], device=dev))
    r_n = o.shape[0]
    t, n, ci = kag.ray_cast_grid(torch.cat([o, d], 1).contiguous(),
                                 _column(max_distance, r_n, torch.float32, dev),
                                 _column(solid, r_n, torch.bool, dev),
                                 grid_tables(world, grid, qfilter), max_cells, cell_window)
    found = t < BIG
    hit = RayHit(
        collider=torch.where(found, ci, -1).to(torch.int32),
        body=torch.where(found, col.body_idx[ci.clamp(min=0).long()], -1).to(torch.int32),
        distance=torch.where(found, t, float("inf")),
        point=o + d * torch.where(found, t, 0.0)[:, None], normal=n, hit=found)
    return RayHit(*(x[0] for x in vars(hit).values())) if one else hit


def _attached(world, body, origin, direction, rotation=None):
    """World origins, directions (and rotations) of casters on ``body``
    i32[K] (-1: already in the world frame), from the bodies' poses."""
    b = world.bodies
    attached = (body >= 0)[:, None]
    bidx = body.clamp(min=0).long()
    bq = b.quat[bidx]
    o = torch.where(attached, b.pos[bidx] + quat_m.rotate(bq, origin), origin)
    d = torch.where(attached, quat_m.rotate(bq, direction), direction)
    if rotation is None:
        return o, d
    return o, d, torch.where(attached, quat_m.mul(bq, rotation), rotation)


def _from_dicts(casters, fields):
    """``len(casters)`` caster slots (at least one) as a namespace of numpy
    columns: each field's ``(dtype, width, default)``, every slot disabled
    but those given."""
    k = max(len(casters), 1)
    cols = {name: np.full((k, width) if width else (k,), default, dtype)
            for name, (dtype, width, default) in fields.items()}
    cols["enabled"] = np.zeros(k, bool)
    for i, c in enumerate(casters):
        for name, (dtype, width, default) in fields.items():
            value = np.asarray(c.get(name, default), dtype).reshape(-1)
            if width:
                cols[name][i, :value.shape[0]] = value
            else:
                cols[name][i] = value[0]
        cols["enabled"][i] = True
    return SimpleNamespace(**cols)


@dataclass(frozen=True)
class RayCasters(_Columns):
    """SoA of persistent ray casters (reference ``RayCasters``,
    ``ray_caster.rs:78-140``). A caster attached to a body (``body >= 0``)
    has its origin and direction in the body's frame and follows it."""

    body: torch.Tensor          # i32[K] attached body (-1: world frame)
    origin: torch.Tensor        # f32[K, 3]
    direction: torch.Tensor     # f32[K, 3]
    max_distance: torch.Tensor  # f32[K]
    solid: torch.Tensor         # bool[K]
    enabled: torch.Tensor       # bool[K]

    @classmethod
    def create(cls, casters, device=None):
        """From a list of dicts with keys body, origin, direction,
        max_distance, solid (each optional); one disabled slot for none."""
        return cls.from_numpy(_from_dicts(casters, {
            "body": (np.int32, 0, -1), "origin": (np.float32, 3, (0.0, 0.0, 0.0)),
            "direction": (np.float32, 3, (1.0, 0.0, 0.0)),
            "max_distance": (np.float32, 0, 1e9), "solid": (bool, 0, True)}), device)


@dataclass(frozen=True)
class ShapeCasters(_Columns):
    """SoA of persistent shape casters (reference ``ShapeCasters``,
    ``shape_caster.rs``): a shape type and params a slot, origin, rotation
    and direction in the attached body's frame (or the world's with
    ``body == -1``)."""

    body: torch.Tensor          # i32[K]
    shape_type: torch.Tensor    # i32[K]
    params: torch.Tensor        # f32[K, 8]
    origin: torch.Tensor        # f32[K, 3]
    rotation: torch.Tensor      # f32[K, 4]
    direction: torch.Tensor     # f32[K, 3]
    max_distance: torch.Tensor  # f32[K]
    enabled: torch.Tensor       # bool[K]

    @classmethod
    def create(cls, casters, device=None):
        """From a list of dicts with keys shape_type, params, body, origin,
        rotation, direction and max_distance (the shape a sphere of radius 0
        where not given)."""
        return cls.from_numpy(_from_dicts(casters, {
            "body": (np.int32, 0, -1), "shape_type": (np.int32, 0, 0),
            "params": (np.float32, 8, (0.0,) * 8), "origin": (np.float32, 3, (0.0, 0.0, 0.0)),
            "rotation": (np.float32, 4, (0.0, 0.0, 0.0, 1.0)),
            "direction": (np.float32, 3, (1.0, 0.0, 0.0)),
            "max_distance": (np.float32, 0, 1e9)}), device)


def update_ray_casters(world, casters: RayCasters, grid: QueryGrid = None,
                       qfilter: QueryFilter = None, **kw) -> RayHit:
    """Cast every caster against the world in one launch of Kernel AG (the
    reference runs its ``RayCaster`` systems each step), each with its own
    ``solid`` flag; ``kw`` are ``cast_ray_grid``'s ``max_cells`` and
    ``cell_window``. A ``RayHit`` with a leading K axis; a disabled caster
    reports collider -1, distance ``inf`` and zero point and normal."""
    refuse(world, "update_ray_casters (Kernel AG)")
    if grid is None:
        grid = build_query_grid(world)
    o, d = _attached(world, casters.body, casters.origin, casters.direction)
    hits = cast_ray_grid(world, grid, o, d, casters.max_distance, casters.solid, qfilter, **kw)
    en = casters.enabled
    return RayHit(
        collider=torch.where(en, hits.collider, -1), body=torch.where(en, hits.body, -1),
        distance=torch.where(en, hits.distance, float("inf")),
        point=torch.where(en[:, None], hits.point, 0.0),
        normal=torch.where(en[:, None], hits.normal, 0.0), hit=en & hits.hit)


def update_shape_casters(world, casters: ShapeCasters, qfilter: QueryFilter = None) -> ShapeHit:
    """Cast every slot's shape, one ``cast_shape`` (Kernel S's launches) a
    slot, as the reference loops over its slots, disabled ones included. One
    host read of the shape types and of the casters' world poses; a
    ``ShapeHit`` with a leading K axis."""
    refuse(world, "update_shape_casters (Kernel S)")
    o, d, rot = _attached(world, casters.body, casters.origin, casters.direction,
                          casters.rotation)
    host = torch.cat([casters.shape_type[:, None].to(torch.float32), casters.params, o, rot, d,
                      casters.max_distance[:, None]], 1).tolist()
    hits = [cast_shape(world, int(row[0]), row[1:9], row[9:12], row[12:16], row[16:19], row[19],
                       qfilter=qfilter) for row in host]
    return ShapeHit(*(torch.stack(xs) for xs in zip(*(vars(h).values() for h in hits))))
