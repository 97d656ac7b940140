"""Swept CCD: conservative-advancement time-of-impact rewind (port of
``avian_tpu/pipeline/ccd.py``).

After the substep loop, the colliders of bodies flagged ``swept_ccd`` find
their earliest time of impact along this step's accumulated delta position
against every other collider, in relative motion, and their bodies' delta
positions are rewound to ``TOI * 1.0001`` so that the next step's
speculative contacts resolve the impact instead of tunneling. A pair that
touches at the start of the step counts only once the sweep carries it
deeper (``kernels/swept_toi.py``), where the reference drops it
(ROADMAP 3b). Per-body
``swept_ccd_nonlinear`` also sweeps the accumulated rotation and widens the
conservative step by the angular travel bound.

The prologue is plain tensor work on [M]; the K x M grid of pairs (at most
``config.max_swept_colliders`` swept colliders, lowest index first, as the
reference's ``lax.top_k`` on ``-arange`` picks them) is bucketed by canonical
shape pair with one sort and one host read, and each bucket is one launch of
Kernel R (``kernels/swept_toi.py``); the row and body minima are order-free
reductions.
"""

from typing import NamedTuple

import torch

from avian_tpu_torch.core.config import PhysicsConfig
from avian_tpu_torch.core.state import World
from avian_tpu_torch.core.types import CUSTOM_SHAPE_BASE, ShapeType
from avian_tpu_torch.geometry.narrowphase import canonical_spans
from avian_tpu_torch.kernels import swept_toi as kr
from avian_tpu_torch.math import quat as quat_m
from avian_tpu_torch.math import vec
from avian_tpu_torch.pipeline.solver_body import DPOS, DQUAT, SolverState

TOI_EPS = 1.0001  # advance slightly past the TOI (reference ccd.py:38)


class SweptGrid(NamedTuple):
    """The grid of one step: its tables, its swept colliders and its buckets."""

    tab: kr.SweptTables
    swept: torch.Tensor  # i32[K] the swept colliders, flagged ones first
    k_ok: int            # how many of them are flagged (the grid's rows)
    buckets: list        # (canonical pair, flat i32[P] = r * M + j)


def inner_radius(shape_type, params) -> torch.Tensor:
    """f32[M]: how far a collider reaches inward from its surface, at least:
    a sphere's or capsule's radius, a box's smallest half extent, half the
    smaller of a cylinder's or cone's half height and radius, a pool-backed
    shape's smallest half extent plus its round radius (0 for a flat
    triangle), 0 for half-spaces and segments."""
    p = params
    st = shape_type.long()
    r = torch.zeros_like(p[:, 0])
    r = torch.where(st == int(ShapeType.SPHERE), p[:, 0], r)
    r = torch.where(st == int(ShapeType.CAPSULE), p[:, 1], r)
    r = torch.where(st == int(ShapeType.BOX), p[:, :3].amin(1), r)
    round_ = (st == int(ShapeType.CYLINDER)) | (st == int(ShapeType.CONE))
    r = torch.where(round_, 0.5 * torch.minimum(p[:, 0], p[:, 1]), r)
    hull = st == int(ShapeType.CONVEX)
    return torch.where(hull, p[:, 2:5].amin(1) + p[:, 6], r).contiguous()


def swept_grid(world: World, s: SolverState, pos0, quat0, config: PhysicsConfig) -> SweptGrid:
    """The prologue: per-collider tables at t = 0 (``pos0``, ``quat0``: this
    step's collider poses, before the substeps moved anything), the swept
    colliders and the grid's buckets."""
    col, b = world.colliders, world.bodies
    m = col.capacity
    k_cap = min(config.max_swept_colliders, m)
    body = col.body_idx.long()
    sweep = s.state[:, DPOS:DPOS + 3][body]
    aa = quat_m.to_scaled_axis(s.state[:, DQUAT:DQUAT + 4][body])
    aa = torch.where(b.swept_ccd_nonlinear[body][:, None], aa, 0.0)
    # Angular travel bound: rotation angle x bounding radius (this step's
    # AABBs, from Kernel E).
    radius = 0.5 * vec.length_rn(col.aabb_max - col.aabb_min)
    ang = vec.length_rn(aa) * radius
    flagged = b.swept_ccd[body] & b.active[body] & col.active & (vec.length_sq(sweep) > 1e-12)
    # Lowest indices first: a stable sort puts the flagged colliders first.
    swept = torch.argsort((~flagged).to(torch.int8), stable=True)[:k_cap]
    k_ok = int(flagged.sum().clamp(max=k_cap))
    tab = kr.SweptTables(
        pos0.contiguous(), quat0.contiguous(), sweep.contiguous(), aa.contiguous(),
        ang.contiguous(), inner_radius(col.shape_type, col.params), col.params.contiguous(), col.shape_type.contiguous(),
        col.body_idx.contiguous(), col.active.contiguous(), col.layer_members.contiguous(),
        col.layer_filter.contiguous(), world.convex_verts.contiguous(),
    )
    swept = swept.to(torch.int32).contiguous()
    buckets = []
    if k_ok:
        pairs = config.shape_pairs if config.shape_pairs is not None else world.shape_pairs
        rows = col.shape_type[swept[:k_ok].long()]
        ta = rows[:, None].expand(k_ok, m).reshape(-1)
        tb = col.shape_type[None, :].expand(k_ok, m).reshape(-1)
        # The reference's sweep asks its narrowphase without the custom
        # shapes, so a custom collider's pairs get no manifold there and never
        # rewind a body (api/custom_shapes.py: swept CCD does not see custom
        # shapes); here they get no bucket.
        valid = (ta < CUSTOM_SHAPE_BASE) & (tb < CUSTOM_SHAPE_BASE)
        order, _, spans = canonical_spans(ta, tb, valid, pairs)
        order = order.to(torch.int32)
        buckets = [(pair, order[start:end].contiguous()) for pair, start, end in spans]
    return SweptGrid(tab, swept, k_ok, buckets)


def grid_tois(grid: SweptGrid, twin=False) -> torch.Tensor:
    """f32[k_ok, M]: min(TOI, 1) of every pair of the grid (1 where the pair
    is invalid, never hits, or its shape pair has no manifold), through
    Kernel R or, with ``twin``, its plain version."""
    m = grid.tab.pos0.shape[0]
    toi = torch.ones((grid.k_ok * m,), dtype=torch.float32, device=grid.tab.pos0.device)
    fn = kr.swept_toi_twin if twin else kr.swept_toi
    rows = grid.swept[:grid.k_ok].contiguous()
    for pair, flat in grid.buckets:
        fn(pair, flat, rows, m, grid.tab, toi)
    return toi.view(grid.k_ok, m)


def solve_swept_ccd(world: World, s: SolverState, pos0, quat0, config: PhysicsConfig):
    """Rewind the delta positions of swept-CCD bodies to their earliest TOI
    (reference ``solve_swept_ccd`` ccd.py:40). The packed solver state is
    updated in place (columns 6:9). Returns ``(s, grid)``: the grid's rows
    are the colliders swept (none when no flagged collider moved), its
    buckets the pairs each launch of Kernel R covered."""
    grid = swept_grid(world, s, pos0, quat0, config)
    if grid.k_ok == 0:
        return s, grid
    row_min = grid_tois(grid).amin(1)
    n_bodies = world.bodies.capacity
    body_toi = torch.ones((n_bodies,), dtype=torch.float32, device=row_min.device)
    body_toi.scatter_reduce_(0, world.colliders.body_idx[grid.swept[:grid.k_ok].long()].long(),
                             row_min, "amin")
    scale = torch.clamp(body_toi * TOI_EPS, max=1.0)
    s.state[:, DPOS:DPOS + 3] *= scale[:, None]
    return s, grid
