"""2D swept CCD: conservative-advancement time-of-impact rewind (port of
``avian_tpu/dim2/ccd.py``).

After the substep loop, up to ``config.max_swept_colliders`` colliders of
bodies flagged ``swept_ccd`` (the lowest indices first, as the reference's
``lax.top_k`` on ``-arange`` picks them) sweep their accumulated delta
position, in relative motion so that swept pairs see each other, against
every collider, and the owning body's delta position is rewound to ``min
TOI * 1.0001`` so that the next step's speculative contacts resolve the
impact instead of tunneling. Per-body ``swept_ccd_nonlinear`` also sweeps
the accumulated rotation and widens the conservative step by the angular
travel bound.

The prologue (start poses, sweeps, travel bounds, the flagged colliders) is
tensor work on [M]; the K x M grid and the body minimum are one launch of
Kernel AB (``kernels/swept_toi_2d.py``); the rewind is one multiply. A pair
that touches at the start of the step counts once the sweep carries it
deeper, and a pair whose rounds run out returns its last t, where the
reference drops the first and returns 1 for the second (the 3D sweep's
repairs, ROADMAP 3b).
"""

import torch

from avian_tpu_torch.core.config import PhysicsConfig
from avian_tpu_torch.dim2.broadphase import Poses2D
from avian_tpu_torch.dim2.dynamics import SolverState2D
from avian_tpu_torch.dim2.state import MAX_POLY_VERTS, World2D
from avian_tpu_torch.kernels import swept_toi_2d as kab
from avian_tpu_torch.kernels.manifold_2d import norm2

TOI_EPS = 1.0001  # advance slightly past the TOI (reference ccd.py:26)


def inner_radius(colliders) -> torch.Tensor:
    """f32[M]: how far a collider reaches inward from its surface, at least:
    its rounding radius, plus, for a polygon of three or more vertices, the
    distance from its vertex mean to its nearest edge line (a box's smallest
    half extent); 0 for half-spaces and segments."""
    col = colliders
    v, n = col.poly_verts, col.vert_count
    lanes = torch.arange(MAX_POLY_VERTS, device=v.device)[None, :]
    on = lanes < n[:, None]
    mean = torch.where(on[..., None], v, 0.0).sum(1) / torch.clamp(n, min=1)[:, None]
    nxt = torch.where(lanes + 1 < n[:, None], lanes + 1, 0)
    e = torch.gather(v, 1, nxt[..., None].expand(-1, -1, 2)) - v
    length = torch.clamp(norm2(e), min=1e-9)
    depth = (e[..., 1] * (v[..., 0] - mean[:, None, 0])
             - e[..., 0] * (v[..., 1] - mean[:, None, 1])) / length
    core = torch.clamp(torch.where(on, depth, float("inf")).amin(1), min=0.0)
    r = col.radius + torch.where(n >= 3, core, 0.0)
    return torch.where(col.is_plane, 0.0, r).contiguous()


def swept_tables(world: World2D, s: SolverState2D, poses: Poses2D, config: PhysicsConfig):
    """The prologue (reference :36-67): ``(tables, swept i32[K])``, the
    per-collider tables of the grid at this step's poses (``poses``, before
    the substeps moved anything; ``world`` after ``update_aabbs``) and the
    flagged colliders, lowest index first, at most ``max_swept_colliders``."""
    col, b = world.colliders, world.bodies
    k_cap = min(config.max_swept_colliders, col.capacity)
    body = col.body_idx.long()
    sweep = s.delta_pos[body]
    dang = torch.where(b.swept_ccd_nonlinear[body], s.delta_angle[body], 0.0)
    radius = 0.5 * norm2(col.aabb_max - col.aabb_min)
    flagged = (b.swept_ccd[body] & b.active[body] & col.active
               & (sweep[:, 0] * sweep[:, 0] + sweep[:, 1] * sweep[:, 1] > 1e-12))
    swept = torch.nonzero(flagged)[:k_cap, 0].to(torch.int32).contiguous()
    tab = kab.SweptTables2D(
        poses.pos.contiguous(), poses.cs.contiguous(), (b.angle[body] + col.local_angle),
        sweep.contiguous(), dang.contiguous(), (torch.abs(dang) * radius).contiguous(),
        inner_radius(col), col.poly_verts, col.vert_count, col.radius, col.is_plane,
        col.body_idx, col.active, col.layer_members, col.layer_filter,
    )
    return tab, swept


def solve_swept_ccd_2d(world: World2D, s: SolverState2D, poses: Poses2D,
                       config: PhysicsConfig) -> SolverState2D:
    """Rewind the delta positions of swept-CCD bodies to their earliest TOI
    (reference ``solve_swept_ccd_2d`` :28). The packed solver state is
    updated in place (columns 3:5)."""
    tab, swept = swept_tables(world, s, poses, config)
    if swept.numel() == 0:
        return s
    _, body_toi = kab.swept_toi_2d(swept, tab, world.bodies.capacity)
    scale = torch.clamp(body_toi * TOI_EPS, max=1.0)
    s.state[:, 3:5] *= scale[:, None]
    return s
