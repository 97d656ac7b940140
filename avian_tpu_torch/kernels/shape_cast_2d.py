"""Kernel AE, ``shape_cast_2d``: the 2D engine's shape casts and query
manifolds, one result per collider.

Replaces ``avian_tpu/dim2/queries.py::_sweep_all`` (:500-544): the query
shape (a rounded convex polygon of at most 8 vertices, not turning) is
advanced along its cast against each collider by conservative advancement,
24 rounds (``_CAST_ITERS``) on Kernel V's manifold of the shape at
``origin + direction * t`` and the collider: each round moves t by the
separation over the approach speed, a collider is hit once its separation
falls below 1e-4, and t is capped at ``max_distance + 1``. With 0 rounds the
launch is ``_manifold_vs_all`` (:447), the manifold of the shape at its pose
against every collider, which ``shape_intersections`` and the character's
depenetration read. The manifold's normal points from the shape to the
collider.

The CUDA kernel (``csrc/shape_cast_2d.cu``, device code
``d2::shape_cast_one`` in ``csrc/dim2.cuh``) gives one thread to each
collider and calls V's device code (``d2::pair_manifold_at``) with side a
read from the query shape's own arrays, as Kernel AB calls it at poses of its
own. A collider stops once it has hit, or once t is capped past
``max_distance`` (nothing it returns can change after that); the plain
version stops the loop once every collider has, and otherwise runs every
round, so the two agree to the bit. A round is one manifold, up to some
1,500 dependent operations for a polygon pair, on about 90 bytes of the
collider's read once: bound by operations and latency.

The plain PyTorch version, ``shape_cast_2d_twin``, runs on CPU tensors; on a
CUDA tensor the wrapper launches the kernel or raises.
"""

from typing import NamedTuple

import torch

from avian_tpu_torch.kernels.manifold_2d import V, manifold_2d_twin

ROUNDS = 24  # reference ``_CAST_ITERS``
BIG = 1e30


class Cast2D(NamedTuple):
    """Each collider's result; the manifold is the last one, at ``t``."""

    t: torch.Tensor        # f32[M] advanced distance (0 with 0 rounds)
    hit: torch.Tensor      # bool[M] hit within max_distance
    point_a: torch.Tensor  # f32[M, 2] the deepest point's witness on the shape
    point_b: torch.Tensor  # f32[M, 2] and on the collider
    normal: torch.Tensor   # f32[M, 2] shape -> collider
    sep: torch.Tensor      # f32[M] least separation of the manifold
    count: torch.Tensor    # i32[M] manifold points


def shape_cast_2d_twin(query, q_verts, q_count, q_radius, pos, cs, verts, count, radius, plane,
                       rounds):
    """Plain PyTorch version; see ``shape_cast_2d``."""
    m = pos.shape[0]
    dev = pos.device
    o, q_cs, d = query[0:2], query[2:4], query[4:6]
    md, md1 = query[6], query[7]
    ca = torch.arange(m, device=dev)
    tables = (torch.cat([q_cs.expand(m, 2), cs]), torch.cat([q_verts.expand(m, V, 2), verts]),
              torch.cat([q_count.reshape(1).expand(m), count]),
              torch.cat([q_radius.reshape(1).expand(m), radius]),
              torch.cat([torch.zeros_like(plane), plane]))

    def manifold(t):
        at = o + d * t[:, None]
        return manifold_2d_twin(ca, ca + m, torch.cat([at, pos]), *tables)

    t = torch.zeros((m,), dtype=torch.float32, device=dev)
    done = torch.zeros((m,), dtype=torch.bool, device=dev)
    for _ in range(rounds):
        if not bool((~done & ~((t >= md1) & (md1 > md))).any()):
            break
        man = manifold(t)
        sep = man.separation.amin(1)
        approach = d[0] * man.normal[:, 0] + d[1] * man.normal[:, 1]
        hit_now = sep < 1e-4
        step = torch.where(approach > 1e-6, sep / torch.clamp(approach, min=1e-6), BIG)
        new_t = torch.where(done | hit_now, t, t + torch.clamp(step, min=0.0))
        t = torch.minimum(new_t, md1)
        done = done | hit_now
    man = manifold(t)
    s = man.separation
    pi = (s[:, 1] < s[:, 0]).long()[:, None, None].expand(-1, 1, 2)
    return Cast2D(t, done & (t <= md), torch.gather(man.point_a, 1, pi)[:, 0],
                  torch.gather(man.point_b, 1, pi)[:, 0], man.normal, s.amin(1), man.count)


def shape_cast_2d(query, q_verts, q_count, q_radius, pos, cs, verts, count, radius, plane,
                  rounds=ROUNDS, ran=None) -> Cast2D:
    """The query shape cast against every collider over ``rounds`` rounds
    (0: its manifold at ``origin``).

    ``query`` f32[8]: origin (2), cosine and sine of the shape's angle, unit
    direction (2), ``max_distance`` and ``max_distance + 1``; ``q_verts``
    f32[8, 2], ``q_count`` i32[] and ``q_radius`` f32[] the shape; collider
    tables as ``kernels/ray_cast_2d.py::ray_cast_2d``'s. With ``ran`` (i32[M],
    the kernel only) each collider's rounds are written too: the launch's
    data-dependent work."""
    dev = pos.device
    if dev.type == "cpu":
        if ran is not None:
            raise ValueError("shape_cast_2d: the plain version counts no rounds")
        return shape_cast_2d_twin(query, q_verts, q_count, q_radius, pos, cs, verts, count,
                                  radius, plane, rounds)
    if dev.type != "cuda":
        raise RuntimeError(f"shape_cast_2d: unsupported device {dev}")
    from avian_tpu_torch.kernels import build

    m = pos.shape[0]
    f32, i32 = torch.float32, torch.int32
    build.require("shape_cast_2d", dev, [
        ("query", query, (8,), f32), ("q_verts", q_verts, (V, 2), f32),
        ("q_count", q_count, (), i32), ("q_radius", q_radius, (), f32),
        ("pos", pos, (m, 2), f32), ("cs", cs, (m, 2), f32), ("verts", verts, (m, V, 2), f32),
        ("count", count, (m,), i32), ("radius", radius, (m,), f32),
        ("plane", plane, (m,), torch.bool),
    ] + ([] if ran is None else [("ran", ran, (m,), i32)]))
    out = Cast2D(
        t=torch.empty((m,), dtype=f32, device=dev),
        hit=torch.empty((m,), dtype=torch.bool, device=dev),
        point_a=torch.empty((m, 2), dtype=f32, device=dev),
        point_b=torch.empty((m, 2), dtype=f32, device=dev),
        normal=torch.empty((m, 2), dtype=f32, device=dev),
        sep=torch.empty((m,), dtype=f32, device=dev),
        count=torch.empty((m,), dtype=i32, device=dev),
    )
    if m:
        build.launch("avian_shape_cast_2d", dev, m, int(rounds), query, q_verts, q_count,
                     q_radius, pos, cs, verts, count, radius, plane, *out, ran)
        shape_cast_2d.launches += 1
    return out


shape_cast_2d.launches = 0
