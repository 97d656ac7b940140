"""Kernel AD, ``point_2d``: the 2D engine's point projections, one result per
(point, collider).

Replaces ``avian_tpu/dim2/queries.py::_point_one`` (:356, over
``avian_tpu/dim2/narrowphase.py::_closest_on_poly`` :113) as
``project_point`` (:373) and ``point_intersections`` (:400) run it on every
collider: the signed distance from the point to the collider's rounded
surface (negative inside) and the closest surface point. On a polygon the
point is projected on the core polygon's edges, and the closest point pushed
out by the radius along the distance field's gradient (the deepest face's
normal where the point sits on the core's boundary); on a half-space it is
the distance to its line.

The CUDA kernel (``csrc/point_2d.cu``, device code ``d2::point_one`` over
``d2::closest_on_poly`` in ``csrc/dim2.cuh``, which Kernel V's
circle/polygon pairs share) gives one thread to each (point, collider) and
takes P points in one launch, with the plain version's operations in its
order, so that the two agree to the bit. A thread reads about 100 bytes
and writes 12; on a box (4 vertices) it needs some 190 arithmetic
operations. The inputs are small and shared, so the 12 bytes written per
(point, collider) bound the kernel, by a little more than its operations.

The plain PyTorch version, ``point_2d_twin``, runs on CPU tensors; on a CUDA
tensor the wrapper launches the kernel or raises.
"""

import torch

from avian_tpu_torch.kernels.manifold_2d import (V, closest_on_poly, in_chunks, norm2, rotate_cs,
                                                 world_verts)


def point_2d_twin(points, pos, cs, verts, count, radius, plane):
    """Plain PyTorch version; see ``point_2d``. Runs the points in chunks
    (``manifold_2d.in_chunks``)."""
    m = pos.shape[0]
    wv = world_verts(pos, cs, verts)
    pn = rotate_cs(cs, verts[:, 0])  # a half-space's outward normal

    def chunk(pts):
        p = pts[:, None, :].expand(-1, m, -1)
        c_n = p.shape[0]
        closest, inside, n_face, face_d, _ = closest_on_poly(
            p.reshape(-1, 2), wv.repeat(c_n, 1, 1), count.repeat(c_n))
        closest, inside = closest.reshape(c_n, m, 2), inside.reshape(c_n, m)
        n_face, face_d = n_face.reshape(c_n, m, 2), face_d.reshape(c_n, m)
        out = p - closest
        dist_core = torch.where(inside, face_d, norm2(out))
        u_raw = torch.where(inside[..., None], closest - p, out)
        u_len = norm2(u_raw)
        u = torch.where((u_len > 1e-9)[..., None],
                        u_raw / torch.clamp(u_len, min=1e-9)[..., None], n_face)
        surf = closest + u * radius[:, None]
        d_plane = (p[..., 0] - pos[:, 0]) * pn[:, 0] + (p[..., 1] - pos[:, 1]) * pn[:, 1]
        return (torch.where(plane, d_plane, dist_core - radius),
                torch.where(plane[:, None], p - pn * d_plane[..., None], surf))

    return in_chunks(chunk, points, m)


def point_2d(points, pos, cs, verts, count, radius, plane):
    """``(distance f32[P, M], surface point f32[P, M, 2])`` of the P points
    ``points`` f32[P, 2] against every collider (the tables of
    ``kernels/ray_cast_2d.py::ray_cast_2d``)."""
    dev = points.device
    if dev.type == "cpu":
        return point_2d_twin(points, pos, cs, verts, count, radius, plane)
    if dev.type != "cuda":
        raise RuntimeError(f"point_2d: unsupported device {dev}")
    from avian_tpu_torch.kernels import build

    p_n, m = points.shape[0], pos.shape[0]
    f32 = torch.float32
    build.require("point_2d", dev, (
        ("points", points, (p_n, 2), f32), ("pos", pos, (m, 2), f32), ("cs", cs, (m, 2), f32),
        ("verts", verts, (m, V, 2), f32), ("count", count, (m,), torch.int32),
        ("radius", radius, (m,), f32), ("plane", plane, (m,), torch.bool),
    ))
    dist = torch.empty((p_n, m), dtype=f32, device=dev)
    surf = torch.empty((p_n, m, 2), dtype=f32, device=dev)
    if p_n * m:
        build.launch("avian_point_2d", dev, p_n, m, points, pos, cs, verts, count, radius, plane,
                     dist, surf)
        point_2d.launches += 1
    return dist, surf


point_2d.launches = 0
