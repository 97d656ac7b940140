"""Kernel AC, ``ray_cast_2d``: the 2D engine's ray casts, one result per
(ray, collider).

Replaces ``avian_tpu/dim2/queries.py::_ray_rounded_poly`` (:164, with
``_slab`` :143) as ``_all_ray_hits`` (:289) runs it on every collider: the
exact first hit of a ray on a rounded convex polygon or a half-space. The
offset polygon is the union of three families of convex sets, its core
polygon (3 or more vertices), one disk a vertex and one rectangle an edge
(the edge swept outward by the radius, kept at radius 0 as the thin-segment
test); the union is convex, so the ray meets it over [least entry, greatest
exit], and the entering set gives the normal. A solid shape hit from inside
returns 0 and ``-direction``; a hollow one its exit and the reference's
approximate exit normal (:232-246), kept as it is.

The CUDA kernel (``csrc/ray_cast_2d.cu``, device code
``d2::ray_rounded_poly`` and ``d2::ray_plane`` in ``csrc/dim2.cuh``) gives
one thread to each (ray, collider) and takes R rays in one launch. It
follows the plain version's operations in order (``-fmad=false``, IEEE
``sqrt`` and division, the first index among equals in every argmin and
argmax, as ``jnp.argmin``/``jnp.argmax``), so the two agree to the bit. A
thread reads about 100 bytes, writes 12 and needs some 350 arithmetic
operations on a box (4 edges, radius 0), so the kernel is bound by
operations.

The plain PyTorch version, ``ray_cast_2d_twin``, runs on CPU tensors; on a
CUDA tensor the wrapper launches the kernel or raises.
"""

import torch

from avian_tpu_torch.kernels.contact_rows import first_argmax
from avian_tpu_torch.kernels.manifold_2d import (V, dot2, first_argmin, in_chunks, normalize,
                                                 rotate_cs, world_verts)
from avian_tpu_torch.math.vec import sqrt_rn

BIG = 1e30  # the queries' miss (reference ``_BIG``)


def _take(x, k):
    """``x[..., k, :]`` for x [..., K, 2] and k [...] (broadcast to k)."""
    x = x.expand(k.shape + x.shape[-2:])
    return torch.gather(x, -2, k[..., None, None].expand(k.shape + (1, 2)))[..., 0, :]


def slab(o, d, pn, pp, valid):
    """Reference ``_slab``: (entry, exit, entering normal, not empty) of the
    region behind the K face lines ``pn`` (outward normals) through ``pp``,
    both [..., K, 2]; ``o``, ``d`` [..., 1, 2]."""
    denom = dot2(pn, d)
    num = pn[..., 0] * (pp[..., 0] - o[..., 0]) + pn[..., 1] * (pp[..., 1] - o[..., 1])
    t = num / torch.where(denom.abs() > 1e-12, denom, 1e-12)
    entering = valid & (denom < -1e-12)
    exiting = valid & (denom > 1e-12)
    parallel_out = valid & (denom.abs() <= 1e-12) & (num < 0.0)
    t_enter = torch.where(entering, t, -BIG)
    e = torch.clamp(t_enter.amax(-1), min=-BIG)
    x = torch.clamp(torch.where(exiting, t, BIG).amin(-1), max=BIG)
    ok = (e <= x + 1e-9) & ~parallel_out.any(-1) & valid.any(-1)
    return e, x, _take(pn, first_argmax(t_enter)), ok


def _ray_polys(o, d, wv, count, radius, solid):
    """``(t, n)`` [C, M] of rays ``o``, ``d`` [C, 1, 2] on the rounded
    polygons of world vertices ``wv`` [M, V, 2]."""
    lanes = torch.arange(V, device=wv.device)
    nxt = torch.where(lanes + 1 < count[:, None], lanes + 1, 0)
    v1 = torch.gather(wv, 1, nxt[..., None].expand(-1, -1, 2))
    e = v1 - wv
    elen = sqrt_rn(dot2(e, e))
    in_poly = lanes < count[:, None]
    edge_ok = in_poly & (count[:, None] >= 2) & (elen > 1e-9)
    core_valid = in_poly & (count[:, None] >= 3) & (elen > 1e-9)
    n_out = torch.stack([e[..., 1], -e[..., 0]], -1) / torch.clamp(
        sqrt_rn(e[..., 1] * e[..., 1] + e[..., 0] * e[..., 0]), min=1e-9)[..., None]
    r = radius[:, None]
    o3, d3 = o[:, :, None, :], d[:, :, None, :]

    # The core polygon (3 or more vertices).
    e_core, x_core, n_core, ok_core = slab(o3, d3, n_out, wv, core_valid)
    ok_core = ok_core & (count >= 3)

    # One disk a vertex.
    oc = o3 - wv
    b = dot2(oc, d3)
    c = (oc[..., 0] * oc[..., 0] + oc[..., 1] * oc[..., 1]) - r * r
    disc = b * b - c
    disk_ok = in_poly & (disc >= 0.0) & (r > 1e-12)
    sq = sqrt_rn(torch.clamp(disc, min=0.0))
    e_disk = -b - sq
    x_disk = -b + sq
    n_disk = normalize((o3 + d3 * e_disk[..., None]) - wv)

    # One rectangle an edge: faces n, -n (inner), -t and t (caps).
    t_hat = e / torch.clamp(elen, min=1e-9)[..., None]
    pn = torch.stack([n_out, -n_out, -t_hat, t_hat], -2)
    pp = torch.stack([wv + n_out * r[..., None], wv, wv, v1], -2)
    e_rect, x_rect, n_rect, ok_rect = slab(o3[..., None, :], d3[..., None, :], pn, pp,
                                           torch.ones_like(pn[..., 0], dtype=torch.bool))
    ok_rect = ok_rect & edge_ok

    # The union: core, disks, rectangles.
    valid = torch.cat([ok_core[..., None], disk_ok, ok_rect], -1)
    enters = torch.cat([e_core[..., None], e_disk, e_rect], -1)
    exits = torch.cat([x_core[..., None], x_disk, x_rect], -1)
    normals = torch.cat([n_core[..., None, :], n_disk, n_rect], -2)
    any_valid = valid.any(-1)
    t_in_all = torch.where(valid, enters, BIG)
    t_in = t_in_all.amin(-1)
    t_out = torch.where(valid, exits, -BIG).amax(-1)
    n_in = _take(normals, first_argmin(t_in_all))

    # The exit normal (reference :232-246, an approximation kept as it is).
    exit_pt = o + d * t_out[..., None]
    xd = torch.where(disk_ok, x_disk, -BIG)
    n_disk_exit = normalize(exit_pt - _take(wv, first_argmax(xd)))
    face_d = dot2(n_out, exit_pt[..., None, :] - wv)
    face_d = torch.where(core_valid | edge_ok, face_d, -BIG)
    n_face_exit = _take(n_out, first_argmax(face_d))
    disk_exit_wins = (xd.amax(-1) >= t_out - 1e-6) & (radius > 1e-12)
    n_exit = torch.where(disk_exit_wins[..., None], n_disk_exit, n_face_exit)

    inside = any_valid & (t_in <= 0.0) & (t_out >= 0.0)
    hit_front = any_valid & (t_in >= 0.0)
    front = torch.where(hit_front, t_in, BIG)
    if solid:
        return (torch.where(inside, 0.0, front),
                torch.where(inside[..., None], -d.expand_as(n_in), n_in))
    return (torch.where(inside, torch.where(t_out >= 0.0, t_out, BIG), front),
            torch.where(inside[..., None], n_exit, n_in))


def _ray_planes(o, d, pp, pn, solid):
    """``(t, n)`` [C, M] of rays ``o``, ``d`` [C, 1, 2] on the half-spaces
    through ``pp`` with outward normals ``pn`` [M, 2]."""
    denom = dot2(d, pn)
    o_side = (o[..., 0] - pp[:, 0]) * pn[:, 0] + (o[..., 1] - pp[:, 1]) * pn[:, 1]
    t_pl = -o_side / torch.where(denom.abs() > 1e-12, denom, 1e-12)
    inside = o_side <= 0.0
    entering = torch.where(denom < -1e-12, t_pl, BIG)
    if solid:
        return (torch.where(inside, 0.0, entering),
                torch.where(inside[..., None], -d.expand(-1, pn.shape[0], -1), pn))
    return (torch.where(inside, torch.where(denom > 1e-12, t_pl, BIG), entering),
            pn.expand(o.shape[0], -1, -1))


def ray_cast_2d_twin(rays, solid, pos, cs, verts, count, radius, plane):
    """Plain PyTorch version; see ``ray_cast_2d``. Runs the rays in chunks
    (``manifold_2d.in_chunks``)."""
    wv = world_verts(pos, cs, verts)
    pn = rotate_cs(cs, verts[:, 0])  # a half-space's outward normal

    def chunk(r):
        o, d = r[:, None, 0:2], r[:, None, 2:4]
        t_poly, n_poly = _ray_polys(o, d, wv, count, radius, solid)
        t_pl, n_pl = _ray_planes(o, d, pos, pn, solid)
        t = torch.where(plane, t_pl, t_poly)
        return torch.where(t < BIG, t, BIG), torch.where(plane[:, None], n_pl, n_poly)

    return in_chunks(chunk, rays, pos.shape[0])


def ray_cast_2d(rays, solid, pos, cs, verts, count, radius, plane):
    """``(t f32[R, M], normal f32[R, M, 2])`` of the R rays ``rays`` f32[R, 4]
    (origin, unit direction) on every collider; ``t`` is ``BIG`` on a miss.
    ``solid`` (bool): a ray that starts inside a shape hits it at 0.

    Collider tables, M rows each: ``pos`` f32[M, 2] world position, ``cs``
    f32[M, 2] cosine and sine of the world angle, ``verts`` f32[M, 8, 2] local
    vertices (a half-space's outward normal in row 0), ``count`` i32[M],
    ``radius`` f32[M], ``plane`` bool[M]."""
    dev = rays.device
    if dev.type == "cpu":
        return ray_cast_2d_twin(rays, solid, pos, cs, verts, count, radius, plane)
    if dev.type != "cuda":
        raise RuntimeError(f"ray_cast_2d: unsupported device {dev}")
    from avian_tpu_torch.kernels import build

    r_n, m = rays.shape[0], pos.shape[0]
    f32 = torch.float32
    build.require("ray_cast_2d", dev, (
        ("rays", rays, (r_n, 4), f32), ("pos", pos, (m, 2), f32), ("cs", cs, (m, 2), f32),
        ("verts", verts, (m, V, 2), f32), ("count", count, (m,), torch.int32),
        ("radius", radius, (m,), f32), ("plane", plane, (m,), torch.bool),
    ))
    t = torch.empty((r_n, m), dtype=f32, device=dev)
    n = torch.empty((r_n, m, 2), dtype=f32, device=dev)
    if r_n * m:
        build.launch("avian_ray_cast_2d", dev, r_n, m, rays, int(bool(solid)), pos, cs, verts,
                     count, radius, plane, t, n)
        ray_cast_2d.launches += 1
    return t, n


ray_cast_2d.launches = 0
