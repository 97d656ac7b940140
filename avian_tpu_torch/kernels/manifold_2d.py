"""Kernel V, ``manifold_2d``: rounded-convex-polygon pair manifolds of the 2D
engine.

Replaces ``avian_tpu/dim2/narrowphase.py::compute_manifold_2d`` (:339), the
one narrowphase function of the 2D engine: every 2D collider is a convex
polygon of at most 8 vertices plus a rounding radius, or a half-space, and a
pair gets at most 2 points. The pair kinds are plane/plane (empty), poly on
a plane (the two deepest vertices), circle/circle, circle/poly (closest point
on the core polygon, or the deepest face when the centre is inside) and
poly/poly (SAT over both polygons' edge normals with a 1e-4 bias to A,
incident-edge clipping, feature ids ``flip * 4096 + ref * 256 + inc * 16 +
k``).

The reference computes all six kinds for every pair and selects. The CUDA
kernel (``csrc/manifold_2d.cu``, device code in ``csrc/dim2.cuh``) gives one
thread to each pair and computes only the kind the pair has, with the same
operations in the same order as the plain version here, so that the two agree
to the bit: argmin and argmax take the first index among equals (as
``jnp.argmin``/``jnp.argmax`` do), the plane's two deepest vertices are the
first two of a stable sort, and every sum of two terms is written out. The
cosine and sine of each collider's angle come in as inputs (computed once per
step beside the colliders' poses), so no trigonometry differs between the
two. On the H100 a pair reads its two colliders (8 vertices, pose, radius:
about 90 bytes each) and writes 60 bytes; its work is at most an 8 x 8 SAT
per side, a few thousand operations, so the kernel is bound by operations
for polygon pairs and by bytes for the rest.

The plain PyTorch version, ``manifold_2d_twin``, runs on CPU tensors; on a
CUDA tensor the wrapper launches the kernel or raises.
"""

from typing import NamedTuple

import torch

from avian_tpu_torch.kernels.contact_rows import first_argmax
from avian_tpu_torch.math.vec import sqrt_rn

BIG = 1e9
V = 8  # vertices a collider


class Manifold2D(NamedTuple):
    normal: torch.Tensor      # f32[K, 2] world, a -> b
    point_a: torch.Tensor     # f32[K, 2, 2]
    point_b: torch.Tensor     # f32[K, 2, 2]
    separation: torch.Tensor  # f32[K, 2]
    feature_id: torch.Tensor  # i32[K, 2]
    count: torch.Tensor       # i32[K]


def first_argmin(x):
    """Index of the smallest entry along the last axis, the first among equals."""
    lanes = torch.arange(x.shape[-1], device=x.device)
    is_min = x == x.amin(dim=-1, keepdim=True)
    return torch.where(is_min, lanes, x.shape[-1] - 1).amin(dim=-1)


def _take(x, idx):
    """``x[k, idx[k]]`` for x [K, V, ...], idx [K]."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


def world_verts(pos, cs, verts):
    """World vertices [K, V, 2] of local ``verts`` under (pos, cos, sin)."""
    c, s = cs[:, 0:1], cs[:, 1:2]
    vx, vy = verts[..., 0], verts[..., 1]
    return torch.stack([pos[:, 0:1] + (c * vx - s * vy), pos[:, 1:2] + (s * vx + c * vy)], -1)


def _next(count):
    """[K, V]: the index of each vertex's successor in a polygon of ``count``."""
    idx = torch.arange(V, device=count.device)[None, :]
    return torch.where(idx + 1 < count[:, None], idx + 1, 0)


def _edge_normals(e):
    """Outward unit normals ``normalize(perp(e))``, perp(e) = (e.y, -e.x),
    with the reference's 1e-9 floor on the length."""
    ex, ey = e[..., 0], e[..., 1]
    length = torch.clamp(torch.sqrt(ey * ey + ex * ex), min=1e-9)
    return torch.stack([ey / length, -ex / length], -1)


def dot2(a, b):
    """Dot product of 2-vectors along the last axis, ``x * x' + y * y'``."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]


def normalize(v):
    """``v / max(|v|, 1e-9)`` with a correctly rounded length (reference
    ``_normalize``, ``dim2/narrowphase.py:70``)."""
    return v / torch.clamp(sqrt_rn(dot2(v, v)), min=1e-9)[..., None]


def in_chunks(fn, rows, m, chunk=1 << 16):
    """``fn`` on slices of ``rows`` [C, ...] of at most ``chunk // m`` rows
    each, so that a slice holds at most ``chunk`` (row, collider) pairs of M
    = ``m`` colliders; returns ``fn``'s outputs [C, M] and [C, M, 2], each
    concatenated over the slices."""
    step = max(1, chunk // max(m, 1))
    outs = [fn(rows[k:k + step]) for k in range(0, rows.shape[0], step)]
    if not outs:
        return rows.new_zeros((0, m)), rows.new_zeros((0, m, 2))
    return tuple(torch.cat(o) for o in zip(*outs))


def _gather_v(v, idx):
    """v [K, V, 2] at per-(k, i) vertex indices idx [K, V]."""
    return torch.gather(v, 1, idx[..., None].expand(-1, -1, 2))


def closest_on_poly(p, v, count):
    """Reference ``_closest_on_poly`` (:113) for K points p [K, 2] and
    polygons v [K, V, 2]: (closest [K, 2], inside [K], face normal [K, 2],
    face depth [K], closest edge [K])."""
    idx = torch.arange(V, device=p.device)[None, :]
    e = _gather_v(v, _next(count)) - v
    valid = (idx < count[:, None]) & (count[:, None] >= 2)
    rel = p[:, None, :] - v
    t = dot2(rel, e) / torch.clamp(dot2(e, e), min=1e-12)
    t = torch.clamp(t, 0.0, 1.0)
    proj = v + t[..., None] * e
    dp = p[:, None, :] - proj
    d2 = torch.where(valid, dot2(dp, dp), BIG)
    best = first_argmin(d2)
    n_out = _edge_normals(e)
    face_d = torch.where(valid, dot2(n_out, rel), -BIG)
    deepest = first_argmax(face_d)
    inside = torch.where(valid, face_d <= 0.0, True).all(-1) & (count >= 3)
    return (_take(proj, best), inside, _take(n_out, deepest), _take(face_d, deepest), best)


def _unit_or(d, dist, fallback):
    """``d / max(dist, 1e-9)`` where ``dist > 1e-9``, else ``fallback``."""
    return torch.where((dist > 1e-9)[:, None], d / torch.clamp(dist, min=1e-9)[:, None], fallback)


def norm2(v):
    """Length of 2-vectors ``v`` [..., 2], as ``sqrt(x * x + y * y)``."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])


def _one_point(normal, pa, pb, sep, fid):
    k = normal.shape[0]
    z = torch.zeros((k, 2), dtype=normal.dtype, device=normal.device)
    return (normal, torch.stack([pa, z], 1), torch.stack([pb, z], 1),
            torch.stack([sep, torch.full_like(sep, BIG)], 1),
            torch.stack([fid, torch.zeros_like(fid)], 1),
            torch.ones((k,), dtype=torch.int32, device=normal.device))


def _circle_circle(pa, ra, pb, rb):
    d = pb - pa
    dist = norm2(d)
    n = _unit_or(d, dist, torch.tensor([1.0, 0.0], device=d.device).expand_as(d))
    sep = dist - ra - rb
    fid = torch.zeros(d.shape[0], dtype=torch.int32, device=d.device)
    return _one_point(n, pa + n * ra[:, None], pb - n * rb[:, None], sep, fid)


def _circle_poly(pa, ra, vb, count_b, rb):
    """Circle (centre ``pa``, radius ``ra``) against the rounded polygon of
    world vertices ``vb``; the normal points from the circle to the polygon."""
    closest, inside, n_face, face_d, edge = closest_on_poly(pa, vb, count_b)
    d = closest - pa
    dist = norm2(d)
    n_out = _unit_or(d, dist, -n_face)
    n = torch.where(inside[:, None], -n_face, n_out)
    sep = torch.where(inside, face_d - ra - rb, dist - ra - rb)
    point_b = torch.where(inside[:, None], pa + n * (ra + sep)[:, None], closest - n * rb[:, None])
    return _one_point(n, pa + n * ra[:, None], point_b, sep, edge.to(torch.int32))


def _flip(m):
    normal, pa, pb, sep, fid, count = m
    return (-normal, pb, pa, sep, fid, count)


def _sat_faces(vr, count_r, vi, count_i):
    """Reference ``_sat_faces`` (:170): (separation, edge, normal) of R's face
    that separates I the most; the first edge among equals."""
    idx = torch.arange(V, device=vr.device)[None, :]
    e = _gather_v(vr, _next(count_r)) - vr
    valid = (idx < count_r[:, None]) & (count_r[:, None] >= 2)
    n = _edge_normals(e)
    rel = vi[:, None, :, :] - vr[:, :, None, :]                       # [K, E, V, 2]
    d = n[:, :, None, 0] * rel[..., 0] + n[:, :, None, 1] * rel[..., 1]
    d = torch.where((idx < count_i[:, None])[:, None, :], d, BIG)
    sep_k = torch.where(valid, d.amin(-1), -BIG)
    best = first_argmax(sep_k)
    return _take(sep_k, best), best, _take(n, best)


def _poly_poly(va, count_a, ra, vb, count_b, rb):
    sep_a, edge_a, n_a = _sat_faces(va, count_a, vb, count_b)
    sep_b, edge_b, n_b = _sat_faces(vb, count_b, va, count_a)
    flip = sep_b > sep_a + 1e-4
    f1, f2 = flip[:, None], flip[:, None, None]
    vr = torch.where(f2, vb, va)
    vi = torch.where(f2, va, vb)
    count_r = torch.where(flip, count_b, count_a)
    count_i = torch.where(flip, count_a, count_b)
    r_r = torch.where(flip, rb, ra)
    r_i = torch.where(flip, ra, rb)
    ref = torch.where(flip, edge_b, edge_a)
    n = torch.where(f1, n_b, n_a)

    idx = torch.arange(V, device=va.device)[None, :]
    n_i = _edge_normals(_gather_v(vi, _next(count_i)) - vi)
    valid_i = (idx < count_i[:, None]) & (count_i[:, None] >= 2)
    anti = torch.where(valid_i, dot2(n_i, n[:, None, :]), BIG)
    inc = first_argmin(anti)
    nxt_i = _next(count_i)
    i0 = _take(vi, inc)
    i1 = _take(vi, _take(nxt_i, inc))
    i1 = torch.where((count_i >= 2)[:, None], i1, i0)
    r0 = _take(vr, ref)
    r1 = _take(vr, _take(_next(count_r), ref))

    # Clip the incident edge to the reference edge's slab (``_clip_segment``).
    rd = r1 - r0
    tl = torch.clamp(norm2(rd), min=1e-9)
    t = rd / tl[:, None]
    length = dot2(t, rd)
    a0 = dot2(t, i0 - r0)
    a1 = dot2(t, i1 - r0)
    da = a1 - a0
    degen = torch.abs(da) <= 1e-9
    safe = torch.where(degen, 1e-9, da)
    s_at0 = (0.0 - a0) / safe
    s_atl = (length - a0) / safe
    s_min = torch.where(degen, 0.0, torch.clamp(torch.minimum(s_at0, s_atl), 0.0, 1.0))
    s_max = torch.where(degen, 1.0, torch.clamp(torch.maximum(s_at0, s_atl), 0.0, 1.0))
    di = i1 - i0
    cp0 = i0 + s_min[:, None] * di
    cp1 = i0 + s_max[:, None] * di

    def mk(cp):
        s_raw = dot2(n, cp - r0)
        s = s_raw - r_r - r_i
        p_ref = cp - n * (s_raw - r_r)[:, None]
        p_inc = cp - n * r_i[:, None]
        return s, p_ref, p_inc

    s0, pr0, pi0 = mk(cp0)
    s1, pr1, pi1 = mk(cp1)
    dc = cp1 - cp0
    dup = dot2(dc, dc) < 1e-10
    count = torch.where(dup, 1, 2).to(torch.int32)
    fid = (flip.to(torch.int32) * 4096 + ref.to(torch.int32) * 256 + inc.to(torch.int32) * 16)
    return (
        torch.where(f1, -n, n),
        torch.stack([torch.where(f1, pi0, pr0), torch.where(f1, pi1, pr1)], 1),
        torch.stack([torch.where(f1, pr0, pi0), torch.where(f1, pr1, pi1)], 1),
        torch.stack([s0, torch.where(dup, BIG, s1)], 1),
        torch.stack([fid, fid + 1], 1),
        count,
    )


def _poly_plane(v, count, radius, plane_pos, plane_n):
    """Rounded polygon of world vertices ``v`` on the half-space through
    ``plane_pos`` with outward normal ``plane_n``; normal a -> b = -plane_n."""
    idx = torch.arange(V, device=v.device)[None, :]
    rel = v - plane_pos[:, None, :]
    d = torch.where(idx < count[:, None], dot2(plane_n[:, None, :], rel) - radius[:, None], BIG)
    k0 = first_argmin(d)
    d_rest = torch.where(idx == k0[:, None], float("inf"), d)
    k1 = first_argmin(d_rest)
    n_ab = -plane_n

    def surf(k):
        vk = _take(v, k)
        pa = vk + n_ab * radius[:, None]
        pb = vk - plane_n * dot2(plane_n, vk - plane_pos)[:, None]
        return pa, pb

    pa0, pb0 = surf(k0)
    pa1, pb1 = surf(k1)
    d0, d1 = _take(d, k0), _take(d, k1)
    two = (count >= 2) & (d1 < BIG / 2)
    return (n_ab, torch.stack([pa0, pa1], 1), torch.stack([pb0, pb1], 1),
            torch.stack([d0, torch.where(two, d1, BIG)], 1),
            torch.stack([k0, k1], 1).to(torch.int32), torch.where(two, 2, 1).to(torch.int32))


def rotate_cs(cs, v):
    """``v`` [K, 2] turned by the angles of cosines and sines ``cs`` [K, 2]."""
    c, s = cs[:, 0], cs[:, 1]
    return torch.stack([c * v[:, 0] - s * v[:, 1], s * v[:, 0] + c * v[:, 1]], -1)


def manifold_2d_twin(ca, cb, pos, cs, verts, count, radius, plane) -> Manifold2D:
    """Plain PyTorch version; see ``manifold_2d``."""
    ca, cb = ca.long(), cb.long()
    pa, pb, csa, csb = pos[ca], pos[cb], cs[ca], cs[cb]
    la, lb = verts[ca], verts[cb]
    na, nb, ra, rb = count[ca], count[cb], radius[ca], radius[cb]
    pla, plb = plane[ca], plane[cb]
    va, vb = world_verts(pa, csa, la), world_verts(pb, csb, lb)
    # A 1-vertex polygon is a circle, centred on its (possibly offset) vertex;
    # a plane's local normal is its vertex 0.
    ctr_a, ctr_b = va[:, 0], vb[:, 0]
    nrm_a, nrm_b = rotate_cs(csa, la[:, 0]), rotate_cs(csb, lb[:, 0])
    circ_a = (na == 1) & ~pla
    circ_b = (nb == 1) & ~plb
    both_poly = ~pla & ~plb

    k = ca.shape[0]
    dev = pos.device
    empty = (
        torch.tensor([0.0, 1.0], device=dev).expand(k, 2),
        torch.zeros((k, 2, 2), device=dev), torch.zeros((k, 2, 2), device=dev),
        torch.full((k, 2), BIG, device=dev),
        torch.zeros((k, 2), dtype=torch.int32, device=dev),
        torch.zeros((k,), dtype=torch.int32, device=dev),
    )
    kinds = [
        (pla & plb, empty),
        (plb, _poly_plane(va, na, ra, pb, nrm_b)),
        (pla, _flip(_poly_plane(vb, nb, rb, pa, nrm_a))),
        (both_poly & circ_a & circ_b, _circle_circle(ctr_a, ra, ctr_b, rb)),
        (both_poly & circ_a, _circle_poly(ctr_a, ra, vb, nb, rb)),
        (both_poly & circ_b, _flip(_circle_poly(ctr_b, rb, va, na, ra))),
    ]
    out = list(_poly_poly(va, na, ra, vb, nb, rb))
    for cond, m in reversed(kinds):
        out = [torch.where(cond.reshape((k,) + (1,) * (x.dim() - 1)), x, y)
               for x, y in zip(m, out)]
    return Manifold2D(*(x.contiguous() for x in out))


def manifold_2d(ca, cb, pos, cs, verts, count, radius, plane) -> Manifold2D:
    """Manifolds of the K collider pairs ``(ca[k], cb[k])`` (i64[K]).

    Collider tables, M rows each: ``pos`` f32[M, 2] world position, ``cs``
    f32[M, 2] cosine and sine of the world angle, ``verts`` f32[M, 8, 2] local
    vertices (a plane's outward normal in row 0), ``count`` i32[M] vertices,
    ``radius`` f32[M] rounding radius, ``plane`` bool[M] half-space."""
    dev = pos.device
    if dev.type == "cpu":
        return manifold_2d_twin(ca, cb, pos, cs, verts, count, radius, plane)
    if dev.type != "cuda":
        raise RuntimeError(f"manifold_2d: unsupported device {dev}")
    from avian_tpu_torch.kernels import build

    k, m = ca.shape[0], pos.shape[0]
    f32, i32 = torch.float32, torch.int32
    build.require("manifold_2d", dev, (
        ("ca", ca, (k,), torch.int64), ("cb", cb, (k,), torch.int64),
        ("pos", pos, (m, 2), f32), ("cs", cs, (m, 2), f32), ("verts", verts, (m, V, 2), f32),
        ("count", count, (m,), i32), ("radius", radius, (m,), f32),
        ("plane", plane, (m,), torch.bool),
    ))
    out = Manifold2D(
        normal=torch.empty((k, 2), dtype=f32, device=dev),
        point_a=torch.empty((k, 2, 2), dtype=f32, device=dev),
        point_b=torch.empty((k, 2, 2), dtype=f32, device=dev),
        separation=torch.empty((k, 2), dtype=f32, device=dev),
        feature_id=torch.empty((k, 2), dtype=i32, device=dev),
        count=torch.empty((k,), dtype=i32, device=dev),
    )
    if k:
        build.launch("avian_manifold_2d", dev, k, ca, cb, pos, cs, verts, count, radius, plane,
                     *out)
        manifold_2d.launches += 1
    return out


manifold_2d.launches = 0
