"""Kernel AF, ``point_3d``: point projections, one result per (point,
collider).

Replaces ``avian_tpu/queries/point.py::_closest_local`` (:17, with
``avian_tpu/geometry/convex.py::closest_point_on_hull`` :768) as
``project_point`` (:167) and ``point_intersections`` (:198) run it on every
collider under ``vmap`` + ``jnp.select`` (every branch on every lane): the
point in the collider's frame, its signed distance to the shape (negative
inside) and the closest surface point, back in world space. Here the caller
(``queries/point.py``) buckets the colliders by shape type with one sort and
one host read and launches one instance per type for P points at once.

A pool-backed convex shape runs the reference's 16 Frank-Wolfe steps over its
own vertices, which only creep toward a point inside the hull, so the
reference reports such a point outside (ROADMAP 3b). The port adds the exact
containment test ``geometry/convex.py::hull_contains``: a point inside the
inner hull reports distance ``-radius``, closest point itself and an inside
flag, which the kernel writes beside the distance (a radius of 0 gives -0,
and ``d < 0`` alone would miss it). A point the test does not find inside
keeps the reference's Frank-Wolfe distance.

An analytic shape is some 30-80 operations on a 60-byte row, a hull 16
scans of its vertices; the results (17 bytes a pair) bound the kernel, by
bytes. The CUDA kernel (``csrc/point_3d.cu``) gives one thread to each
(point, collider), reads a hull's vertices from the pool as it needs them
(``csrc/ray_cast.cuh``'s ``closest``, which Kernel T shares) and follows
the plain version's arithmetic operation by operation (``-fmad=false``, IEEE
``sqrt`` and division, the first extremum on ties, sums in the reference's
order), so that the two agree bit for bit where the hardware rounds the
same.

The plain PyTorch version, ``point_3d_twin``, runs on CPU tensors; on a CUDA
tensor the wrapper launches the kernel or raises.
"""

import torch

from avian_tpu_torch.geometry import convex
from avian_tpu_torch.math import quat as quat_m
from avian_tpu_torch.math import vec

BIG = 1e30
SPHERE, CAPSULE, BOX, PLANE, CYLINDER, CONE, SEGMENT, MISS, CONVEX = range(9)
KINDS = (SPHERE, CAPSULE, BOX, PLANE, CYLINDER, CONE, SEGMENT, MISS, CONVEX)
FW_STEPS = 16


def _x_axis(like):
    return torch.tensor([1.0, 0.0, 0.0], device=like.device)


def _along_y(x, s):
    """The reference's ``x + [0, 1, 0] * s`` (``[0, 1, 0] * s`` alone for
    ``x`` None), its zero products kept."""
    e = torch.stack([0.0 * s, 1.0 * s, 0.0 * s], -1)
    return e if x is None else x + e


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _sphere(p, prm):
    r = prm[:, 0]
    return vec.length_rn(p) - r, vec.normalize_or_rn(p, _x_axis(p)) * r[:, None]


def _box(p, prm):
    h = prm[:, :3]
    q = _clip(p, -h, h)
    outside = vec.length_rn(p - q)
    face = h - p.abs()
    ax = convex.first_argmin(face)[:, None]
    sgn = torch.where(p.gather(1, ax)[:, 0] >= 0.0, 1.0, -1.0)
    q_in = p.scatter(1, ax, (sgn * h.gather(1, ax)[:, 0])[:, None])
    is_out = outside > 0.0
    return (torch.where(is_out, outside, -face.amin(1)),
            torch.where(is_out[:, None], q, q_in))


def _capsule(p, prm):
    hh, r = prm[:, 0], prm[:, 1]
    seg = _along_y(None, _clip(p[:, 1], -hh, hh))
    delta = p - seg
    return (vec.length_rn(delta) - r,
            seg + vec.normalize_or_rn(delta, _x_axis(p)) * r[:, None])


def _plane(p, prm):
    n = prm[:, :3]
    dist = vec.dot(p, n)
    return dist, p - n * dist[:, None]


def _radial(p):
    """(rho, unit radial direction): the (radial, y) half-plane of an axis-Y
    shape."""
    rho = vec.sqrt_rn(p[:, 0] * p[:, 0] + p[:, 2] * p[:, 2])
    xz = torch.stack([1.0 * p[:, 0], 0.0 * p[:, 1], 1.0 * p[:, 2]], 1)
    return rho, vec.normalize_or_rn(xz, _x_axis(p))


def _cylinder(p, prm):
    hh, r = prm[:, 0], prm[:, 1]
    rho, u = _radial(p)
    y = p[:, 1]
    q_out = _along_y(u * torch.minimum(rho, r)[:, None], _clip(y, -hh, hh))
    out = (rho > r) | (y.abs() > hh)
    d_side = r - rho
    d_cap = hh - y.abs()
    q_cap = torch.stack([p[:, 0], torch.where(y >= 0.0, 1.0, -1.0) * hh, p[:, 2]], 1)
    q_in = torch.where((d_side < d_cap)[:, None], _along_y(u * r[:, None], y), q_cap)
    return (torch.where(out, vec.length_rn(p - q_out), -torch.minimum(d_side, d_cap)),
            torch.where(out[:, None], q_out, q_in))


def _cone(p, prm):
    hh, r = prm[:, 0], prm[:, 1]
    rho, u = _radial(p)
    y = p[:, 1]
    zero = torch.zeros_like(rho)

    def seg2(ax, ay, bx, by):
        abx, aby = bx - ax, by - ay
        t = torch.clamp(((rho - ax) * abx + (y - ay) * aby)
                        / torch.clamp(abx * abx + aby * aby, min=1e-12), 0.0, 1.0)
        return ax + t * abx, ay + t * aby

    sx, sy = seg2(zero, hh, r, -hh)   # the slant, apex to rim
    bx, by = seg2(zero, -hh, r, -hh)  # the base, centre to rim
    l_sl = vec.sqrt_rn((rho - sx) * (rho - sx) + (y - sy) * (y - sy))
    l_ba = vec.sqrt_rn((rho - bx) * (rho - bx) + (y - by) * (y - by))
    pick = l_sl < l_ba
    d2 = torch.minimum(l_sl, l_ba)
    inside = (y >= -hh) & (y <= hh) & (rho <= r * (hh - y) / torch.clamp(2.0 * hh, min=1e-9))
    return (torch.where(inside, -d2, d2),
            _along_y(u * torch.where(pick, sx, bx)[:, None], torch.where(pick, sy, by)))


def _segment(p, prm):
    zero = torch.zeros_like(p[:, 0])
    q = torch.stack([_clip(p[:, 0], -prm[:, 0], prm[:, 0]), zero, zero], 1)
    return vec.length_rn(p - q), q


def _convex(p, prm, pool):
    """(distance, closest point, inside) of pool-backed shapes: Frank-Wolfe
    outside the inner hull, ``hull_contains`` inside it."""
    h = convex.hull_windows(prm[:, :7], pool)
    x = convex.closest_point_on_hull(h, p, FW_STEPS)
    delta = p - x
    dd = vec.length_rn(delta)
    rr = prm[:, 6]
    out = x + vec.normalize_or_rn(delta, _x_axis(p)) * rr[:, None]
    c = torch.where((dd > 1e-6)[:, None], out, p)
    inner = convex.hull_contains(h, p, x)
    d = torch.where(inner, -rr, dd - rr)
    return d, torch.where(inner[:, None], p, c), inner | (d < 0.0)


def _miss(p, prm):
    return torch.full_like(p[:, 0], BIG), p


_LOCAL = {SPHERE: _sphere, CAPSULE: _capsule, BOX: _box, PLANE: _plane, CYLINDER: _cylinder,
          CONE: _cone, SEGMENT: _segment, MISS: _miss}


def point_local(kind, p, prm, pool):
    """(distance f32[K], closest point f32[K, 3], inside bool[K]) of the
    local points ``p`` [K, 3] against K shapes of kind ``kind`` with params
    ``prm`` [K, 8]."""
    if kind == CONVEX:
        return _convex(p, prm, pool)
    d, c = _LOCAL[kind](p, prm)
    return d, c, d < 0.0


def point_3d_twin(kind, cols, points, pos, quat, params, pool, dist, closest, inside):
    """Plain PyTorch version; see ``point_3d``."""
    p_n, m = points.shape[0], dist.shape[1]
    c = cols.long().repeat(p_n)
    r = torch.arange(p_n, device=points.device).repeat_interleave(cols.shape[0])
    q = quat[c]
    d, cl, ins = point_local(kind, quat_m.rotate_inv(q, points[r] - pos[c]), params[c], pool)
    flat = r * m + c
    dist.view(-1)[flat] = d
    closest.view(-1, 3)[flat] = pos[c] + quat_m.rotate(q, cl)
    inside.view(-1)[flat] = ins
    return dist, closest, inside


def point_3d(kind, cols, points, pos, quat, params, pool, dist, closest, inside, work=None):
    """Distances, world closest points and inside flags of the P points
    ``points`` f32[P, 3] against the colliders ``cols`` (i32[K]), all of kind
    ``kind`` (their shape type; ``MISS`` for triangles and for CONVEX shapes
    in a world without a vertex pool), written into ``dist`` f32[P, M],
    ``closest`` f32[P, M, 3] and ``inside`` bool[P, M] at [point, collider].
    ``pos`` f32[M, 3], ``quat`` f32[M, 4] and ``params`` f32[M, 8] are the
    colliders', ``pool`` the vertex pool. A miss is distance ``BIG``. With
    ``work`` (i64[2], the kernel only) the launch adds the vertex rows its
    hulls' Frank-Wolfe steps scanned and those the exact containment test
    scanned: the data-dependent work of the launch."""
    if kind not in KINDS:
        raise ValueError(f"point_3d: unknown kind {kind}")
    if cols.device.type == "cpu":
        if work is not None:
            raise ValueError("point_3d: the plain version counts no work")
        return point_3d_twin(kind, cols, points, pos, quat, params, pool, dist, closest, inside)
    if cols.device.type != "cuda":
        raise RuntimeError(f"point_3d: unsupported device {cols.device}")
    from avian_tpu_torch.kernels import build

    dev, f32 = cols.device, torch.float32
    p_n, m = points.shape[0], pos.shape[0]
    build.require("point_3d", dev, [
        ("cols", cols, cols.shape, torch.int32), ("points", points, (p_n, 3), f32),
        ("pos", pos, (m, 3), f32), ("quat", quat, (m, 4), f32), ("params", params, (m, 8), f32),
        ("pool", pool, pool.shape, f32), ("dist", dist, (p_n, m), f32),
        ("closest", closest, (p_n, m, 3), f32), ("inside", inside, (p_n, m), torch.bool),
    ] + ([] if work is None else [("work", work, (2,), torch.int64)]))
    if cols.shape[0] and p_n:
        build.launch("avian_point_3d", dev, kind, cols.shape[0], p_n, m, cols, points, pos, quat,
                     params, pool, dist, closest, inside, work)
        point_3d.launches += 1
    return dist, closest, inside


point_3d.launches = 0
