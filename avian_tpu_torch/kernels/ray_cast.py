"""Kernel T, ``ray_cast``: ray distances and normals, one per (ray,
collider).

Replaces ``avian_tpu/queries/raycast.py::_ray_one_collider`` (:372) with
the per-shape tests ``_ray_sphere`` (:51), ``_ray_box`` (:68), ``_ray_plane``
(:90), ``_ray_capsule`` (:103), ``_ray_cylinder`` (:138), ``_ray_cone`` (:179),
``_ray_convex`` (:231) and ``_ray_miss`` (:320), which the reference runs on
every collider under ``vmap`` + ``lax.switch`` (every branch on every lane).
Here the caller (``queries/raycast.py``) buckets the colliders by shape type
and launches one instance per type, for R rays at once.

An analytic shape is a few dozen operations on 60 bytes in and 16 out, bound
by bytes; a pool-backed convex shape is sphere tracing on its support map (24
marches of 12 Frank-Wolfe steps over up to 32 vertices) and a face fit, some
60,000 dependent operations, bound by operations. The CUDA kernel
(``csrc/ray_cast.cu``) gives one thread to each (ray, collider), reads a
hull's vertices from the pool as it needs them and follows the plain
version's arithmetic operation by operation (``-fmad=false``, IEEE ``sqrt``
and division, the first maximum on ties, the vertex sums from row 0 upward
as XLA:CPU sums them), so the two agree bit for bit where the hardware
rounds the same.

The plain PyTorch version, ``ray_cast_twin``, runs on CPU tensors; on a CUDA
tensor the wrapper launches the kernel or raises.
"""

import torch

from avian_tpu_torch.geometry import convex
from avian_tpu_torch.kernels.contact_rows import first_argmax
from avian_tpu_torch.math import quat as quat_m
from avian_tpu_torch.math import vec

BIG = 1e30
SPHERE, CAPSULE, BOX, PLANE, CYLINDER, CONE, MISS, CONVEX = 0, 1, 2, 3, 4, 5, 6, 8
KINDS = (SPHERE, CAPSULE, BOX, PLANE, CYLINDER, CONE, MISS, CONVEX)
MARCHES, FW_STEPS = 24, 12


def _v(x, y, z):
    return torch.stack([x, y, z], -1)


def _sel(mask, a, b):
    return torch.where(mask[:, None], a, b)


def _sphere(o, d, r, solid):
    b = vec.dot(o, d)
    c = vec.dot(o, o) - r * r
    disc = b * b - c
    sq = vec.sqrt_rn(torch.clamp(disc, min=0.0))
    t0 = -b - sq
    t1 = -b + sq
    inside = c < 0.0
    t = torch.where(disc < 0.0, BIG, torch.where(t0 >= 0.0, t0, torch.where(t1 >= 0.0, t1, BIG)))
    t = torch.where(inside & solid, 0.0, t)
    n = vec.normalize_or_rn(o + d * t[:, None], -d)
    return t, _sel(inside & solid, -d, n)


def _box(o, d, prm, solid):
    h = prm[:, :3]
    den = torch.where(d.abs() > 1e-12, d, torch.where(d >= 0.0, 1e-12, -1e-12))
    inv = 1.0 / den
    t1 = (-h - o) * inv
    t2 = (h - o) * inv
    tmin3 = torch.minimum(t1, t2)
    tmax3 = torch.maximum(t1, t2)
    tmin = tmin3.amax(1)
    tmax = tmax3.amin(1)
    hit = tmax >= torch.clamp(tmin, min=0.0)
    inside = (tmin < 0.0) & (tmax > 0.0)
    t = torch.where(hit, torch.where(inside, torch.where(solid, 0.0, tmax), tmin), BIG)
    exiting = inside & ~solid
    t_face = torch.where(exiting, tmax, tmin)
    which = _sel(exiting, tmax3, tmin3)
    ax = first_argmax(torch.where(which == t_face[:, None], 1.0, 0.0))
    p = o + d * t[:, None]
    sign = torch.where(p.gather(1, ax[:, None])[:, 0] >= 0.0, 1.0, -1.0)
    n = torch.zeros_like(o).scatter(1, ax[:, None], sign[:, None])
    return t, _sel(inside & solid, -d, n)


def _plane(o, d, prm, solid):
    n = prm[:, :3]
    denom = vec.dot(d, n)
    dist = vec.dot(o, n)
    t = torch.where(denom.abs() > 1e-12, -dist / denom, BIG)
    t = torch.where(t >= 0.0, t, BIG)
    below = dist < 0.0
    t = torch.where(below & solid, 0.0, t)
    nr = _sel(below, -n, n)
    return t, _sel(below & solid, -d, nr)


def _side_root(o, d, r):
    zero = torch.zeros_like(o[:, 0])
    oxz, dxz = _v(o[:, 0], zero, o[:, 2]), _v(d[:, 0], zero, d[:, 2])
    a = vec.dot(dxz, dxz)
    b = vec.dot(oxz, dxz)
    c = vec.dot(oxz, oxz) - r * r
    disc = b * b - a * c
    sq = vec.sqrt_rn(torch.clamp(disc, min=0.0))
    return torch.where((disc >= 0.0) & (a > 1e-12), (-b - sq) / torch.clamp(a, min=1e-12), BIG)


def _rim_normal(p, d):
    return vec.normalize_or_rn(_v(p[:, 0], torch.zeros_like(p[:, 0]), p[:, 2]), -d)


def _capsule(o, d, prm, solid):
    hh, r = prm[:, 0], prm[:, 1]
    t_cyl = _side_root(o, d, r)
    y_at = o[:, 1] + d[:, 1] * t_cyl
    t_cyl = torch.where((t_cyl >= 0.0) & (y_at.abs() <= hh), t_cyl, BIG)
    up = torch.tensor([0.0, 1.0, 0.0], device=o.device)
    t_top, n_top = _sphere(o - up * hh[:, None], d, r, solid)
    t_bot, n_bot = _sphere(o + up * hh[:, None], d, r, solid)
    t = torch.minimum(t_cyl, torch.minimum(t_top, t_bot))
    n_cyl = _rim_normal(o + d * t[:, None], d)
    n = _sel(t == t_cyl, n_cyl, _sel(t == t_top, n_top, n_bot))
    ty = torch.minimum(torch.maximum(o[:, 1], -hh), hh)
    inside = vec.length_sq(o - up * ty[:, None]) < r * r
    return torch.where(inside & solid, 0.0, t), _sel(inside & solid, -d, n)


def _cyl_cap(o, d, hh, r, sy):
    denom = d[:, 1]
    t = torch.where(denom.abs() > 1e-12, (sy * hh - o[:, 1]) / denom, BIG)
    p = o + d * t[:, None]
    ok = (t >= 0.0) & (p[:, 0] * p[:, 0] + p[:, 2] * p[:, 2] <= r * r)
    return torch.where(ok, t, BIG)


def _cylinder(o, d, prm, solid):
    hh, r = prm[:, 0], prm[:, 1]
    t_side = _side_root(o, d, r)
    y_at = o[:, 1] + d[:, 1] * t_side
    t_side = torch.where((t_side >= 0.0) & (y_at.abs() <= hh), t_side, BIG)
    t_top = _cyl_cap(o, d, hh, r, 1.0)
    t_bot = _cyl_cap(o, d, hh, r, -1.0)
    t = torch.minimum(t_side, torch.minimum(t_top, t_bot))
    n_side = _rim_normal(o + d * t[:, None], d)
    s = torch.where(t == t_top, 1.0, -1.0)
    n = _sel(t == t_side, n_side, _v(0.0 * s, 1.0 * s, 0.0 * s))
    inside = (o[:, 1].abs() <= hh) & (o[:, 0] * o[:, 0] + o[:, 2] * o[:, 2] < r * r)
    return torch.where(inside & solid, 0.0, t), _sel(inside & solid, -d, n)


def _cone(o, d, prm, solid):
    hh, r = prm[:, 0], prm[:, 1]
    k = r / (2.0 * hh)
    kk = k * k
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    a = (dx * dx + dz * dz) - kk * dy * dy
    b = 2.0 * (ox * dx + oz * dz) + 2.0 * k * k * dy * (hh - oy)
    hy = hh - oy
    c = (ox * ox + oz * oz) - kk * (hy * hy)
    disc = b * b - 4.0 * a * c
    sq = vec.sqrt_rn(torch.clamp(disc, min=0.0))
    safe_a = torch.where(a.abs() > 1e-12, a, 1e-12)
    t0 = (-b - sq) / (2.0 * safe_a)
    t1 = (-b + sq) / (2.0 * safe_a)
    b_ok = b.abs() > 1e-12
    t_lin = torch.where(b_ok, -c / torch.where(b_ok, b, 1.0), BIG)
    use_lin = a.abs() <= 1e-12

    def side_ok(t):
        y = oy + dy * t
        return (disc >= 0.0) & (t >= 0.0) & (y >= -hh) & (y <= hh)

    t0 = torch.where(~use_lin & side_ok(t0), t0, BIG)
    t1 = torch.where(~use_lin & side_ok(t1), t1, BIG)
    y_lin = oy + dy * t_lin
    t_lin = torch.where(use_lin & (t_lin >= 0.0) & (y_lin >= -hh) & (y_lin <= hh), t_lin, BIG)
    t_side = torch.minimum(torch.minimum(t0, t1), t_lin)
    t_base = torch.where(dy.abs() > 1e-12, (-hh - oy) / dy, BIG)
    pb = o + d * t_base[:, None]
    t_base = torch.where((t_base >= 0.0) & (pb[:, 0] * pb[:, 0] + pb[:, 2] * pb[:, 2] <= r * r),
                         t_base, BIG)
    t = torch.minimum(t_side, t_base)
    p = o + d * t[:, None]
    n_side = vec.normalize_or_rn(_v(p[:, 0], kk * (hh - p[:, 1]), p[:, 2]), -d)
    down = torch.tensor([0.0, -1.0, 0.0], device=o.device).expand_as(o)
    n = _sel(t == t_side, n_side, down)
    r_at = k * (hh - oy)
    inside = (oy >= -hh) & (oy <= hh) & (ox * ox + oz * oz < r_at * r_at)
    return torch.where(inside & solid, 0.0, t), _sel(inside & solid, -d, n)


def _rows(x, idx):
    return x.gather(1, idx[:, None, None].expand(-1, 1, 3))[:, 0]


def _seq_sum(x, mask, fill):
    """sum_j where(mask[:, j], x[:, j], fill) over the 32 rows of x [P, 32, 3],
    from row 0 upward (XLA:CPU's order)."""
    acc = torch.zeros_like(x[:, 0])
    for j in range(x.shape[1]):
        acc = acc + torch.where(mask[:, j, None], x[:, j], fill)
    return acc


def _convex(o, d, prm, solid, pool):
    h = convex.hull_windows(prm[:, :7], pool)
    verts, valid = h.verts, h.valid
    rr = prm[:, 6]

    def sigma(u):
        return torch.where(valid, vec.dot(verts, u[:, None, :]), -1e30).amax(1)

    def closest(p):
        return convex.closest_point_on_hull(h, p, FW_STEPS)

    t = torch.zeros_like(o[:, 0])
    done = torch.zeros_like(t, dtype=torch.bool)
    n = -d
    for _ in range(MARCHES):
        p = o + d * t[:, None]
        u = vec.normalize_or_rn(p - closest(p), -d)
        lb = (vec.dot(u, p) - sigma(u)) - rr
        hit = lb < 1e-4
        t_new = torch.where(done | hit, t, t + torch.clamp(lb, min=1e-5))
        n = _sel(done, n, u)
        t = torch.clamp(t_new, max=1e6)
        done = done | hit
    # Fit the face plane from the support ring along n.
    size = torch.clamp(prm[:, 2:5].amax(1), min=1e-3)
    dots_n = torch.where(valid, vec.dot(verts, n[:, None, :]), -1e30)
    near = valid & (dots_n > (dots_n.amax(1) - 0.35 * size)[:, None])
    k_near = near.sum(1)
    c_near = _seq_sum(verts, near, 0.0) / torch.clamp(k_near.to(torch.float32), min=1.0)[:, None]
    rel = torch.where(near[..., None], verts - c_near[:, None, :], 0.0)
    ra = _rows(rel, first_argmax(vec.dot(rel, rel)))
    cr = vec.cross(ra[:, None, :], rel)
    rb = _rows(rel, first_argmax(vec.dot(cr, cr)))
    nf = vec.normalize_or_rn(vec.cross(ra, rb), n)
    nf = nf * torch.sign(vec.dot(nf, n) + 1e-12)[:, None]
    n = _sel(k_near >= 3, nf, n)
    dn = vec.dot(d, n)
    t_ref = ((sigma(n) + rr) - vec.dot(n, o)) / torch.where(dn.abs() > 1e-9, dn, 1e-9)
    t = torch.where((dn.abs() > 1e-6) & ((t_ref - t).abs() < 0.1) & (t_ref >= 0.0), t_ref, t)
    t = torch.where(done, t, BIG)
    inside = vec.length_rn(closest(o) - o) < rr + 1e-6
    return torch.where(inside & solid, 0.0, t), _sel(inside & solid, -d, n)


def _miss(o, d, prm, solid):
    return torch.full_like(o[:, 0], BIG), -d


def ray_local(kind, o, d, prm, solid, pool):
    """``(t f32[K], normal f32[K, 3])`` of K rays ``o``, ``d`` [K, 3] in the
    frames of K colliders of ray kind ``kind`` with params ``prm`` [K, 8];
    ``solid`` a bool tensor (one flag, or one a ray)."""
    if kind == CONVEX:
        return _convex(o, d, prm, solid, pool)
    fn = {SPHERE: lambda *a: _sphere(a[0], a[1], a[2][:, 0], a[3]), CAPSULE: _capsule,
          BOX: _box, PLANE: _plane, CYLINDER: _cylinder, CONE: _cone, MISS: _miss}[kind]
    return fn(o, d, prm, solid)


def ray_cast_twin(kind, cols, rays, solid, pos, quat, params, pool, t_out, n_out):
    """Plain PyTorch version; see ``ray_cast``."""
    solid = torch.tensor(bool(solid), device=rays.device)
    r_n, m = rays.shape[0], t_out.shape[1]
    c = cols.long().repeat(r_n)
    r = torch.arange(r_n, device=rays.device).repeat_interleave(cols.shape[0])
    q = quat[c]
    t, n = ray_local(kind, quat_m.rotate_inv(q, rays[r, :3] - pos[c]),
                     quat_m.rotate_inv(q, rays[r, 3:]), params[c], solid, pool)
    t_out.view(-1)[r * m + c] = t
    n_out.view(-1, 3)[r * m + c] = quat_m.rotate(q, n)
    return t_out, n_out


def ray_cast(kind, cols, rays, solid, pos, quat, params, pool, t_out, n_out):
    """Distances and world normals of R rays against the colliders ``cols``
    (i32[K]), all of ray kind ``kind`` (their shape type; ``MISS`` for the
    shapes a ray misses), written into ``t_out`` f32[R, M] and ``n_out``
    f32[R, M, 3] at [ray, collider]. ``rays`` f32[R, 6] holds each ray's
    origin and unit direction; ``solid`` a Python bool; ``pos`` f32[M, 3],
    ``quat`` f32[M, 4] and ``params`` f32[M, 8] the colliders', ``pool`` the
    vertex pool. A miss is distance ``BIG``."""
    if kind not in KINDS:
        raise ValueError(f"ray_cast: unknown kind {kind}")
    if cols.device.type == "cpu":
        return ray_cast_twin(kind, cols, rays, solid, pos, quat, params, pool, t_out, n_out)
    if cols.device.type != "cuda":
        raise RuntimeError(f"ray_cast: unsupported device {cols.device}")
    from avian_tpu_torch.kernels import build

    dev, f32 = cols.device, torch.float32
    r_n, m = rays.shape[0], pos.shape[0]
    build.require("ray_cast", dev, [
        ("cols", cols, cols.shape, torch.int32), ("rays", rays, (r_n, 6), f32),
        ("pos", pos, (m, 3), f32), ("quat", quat, (m, 4), f32), ("params", params, (m, 8), f32),
        ("pool", pool, pool.shape, f32), ("t_out", t_out, (r_n, m), f32),
        ("n_out", n_out, (r_n, m, 3), f32),
    ])
    if cols.shape[0] and r_n:
        build.launch("avian_ray_cast", dev, kind, cols.shape[0], r_n, m, cols, rays, int(solid),
                     pos, quat, params, pool, t_out, n_out)
        ray_cast.launches += 1
    return t_out, n_out


ray_cast.launches = 0
