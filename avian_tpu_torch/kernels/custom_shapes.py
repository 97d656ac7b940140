"""The kernels of user shapes (``api/custom_shapes.py``): Kernel E's custom
pass, the custom instances of Kernels M, O, P and AF, and Kernel AJ.

A custom shape's support, AABB and patch are device functions compiled from
the shape's ``cuda`` source into the generated units of
``kernels/custom_build.py``; the kernels are templates on the shape code
(``csrc/custom_shape.cuh``), one thread a collider, pair, (ray, collider) or
(point, collider):

- ``custom_aabbs``, Kernel E's custom pass, replaces the custom branch of
  ``avian_tpu/geometry/shapes.py::local_aabb_half_extents`` (:55-67) inside
  ``pipeline/broadphase.py::update_aabbs`` (:96): it writes the custom
  colliders' AABBs over E's rows before the cell keys are emitted. Bound by
  bytes, about 150 a collider.
- ``custom_convex_manifold`` (M), ``custom_hull_manifold`` (P) and
  ``custom_plane_manifold`` (O) replace ``geometry/convex.py``'s
  ``generic_convex_pair`` (:468), ``generic_convex_pair_aux`` (:881) and
  ``support_patch_plane_pair`` (:702) as ``geometry/narrowphase.py::
  _custom_entries`` (:407-449) routes a custom shape's pairs: M against
  every built-in support shape and every custom shape ``j <= i``, P against
  a pool-backed convex shape, O against a half-space. Some 100 support calls
  a pair, bound by operations and latency, as M and P are.
- ``ray_support``, Kernel AJ, replaces ``queries/raycast.py::_ray_support``
  (:324) in the custom branch of ``_ray_one_collider`` (:372-420): at most
  24 marches of 13 support calls plus 13, bound by operations; a thread
  stops at its hit and can count its support calls.
- ``custom_point``, Kernel AF's custom instance, replaces the custom branch
  of ``queries/point.py::_closest_local`` (:135-162): 24 Frank-Wolfe and 20
  subgradient steps on the support map, 47 support calls, bound by
  operations.

Each wrapper takes the world's ``CustomShape`` tuple ``shapes``. The plain
PyTorch versions (``*_twin``) run the shapes' torch functions and run on CPU
tensors; on a CUDA tensor a wrapper launches its kernel or raises, naming a
shape without a CUDA source or a build that failed.
"""

import torch

from avian_tpu_torch.core.types import CUSTOM_SHAPE_BASE, ShapeType
from avian_tpu_torch.geometry import convex
from avian_tpu_torch.kernels import ray_cast as kt
from avian_tpu_torch.math import quat as quat_m
from avian_tpu_torch.math import vec

PARAM_LANES = 7
MARCHES, FW_STEPS = kt.MARCHES, kt.FW_STEPS
BIG = kt.BIG
# Support calls a pair of M, O and P makes on each side (Frank-Wolfe 1 + 24,
# depth 1 + 20, two patches and the degenerate witnesses), and a (point,
# collider) of AF: the operations their bounds count.
PAIR_SUPPORT_CALLS = 50
POINT_SUPPORT_CALLS = 47


def _shape(shapes, code):
    return shapes[int(code) - CUSTOM_SHAPE_BASE]


def _cuda(what, shapes, dev):
    """The generated library of ``shapes`` for a launch on ``dev``."""
    if dev.type != "cuda":
        raise RuntimeError(f"{what}: unsupported device {dev}")
    from avian_tpu_torch.kernels import custom_build

    return custom_build.library(shapes)


# ---- Kernel E's custom pass ----------------------------------------------------------

def custom_aabbs_twin(shapes, code, cols, bodies, col, pos, quat, dt, spec_default, tol,
                      lo, hi):
    """Plain PyTorch version; see ``custom_aabbs``."""
    c = cols.long()
    h = _shape(shapes, code).aabb_half_extents(col.params[c, :PARAM_LANES])
    wh = vec.mv3(torch.abs(quat_m.to_mat3(quat[c])), h)
    speed = vec.length(bodies.lin_vel[col.body_idx[c].long()])
    spec = torch.clamp(col.speculative_margin[c], max=spec_default)
    e = (torch.minimum(speed * dt, spec) + col.collision_margin[c] + tol)[:, None]
    lo[c] = (pos[c] - wh) - e
    hi[c] = (pos[c] + wh) + e
    return lo, hi


def custom_aabbs(shapes, code, cols, bodies, col, pos, quat, dt, spec_default, tol, lo, hi):
    """Overwrite the AABB rows ``lo``/``hi`` f32[M, 3] of the colliders
    ``cols`` (i32[K]), all of custom code ``code``, with the shape's
    ``aabb_half_extents`` rotated by ``|R|`` of the collider pose ``pos``,
    ``quat`` and expanded as Kernel E expands (``dt``, the default
    speculative margin, the tolerance)."""
    if cols.device.type == "cpu":
        return custom_aabbs_twin(shapes, code, cols, bodies, col, pos, quat, dt, spec_default,
                                 tol, lo, hi)
    lib = _cuda("custom_aabbs", shapes, cols.device)
    if cols.shape[0]:
        lib.launch("avian_custom_aabbs", cols.device, int(code), cols.shape[0], cols,
                   col.body_idx, col.params, col.speculative_margin, col.collision_margin,
                   bodies.lin_vel, pos, quat, float(dt), float(spec_default), float(tol), lo, hi)
        custom_aabbs.launches += 1
    return lo, hi


custom_aabbs.launches = 0


# ---- the custom instances of Kernels M, P and O ------------------------------------

def manifold_twin(shapes, pair, pa, qa, prm_a, pb, qb, prm_b, pool):
    """The plain version of a custom pair's kernel on K pairs of canonical
    ``pair`` = (type_a, type_b), ``type_b`` custom, params [K, 7]."""
    ta, tb = pair
    if ta == int(ShapeType.PLANE):
        return convex.plane_patch_manifold(tb, pa, qa, prm_a[:, :3], pb, qb, prm_b, pool, shapes)
    return convex.generic_manifold(ta, tb, pa, qa, prm_a, pb, qb, prm_b, pool, shapes)


def _manifold(wrapper, kind, pa, qa, prm_a, pb, qb, prm_b, pool):
    """The body of the three custom pair wrappers: the plain version on CPU
    tensors, else the pair's instance in the generated library, a launch
    counted on ``wrapper``."""
    if pa.device.type == "cpu":
        return _pair_twin(kind, pa, qa, prm_a, pb, qb, prm_b, pool)
    shapes, pair = kind
    lib = _cuda(wrapper.__name__, shapes, pa.device)
    from avian_tpu_torch.kernels.convex_manifold import _disc_table

    out = lib.launch_manifold(pair, (pa, qa, prm_a, pb, qb, prm_b), _disc_table(pa.device), pool)
    if pa.shape[0]:
        wrapper.launches += 1
    return out


def custom_convex_manifold(kind, pa, qa, prm_a, pb, qb, prm_b, pool):
    """Kernel M's custom instances: manifolds of K pairs of ``kind`` =
    (shapes, (type_a, type_b)), A a built-in support shape or a custom
    shape, B custom. Inputs f32 [K, 3] / [K, 4], params [K, 7]. Same returns
    as ``convex_manifold``."""
    return _manifold(custom_convex_manifold, kind, pa, qa, prm_a, pb, qb, prm_b, pool)


def custom_hull_manifold(kind, pa, qa, prm_a, pb, qb, prm_b, pool):
    """Kernel P's custom instances: A a pool-backed convex shape, B custom."""
    return _manifold(custom_hull_manifold, kind, pa, qa, prm_a, pb, qb, prm_b, pool)


def custom_plane_manifold(kind, pa, qa, prm_a, pb, qb, prm_b, pool):
    """Kernel O's custom instances: A a half-space (its local normal in the
    first three lanes), B custom."""
    return _manifold(custom_plane_manifold, kind, pa, qa, prm_a, pb, qb, prm_b, pool)


def _pair_twin(kind, pa, qa, prm_a, pb, qb, prm_b, pool):
    """Plain version of the three custom pair wrappers (``kind`` = (shapes,
    pair))."""
    return manifold_twin(kind[0], kind[1], pa, qa, prm_a, pb, qb, prm_b, pool)


custom_convex_manifold_twin = custom_hull_manifold_twin = custom_plane_manifold_twin = _pair_twin
custom_convex_manifold.launches = 0
custom_hull_manifold.launches = 0
custom_plane_manifold.launches = 0


# ---- Kernel AJ -----------------------------------------------------------------------

def ray_support_local(shape, o, d, prm, solid):
    """``(t f32[K], normal f32[K, 3])`` of K rays ``o``, ``d`` [K, 3] in the
    frames of K colliders of custom shape ``shape`` with params ``prm`` [K,
    >= 7] (reference ``_ray_support``); ``solid`` a bool tensor."""
    prm = prm[:, :PARAM_LANES]
    sup = shape.support

    def closest(p):
        x = sup(prm, d)
        for _ in range(FW_STEPS):
            g = x - p
            dxs = x - sup(prm, -g)
            gamma = torch.clamp(vec.dot(g, dxs) / torch.clamp(vec.dot(dxs, dxs), min=1e-12),
                                0.0, 1.0)
            x = x - gamma[:, None] * dxs
        return x

    t = torch.zeros_like(o[:, 0])
    done = torch.zeros_like(t, dtype=torch.bool)
    n = -d
    for _ in range(MARCHES):
        p = o + d * t[:, None]
        u = vec.normalize_or_rn(p - closest(p), -d)
        lb = vec.dot(u, p) - vec.dot(sup(prm, u), u)
        hit = lb < 1e-4
        t_new = torch.where(done | hit, t, t + torch.clamp(lb, min=1e-5))
        n = torch.where(done[:, None], n, u)
        t = torch.clamp(t_new, max=1e6)
        done = done | hit
    t = torch.where(done, t, BIG)
    inside = (vec.length_rn(closest(o) - o) < 1e-6) & solid
    return torch.where(inside, 0.0, t), torch.where(inside[:, None], -d, n)


def ray_support_twin(shapes, code, cols, rays, solid, pos, quat, params, t_out, n_out):
    """Plain PyTorch version; see ``ray_support``."""
    solid = torch.tensor(bool(solid), device=rays.device)
    r_n, m = rays.shape[0], t_out.shape[1]
    c = cols.long().repeat(r_n)
    r = torch.arange(r_n, device=rays.device).repeat_interleave(cols.shape[0])
    q = quat[c]
    t, n = ray_support_local(_shape(shapes, code), quat_m.rotate_inv(q, rays[r, :3] - pos[c]),
                             quat_m.rotate_inv(q, rays[r, 3:]), params[c], solid)
    t_out.view(-1)[r * m + c] = t
    n_out.view(-1, 3)[r * m + c] = quat_m.rotate(q, n)
    return t_out, n_out


def ray_support(shapes, code, cols, rays, solid, pos, quat, params, t_out, n_out, work=None):
    """Kernel AJ: distances and world normals of R rays ``rays`` f32[R, 6]
    (origin, unit direction) against the colliders ``cols`` (i32[K]), all of
    custom code ``code``, written into ``t_out`` f32[R, M] and ``n_out``
    f32[R, M, 3] at [ray, collider], as Kernel T writes its buckets. A miss
    is ``BIG``. With ``work`` (i64[1], the kernel only) the launch adds the
    support calls it made."""
    if cols.device.type == "cpu":
        if work is not None:
            raise ValueError("ray_support: the plain version counts no work")
        return ray_support_twin(shapes, code, cols, rays, solid, pos, quat, params, t_out, n_out)
    lib = _cuda("ray_support", shapes, cols.device)
    if cols.shape[0] and rays.shape[0]:
        lib.launch("avian_ray_support", cols.device, int(code), cols.shape[0], rays.shape[0],
                   pos.shape[0], cols, rays, int(solid), pos, quat, params, t_out, n_out, work)
        ray_support.launches += 1
    return t_out, n_out


ray_support.launches = 0


# ---- Kernel AF's custom instance ------------------------------------------------------

def point_local(shape, p, prm):
    """(distance f32[K], closest point f32[K, 3], inside bool[K]) of the
    local points ``p`` [K, 3] against K shapes of custom shape ``shape``
    (reference ``_closest_local``'s custom branch)."""
    prm = prm[:, :PARAM_LANES]

    def sk(u):
        return shape.support(prm, u) - p

    x_axis = torch.zeros_like(p)
    x_axis[:, 0] = 1.0
    x = convex._fw_distance(sk, sk(x_axis))
    dist = vec.length_rn(x)
    y_axis = torch.zeros_like(p)
    y_axis[:, 1] = 1.0
    u_pen, depth = convex._depth_direction(sk, vec.normalize_or_rn(-x, y_axis))
    inside = dist < 1e-5
    d = torch.where(inside, -depth, dist)
    c = torch.where(inside[:, None], p + u_pen * depth[:, None], p + x)
    return d, c, d < 0.0


def custom_point_twin(shapes, code, cols, points, pos, quat, params, dist, closest, inside):
    """Plain PyTorch version; see ``custom_point``."""
    p_n, m = points.shape[0], dist.shape[1]
    c = cols.long().repeat(p_n)
    r = torch.arange(p_n, device=points.device).repeat_interleave(cols.shape[0])
    q = quat[c]
    d, cl, ins = point_local(_shape(shapes, code), quat_m.rotate_inv(q, points[r] - pos[c]),
                             params[c])
    flat = r * m + c
    dist.view(-1)[flat] = d
    closest.view(-1, 3)[flat] = pos[c] + quat_m.rotate(q, cl)
    inside.view(-1)[flat] = ins
    return dist, closest, inside


def custom_point(shapes, code, cols, points, pos, quat, params, dist, closest, inside):
    """Kernel AF's custom instance: distances (negative inside), world
    closest points and inside flags of P points ``points`` f32[P, 3] against
    the colliders ``cols`` (i32[K]) of custom code ``code``, written into
    ``dist`` f32[P, M], ``closest`` f32[P, M, 3] and ``inside`` bool[P, M] as
    Kernel AF writes its buckets."""
    if cols.device.type == "cpu":
        return custom_point_twin(shapes, code, cols, points, pos, quat, params, dist, closest,
                                 inside)
    lib = _cuda("custom_point", shapes, cols.device)
    if cols.shape[0] and points.shape[0]:
        lib.launch("avian_custom_point", cols.device, int(code), cols.shape[0], points.shape[0],
                   pos.shape[0], cols, points, pos, quat, params, dist, closest, inside)
        custom_point.launches += 1
    return dist, closest, inside


custom_point.launches = 0


def buckets(shape_type, shapes):
    """``(order i32[M], spans)``: the colliders of each custom shape of
    ``shapes`` (``spans``: one ``(code, start, end)`` of ``order`` for each
    code that has colliders), from one stable sort and one host read of the
    counts. Raises for a code past the tuple."""
    base = CUSTOM_SHAPE_BASE
    st = shape_type.long()
    n = len(shapes)
    kinds = torch.where(st >= base, st - (base - 1), 0)  # 0: a built-in shape
    counts = torch.bincount(kinds, minlength=n + 1).tolist()
    if len(counts) > n + 1:
        raise ValueError(f"a collider has a custom shape code past the world's {n} custom shapes")
    order = torch.argsort(kinds, stable=True).to(torch.int32)
    spans, start = [], counts[0]
    for i, count in enumerate(counts[1:]):
        if count:
            spans.append((base + i, start, start + count))
        start += count
    return order, spans


def custom_codes(shape_type, n_shapes, what):
    """``(st i64[M], custom bool[M])``: the colliders' shape codes and which
    are custom. Raises, from one host read, for the TRIMESH and HEIGHTFIELD
    codes, which the builder never writes, and for a custom code past the
    world's ``n_shapes`` custom shapes (a ``custom_collider(index=...)``
    world without its tuple), which ``what`` would otherwise miss."""
    st = shape_type.long()
    custom = st >= CUSTOM_SHAPE_BASE
    raw, past = torch.stack([((st > int(ShapeType.CONVEX)) & ~custom).any(),
                             (st >= CUSTOM_SHAPE_BASE + n_shapes).any()]).tolist()
    if raw:
        raise NotImplementedError(f"{what} against raw TRIMESH/HEIGHTFIELD codes are not "
                                  "ported (the builder makes CONVEX triangles)")
    if past:
        raise ValueError(f"{what}: a collider has a custom shape code past the world's "
                         f"{n_shapes} custom shapes (pass each CustomShape to the builder)")
    return st, custom
