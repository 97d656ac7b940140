"""Contact manifolds of support-mapped convex shapes (port of
``avian_tpu/geometry/convex.py``).

This is the plain PyTorch form of Kernels M, O, P and Q, batched over K pairs
of one canonical shape pair: the oracle of ``csrc/convex_manifold.cu`` and
``csrc/hull_manifold.cu``, which compute the same thing one thread per pair.
The reference's pipeline, step by step:

1. Direction: a working-set Frank-Wolfe iteration (24 steps) for the
   closest point of the Minkowski difference to the origin, and projected
   subgradient descent (20 steps) of its support function for the
   minimum-overlap direction; a penetration test picks one.
2. Polish: the normal snaps to a flat feature (box face, cylinder cap, cone
   base, capsule, cylinder or segment side, hull face) aligned within
   ``_FACE_SNAP``; then a FLAT shape (a triangle, params lane 5) facing the
   contact takes the normal from its plane (the reference's flat rule,
   which the port applies only where the other shape's centre lies in front
   of that face: ROADMAP 3b).
3. Manifold: each shape's support patch (8-slot rings) along the normal;
   the incident patch is clipped against the reference patch's edges in the
   normal's 2D frame (8 half-plane clips of a 16-point ring), lifted back
   onto each patch plane and reduced to 4 points. A point or segment
   reference patch gives the 1-2 point "degenerate" manifold of support
   witnesses instead.

``plane_patch_manifold`` is ``support_patch_plane_pair``: a shape's support
patch against a half-space, reduced to 4 points.

Pool-backed convex shapes (CONVEX: hulls, round cuboids, triangles) read
their vertices from the world's vertex pool: params ``(offset, count, hx,
hy, hz, flat, radius)``, a window of ``MAX_HULL_VERTS`` rows from
``offset``, of which the first ``count`` are vertices (``hull_windows``).
A radius in lane 6 makes the shape the Minkowski sum of the hull and a
sphere: the support grows by ``r * d_hat``, a patch lifts by ``r`` along its
face normal.

Every argmax/argmin takes the first extremum (as ``jnp.argmax`` does), the
top 8 of ``patch_convex`` are a stable descending sort (``lax.top_k`` puts
the lower index first among equals), square roots are correctly rounded
(``vec.sqrt_rn``), ``sign`` is 0 at 0 where the reference's ``jnp.sign`` is,
the constants are the reference's, and every sum is written out in the
order the kernels use, which is the order XLA:CPU sums in (the masked vertex
sums from 0 upward, one row after the other). The disc tables are the
reference's: numpy ``cos``/``sin`` of a float64 ``linspace``, cast to
float32.
"""

from typing import NamedTuple

import numpy as np
import torch

from avian_tpu_torch.core.types import ShapeType
from avian_tpu_torch.kernels.contact_rows import first_argmax
from avian_tpu_torch.math import quat as quat_m
from avian_tpu_torch.math import vec

FW_ITERS = 24        # Frank-Wolfe distance iterations
DEPTH_ITERS = 20     # subgradient depth-direction iterations
PATCH = 8            # support patch ring capacity
CLIP = 16            # clip buffer capacity
_FACE_SNAP = 0.98    # cos threshold: snap normal to a flat feature
_FACE_TOL = 0.98     # cos threshold: direction counts as hitting a face
_SIDE_TOL = 0.05     # sin threshold: direction counts as hitting a side
_EPS = 1e-9
MAX_HULL_VERTS = 32  # a pool-backed shape's vertex window

_DISC_ANGLES = np.linspace(0.0, 2.0 * np.pi, PATCH, endpoint=False)
DISC_COS = np.cos(_DISC_ANGLES).astype(np.float32)
DISC_SIN = np.sin(_DISC_ANGLES).astype(np.float32)

# 0.5 / sqrt(1 + i) in float32, the depth search's step sizes.
DEPTH_STEPS = [
    float(np.float32(0.5) / np.sqrt(np.float32(1.0 + i))) for i in range(DEPTH_ITERS)
]


def _x_axis(like):
    out = torch.zeros_like(like)
    out[..., 0] = 1.0
    return out


def nrm(d, fallback=None):
    """``d`` normalized (correctly rounded), ``fallback`` (default +x) where
    it is about 0 (the reference's ``_nrm``)."""
    return vec.normalize_or_rn(d, _x_axis(d) if fallback is None else fallback)


def _xz(d):
    """``d`` with its y component zeroed."""
    return torch.stack([d[..., 0], torch.zeros_like(d[..., 1]), d[..., 2]], -1)


def _ring(p):
    """One point [K, 3] repeated into an 8-slot ring [K, 8, 3]."""
    return p[:, None, :].expand(-1, PATCH, -1)


def _with_two(rest, p0, p1):
    """The ring ``rest`` [K, 8, 3] with slots 0 and 1 replaced."""
    return torch.cat([p0[:, None], p1[:, None], rest[:, 2:]], 1)


def _disc(r, y):
    """The 8-point disc ring of radius ``r`` at height ``y`` [K]."""
    c = torch.tensor(DISC_COS, device=r.device)
    s = torch.tensor(DISC_SIN, device=r.device)
    return torch.stack(
        [r[:, None] * c[None], y[:, None].expand(-1, PATCH), r[:, None] * s[None]], -1
    )


def _side_points(h, r, perp):
    """The segment endpoints pushed to the surface along ``perp``."""
    x, z = r * perp[:, 0], r * perp[:, 2]
    return torch.stack([x, -h, z], -1), torch.stack([x, h, z], -1)


# ---------------------------------------------------------------------------
# Local-frame support functions: support(prm [K, 3], d [K, 3]) -> [K, 3].
# ---------------------------------------------------------------------------


def support_sphere(prm, d):
    return prm[:, 0:1] * nrm(d)


def support_capsule(prm, d):
    h, r = prm[:, 0], prm[:, 1]
    n = nrm(d)
    return torch.stack(
        [r * n[:, 0], h * torch.sign(d[:, 1]) + r * n[:, 1], r * n[:, 2]], -1
    )


def support_box(prm, d):
    return torch.where(d >= 0.0, prm, -prm)


def support_segment(prm, d):
    """Segment on local X with half length ``prm[:, 0]``: its end along d."""
    sx = torch.sign(d[:, 0]) + (d[:, 0] == 0.0).to(torch.float32)
    hs = prm[:, 0] * sx
    return torch.stack([hs, 0.0 * hs, 0.0 * hs], -1)  # X * (h * sx)


def _radial(d, r):
    """The rim point of the unit-height disc of radius ``r`` along ``d``'s
    xz part (0 where that part vanishes): (x, z)."""
    dxz = vec.sqrt_rn(d[:, 0] * d[:, 0] + d[:, 2] * d[:, 2])
    scale = r / torch.clamp(dxz, min=_EPS)
    ok = dxz > _EPS
    return torch.where(ok, d[:, 0] * scale, 0.0), torch.where(ok, d[:, 2] * scale, 0.0)


def support_cylinder(prm, d):
    h, r = prm[:, 0], prm[:, 1]
    x, z = _radial(d, r)
    return torch.stack([x, h * torch.sign(d[:, 1]), z], -1)


def _cone_sin(h, r):
    """sin of the cone's half angle. The reference writes ``r / sqrt(...)``,
    which XLA compiles as ``r * rsqrt(...)``, ``rsqrt`` rounded as
    ``1 / sqrt``; so it is computed here."""
    return r * (1.0 / vec.sqrt_rn(r * r + 4.0 * h * h))


def support_cone(prm, d):
    """Cone: base disc at y = -h, apex at (0, +h, 0)."""
    h, r = prm[:, 0], prm[:, 1]
    dn = vec.sqrt_rn(torch.clamp(vec.length_sq(d), min=_EPS * _EPS))
    use_apex = d[:, 1] > _cone_sin(h, r) * dn
    x, z = _radial(d, r)
    zero = torch.zeros_like(h)
    apex = torch.stack([zero, h, zero], -1)
    rim = torch.stack([x, -h, z], -1)
    return torch.where(use_apex[:, None], apex, rim)


# ---------------------------------------------------------------------------
# Support patches: patch(prm, d) -> (pts [K, 8, 3], face normal [K, 3],
# count i32 [K]); an ordered ring on the surface supporting ``d``.
# ---------------------------------------------------------------------------


def _count(k_n, dev, value):
    return torch.full((k_n,), value, dtype=torch.int32, device=dev)


def patch_sphere(prm, d):
    dn = nrm(d)
    return _ring(prm[:, 0:1] * dn), dn, _count(d.shape[0], d.device, 1)


def patch_capsule(prm, d):
    h, r = prm[:, 0], prm[:, 1]
    dn = nrm(d)
    perp = nrm(_xz(dn))
    is_side = torch.abs(dn[:, 1]) < (1.0 - _SIDE_TOL)
    p0, p1 = _side_points(h, r, perp)
    pole = _ring(support_capsule(prm, d))
    pts = torch.where(is_side[:, None, None], _with_two(pole, p0, p1), pole)
    nf = torch.where(is_side[:, None], perp, dn)
    return pts, nf, torch.where(is_side, 2, 1).to(torch.int32)


def patch_segment(prm, d):
    """The whole segment when ``d`` is mostly across it, else its end."""
    h = prm[:, 0]
    dn = nrm(d)
    y_axis = torch.zeros_like(dn)
    y_axis[:, 1] = 1.0
    perp = nrm(torch.stack([0.0 * dn[:, 0], dn[:, 1], dn[:, 2]], -1), y_axis)
    is_edge = torch.abs(dn[:, 0]) < (1.0 - _SIDE_TOL)
    nh = -h
    p0 = torch.stack([nh, nh * 0.0, nh * 0.0], -1)
    p1 = torch.stack([h, h * 0.0, h * 0.0], -1)
    end = _ring(support_segment(prm, d))
    pts = torch.where(is_edge[:, None, None], _with_two(end, p0, p1), end)
    nf = torch.where(is_edge[:, None], perp, dn)
    return pts, nf, torch.where(is_edge, 2, 1).to(torch.int32)


def first_argmin(score):
    """Index of the smallest entry along the last axis; the first of equals."""
    return first_argmax(-score)


_QUAD = ((1.0, 1.0), (-1.0, 1.0), (-1.0, -1.0), (1.0, -1.0))


def patch_box(prm, d):
    dn = nrm(d)
    ax = first_argmax(torch.abs(dn))
    comp = dn.gather(1, ax[:, None])[:, 0]
    s = torch.sign(comp) + (comp == 0.0).to(torch.float32)  # never 0
    eye = torch.eye(3, device=d.device)
    n_face = eye[ax] * s[:, None]
    h_ax = prm.gather(1, ax[:, None])[:, 0]
    h_u = prm.gather(1, ((ax + 1) % 3)[:, None])[:, 0]
    h_v = prm.gather(1, ((ax + 2) % 3)[:, None])[:, 0]
    # Corner k in face coordinates (along ax, ax + 1, ax + 2), rolled into
    # place: component c of the point is face coordinate (c - ax) mod 3.
    corners = []
    for qu, qv in _QUAD:
        f = torch.stack([s * h_ax, qu * h_u, qv * h_v], -1)
        roll = (torch.arange(3, device=d.device)[None, :] - ax[:, None]) % 3
        corners.append(f.gather(1, roll))
    pts4 = torch.stack(corners, 1)
    pts = torch.cat([pts4, pts4[:, 0:1].expand(-1, PATCH - 4, -1)], 1)
    return pts, n_face, _count(d.shape[0], d.device, 4)


def patch_cylinder(prm, d):
    h, r = prm[:, 0], prm[:, 1]
    dn = nrm(d)
    sy = torch.sign(dn[:, 1]) + (dn[:, 1] == 0.0).to(torch.float32)
    perp = nrm(_xz(dn))
    is_cap = torch.abs(dn[:, 1]) > _FACE_TOL
    is_side = torch.abs(dn[:, 1]) < _SIDE_TOL
    disc = _disc(r, sy * h)
    p0, p1 = _side_points(h, r, perp)
    rim = _ring(support_cylinder(prm, d))
    pts = torch.where(
        is_cap[:, None, None], disc,
        torch.where(is_side[:, None, None], _with_two(rim, p0, p1), rim),
    )
    zero = torch.zeros_like(h)
    cap_n = torch.stack([zero, sy, zero], -1)
    nf = torch.where(is_cap[:, None], cap_n, torch.where(is_side[:, None], perp, dn))
    cnt = torch.where(is_cap, PATCH, torch.where(is_side, 2, 1)).to(torch.int32)
    return pts, nf, cnt


def patch_cone(prm, d):
    h, r = prm[:, 0], prm[:, 1]
    dn = nrm(d)
    perp = nrm(_xz(dn))
    is_base = dn[:, 1] < -_FACE_TOL
    is_apex = dn[:, 1] > _cone_sin(h, r) + _SIDE_TOL
    disc = _disc(r, -h)
    zero = torch.zeros_like(h)
    apex = torch.stack([zero, h, zero], -1)
    rim = torch.stack([r * perp[:, 0], -h, r * perp[:, 2]], -1)
    two_h = 2.0 * h
    slant_n = nrm(torch.stack([two_h * perp[:, 0], r, two_h * perp[:, 2]], -1))
    side = _with_two(_ring(rim), apex, rim)
    pts = torch.where(
        is_base[:, None, None], disc, torch.where(is_apex[:, None, None], _ring(apex), side)
    )
    down = torch.stack([zero, -torch.ones_like(h), zero], -1)
    nf = torch.where(is_base[:, None], down, torch.where(is_apex[:, None], dn, slant_n))
    cnt = torch.where(is_base, PATCH, torch.where(is_apex, 1, 2)).to(torch.int32)
    return pts, nf, cnt


# ---------------------------------------------------------------------------
# Pool-backed convex shapes (reference convex.py:741-864).
# ---------------------------------------------------------------------------


class Hull(NamedTuple):
    """K pool-backed convex shapes: params f32[K, 7] ``(offset, count, hx,
    hy, hz, flat, radius)``, their vertex windows f32[K, 32, 3] and which
    rows of a window are vertices bool[K, 32]."""

    prm: torch.Tensor
    verts: torch.Tensor
    valid: torch.Tensor


def hull_windows(prm, pool):
    """The ``Hull`` of params ``prm`` [K, 7] on the vertex pool f32[V, 3]:
    ``MAX_HULL_VERTS`` rows from each offset, read from the pool padded with
    that many zero rows as the reference pads it (narrowphase.py:507-514),
    the first ``count`` of them valid."""
    lanes = torch.arange(MAX_HULL_VERTS, device=prm.device)
    pool = torch.cat([pool, pool.new_zeros((MAX_HULL_VERTS, 3))])
    off = prm[:, 0].to(torch.int64)
    cnt = prm[:, 1].to(torch.int64)
    return Hull(prm, pool[off[:, None] + lanes], lanes[None, :] < cnt[:, None])


def _hull_dots(h, axis):
    """Each vertex's dot with ``axis`` [K, 3]; -1e30 on rows past the count."""
    return torch.where(h.valid, vec.dot(h.verts, axis[:, None, :]), -1e30)


def _masked_sum(x, mask):
    """sum_j where(mask[:, j], x[:, j], 0) over axis 1 of x [K, P, 3], from 0
    upward one row after the other (XLA:CPU's order of ``jnp.sum``)."""
    acc = torch.zeros_like(x[:, 0])
    for j in range(x.shape[1]):
        acc = acc + torch.where(mask[:, j, None], x[:, j], 0.0)
    return acc


def support_convex(h, d):
    """The first vertex farthest along ``d``, plus ``r * d_hat``."""
    i = first_argmax(_hull_dots(h, d))
    return _rows(h.verts, i) + h.prm[:, 6:7] * nrm(d)


def patch_convex(h, d):
    """The hull's support face along ``d``, two-phase: vertices in a loose
    band (0.35 of the largest half extent) along ``d`` fit a plane normal,
    then a tight band (0.02) along that normal collects the face, falling
    back to the loose set where the tight one is smaller; a shape of at most
    3 vertices is its own face. The top 8 by support value, ordered by angle
    about their centroid, padded with the first; the face normal from the
    ring (``d`` below 3 points); lifted by the radius."""
    verts, valid = h.verts, h.valid
    dn = nrm(d)
    size = torch.clamp(h.prm[:, 2:5].amax(1), min=1e-3)

    def collect(axis, band):
        dots = _hull_dots(h, axis)
        return dots, valid & (dots > dots.amax(1, keepdim=True) - band[:, None])

    # Phase 1: loose band along d; the candidates' plane from the cross of
    # the two longest offsets from their centroid.
    _, near1 = collect(dn, 0.35 * size)
    k1 = near1.sum(1)
    c1 = _masked_sum(verts, near1) / torch.clamp(k1.to(torch.float32), min=1.0)[:, None]
    rel1 = torch.where(near1[..., None], verts - c1[:, None, :], 0.0)
    ra = _rows(rel1, first_argmax(vec.dot(rel1, rel1)))
    cr = vec.cross(ra[:, None, :], rel1)
    rb = _rows(rel1, first_argmax(vec.dot(cr, cr)))
    nf_fit = vec.normalize_or_rn(vec.cross(ra, rb), dn)
    nf_fit = nf_fit * torch.sign(vec.dot(nf_fit, dn) + 1e-12)[:, None]
    axis2 = torch.where((k1 >= 3)[:, None], nf_fit, dn)

    # Phase 2: tight band along the fitted normal.
    dots, near = collect(axis2, 0.02 * size)
    dots_dn = _hull_dots(h, dn)
    use2 = near.sum(1) >= torch.clamp(k1, max=3)
    near = torch.where(use2[:, None], near, near1)
    dots = torch.where(use2[:, None], dots, dots_dn)
    tiny = (h.prm[:, 1].to(torch.int64) <= 3)[:, None]
    near = torch.where(tiny, valid, near)
    dots = torch.where(tiny, dots_dn, dots)

    score = torch.where(near, dots, -torch.inf)
    idx = torch.sort(score, dim=1, descending=True, stable=True)[1][:, :PATCH]
    sel_ok = near.gather(1, idx)
    pts = verts.gather(1, idx[..., None].expand(-1, -1, 3))
    k = torch.clamp(near.sum(1), max=PATCH)

    # Angle order about the selected points' centroid.
    t1 = vec.any_orthonormal(dn)
    t2 = vec.cross(dn, t1)
    centroid = _masked_sum(pts, sel_ok) / torch.clamp(k.to(torch.float32), min=1.0)[:, None]
    rel = pts - centroid[:, None, :]
    ang = torch.atan2(vec.dot(rel, t2[:, None, :]), vec.dot(rel, t1[:, None, :]))
    ang = torch.where(sel_ok, ang, 1e9)
    order = torch.argsort(ang, dim=1, stable=True)
    pts = pts.gather(1, order[..., None].expand(-1, -1, 3))
    pad = torch.arange(PATCH, device=d.device)[None, :] >= k[:, None]
    pts = torch.where(pad[..., None], pts[:, 0:1], pts)

    nf = vec.normalize_or_rn(vec.cross(pts[:, 1] - pts[:, 0], pts[:, 2] - pts[:, 0]), dn)
    nf = nf * torch.sign(vec.dot(nf, dn) + 1e-12)[:, None]
    nf = torch.where((k >= 3)[:, None], nf, dn)
    pts = pts + h.prm[:, 6, None, None] * nf[:, None, :]
    return pts, nf, k.to(torch.int32)


HULL_INSIDE_TOL = 1e-5  # of a hull's size: the margin of ``hull_contains``
_CONTAINS_CHUNK = 256    # pairs of one pass of ``hull_contains``'s exact rule


def closest_point_on_hull(h, p, iters=16):
    """The inner hulls' points closest to the local points ``p`` [K, 3]
    (reference ``closest_point_on_hull``, convex.py:768): ``iters``
    Frank-Wolfe steps on |x - p|^2 from the mean of the window's 32 rows
    (rows past the count replaced by row 0, summed from row 0 upward), each
    step toward the first vertex farthest along -(x - p). Inside a hull the
    iteration only creeps toward ``p``; ``hull_contains`` decides there."""
    verts = torch.where(h.valid[..., None], h.verts, h.verts[:, :1])
    x = torch.zeros_like(p)
    for j in range(MAX_HULL_VERTS):
        x = x + verts[:, j]
    x = x / float(MAX_HULL_VERTS)
    for _ in range(iters):
        g = x - p
        dxs = x - _rows(h.verts, first_argmax(_hull_dots(h, -g)))
        gamma = torch.clamp(vec.dot(g, dxs) / torch.clamp(vec.dot(dxs, dxs), min=1e-12), 0.0, 1.0)
        x = x - gamma[:, None] * dxs
    return x


def _triples(n, device):
    """The index triples i < j < k < n, lexicographic: three i64[T]."""
    t = torch.combinations(torch.arange(n, device=device), r=3)
    return t[:, 0], t[:, 1], t[:, 2]


def hull_contains(h, p, x):
    """bool[K]: whether each local point ``p`` [K, 3] lies inside its inner
    hull, at least ``HULL_INSIDE_TOL`` x the hull's size from every face
    plane. ``x`` is ``closest_point_on_hull``'s point: every vertex strictly
    below ``p`` along ``p - x`` certifies ``p`` outside. Where that does not,
    the exact rule: each plane through three vertices (normal ``n``, their
    cross product) that has every vertex on one side of it, within the
    margin, must have ``p`` strictly on that side, beyond the margin. The
    hull's faces are among those planes, so a point that passes is inside; a
    flat hull (every vertex on one plane) holds none, nor one of fewer than
    four vertices."""
    u = p - x
    certified = _hull_dots(h, u).amax(1) < vec.dot(p, u)
    cnt = h.prm[:, 1].to(torch.int64)
    inside = torch.zeros_like(certified)
    todo = torch.nonzero(~certified & (cnt >= 4))[:, 0]
    if not todo.numel():
        return inside
    n_max = int(cnt[todo].max())
    ti, tj, tk = _triples(n_max, p.device)
    for part in torch.split(todo, _CONTAINS_CHUNK):
        verts, c = h.verts[part], cnt[part]
        vi = verts[:, ti]
        n = vec.cross(verts[:, tj] - vi, verts[:, tk] - vi)
        nn = vec.dot(n, n)
        size = torch.clamp(h.prm[part, 2:5].amax(1), min=1e-3)
        tol = (HULL_INSIDE_TOL * size)[:, None] * vec.sqrt_rn(nn)
        below = torch.ones_like(nn, dtype=torch.bool)
        above = torch.ones_like(below)
        for j in range(n_max):
            s = vec.dot(verts[:, j, None, :] - vi, n)
            off = (j >= c)[:, None]
            below = below & (off | (s <= tol))
            above = above & (off | (s >= -tol))
        q = vec.dot(p[part, None, :] - vi, n)
        plane = (tk[None, :] < c[:, None]) & (nn > 0.0)
        bad = plane & ((below & ~(q < -tol)) | (above & ~(q > tol)))
        inside[part] = ~bad.any(1)
    return inside


SHAPES = {
    int(ShapeType.SPHERE): (support_sphere, patch_sphere),
    int(ShapeType.CAPSULE): (support_capsule, patch_capsule),
    int(ShapeType.BOX): (support_box, patch_box),
    int(ShapeType.CYLINDER): (support_cylinder, patch_cylinder),
    int(ShapeType.CONE): (support_cone, patch_cone),
    int(ShapeType.SEGMENT): (support_segment, patch_segment),
    int(ShapeType.CONVEX): (support_convex, patch_convex),
}


def _shape(t, prm, pool):
    """(support, patch, the shape argument they take, flat flag bool[K]) of K
    shapes of type ``t`` with params ``prm`` [K, >= 3]; a CONVEX shape reads
    the pool and may be flat (lane 5 > 0.5)."""
    support, patch = SHAPES[int(t)]
    if int(t) == int(ShapeType.CONVEX):
        if pool is None:
            raise ValueError("a CONVEX shape needs the vertex pool")
        return support, patch, hull_windows(prm, pool), prm[:, 5] > 0.5
    flat = torch.zeros(prm.shape[0], dtype=torch.bool, device=prm.device)
    return support, patch, prm[:, :3], flat


# ---------------------------------------------------------------------------
# Direction finding
# ---------------------------------------------------------------------------


def _world_support(support_fn, prm, pos, quat):
    def s(d_world):
        return pos + quat_m.rotate(quat, support_fn(prm, quat_m.rotate_inv(quat, d_world)))

    return s


def _minkowski_support(sa, sb):
    """Support of K = A (-) B: s_K(d) = s_A(d) - s_B(-d)."""
    return lambda d: sa(d) - sb(-d)


def _closest_on_triangle_to_origin(a, b, c):
    """Closest point to the origin on triangle (a, b, c), by Voronoi regions
    (reference ``_closest_on_triangle_to_origin``, same priority)."""
    ab = b - a
    ac = c - a
    ap = -a
    d1 = vec.dot(ab, ap)
    d2 = vec.dot(ac, ap)
    bp = -b
    d3 = vec.dot(ab, bp)
    d4 = vec.dot(ac, bp)
    cp = -c
    d5 = vec.dot(ab, cp)
    d6 = vec.dot(ac, cp)

    in_a = (d1 <= 0.0) & (d2 <= 0.0)
    in_b = (d3 >= 0.0) & (d4 <= d3)
    in_c = (d6 >= 0.0) & (d5 <= d6)

    vc = d1 * d4 - d3 * d2
    in_ab = (vc <= 0.0) & (d1 >= 0.0) & (d3 <= 0.0)
    t_ab = d1 / torch.clamp(d1 - d3, min=_EPS)
    p_ab = a + t_ab[:, None] * ab

    vb = d5 * d2 - d1 * d6
    in_ac = (vb <= 0.0) & (d2 >= 0.0) & (d6 <= 0.0)
    t_ac = d2 / torch.clamp(d2 - d6, min=_EPS)
    p_ac = a + t_ac[:, None] * ac

    va = d3 * d6 - d5 * d4
    in_bc = (va <= 0.0) & (d4 - d3 >= 0.0) & (d5 - d6 >= 0.0)
    t_bc = (d4 - d3) / torch.clamp((d4 - d3) + (d5 - d6), min=_EPS)
    p_bc = b + t_bc[:, None] * (c - b)

    denom = va + vb + vc
    safe = torch.where(torch.abs(denom) > _EPS, denom, _EPS)
    v = vb / safe
    w = vc / safe
    p_int = a + ab * v[:, None] + ac * w[:, None]

    p = p_int
    for region, q in ((in_bc, p_bc), (in_ac, p_ac), (in_ab, p_ab), (in_c, c), (in_b, b),
                      (in_a, a)):
        p = torch.where(region[:, None], q, p)
    return p


def _fw_distance(sk, x0):
    """Closest point of K to the origin from ``x0`` in K: the working-set
    Frank-Wolfe iteration (triangle of iterate, new and previous support)."""
    x, s_prev = x0, sk(-x0)
    for _ in range(FW_ITERS):
        s = sk(-x)
        x, s_prev = _closest_on_triangle_to_origin(x, s, s_prev), s
    return x


def _depth_direction(sk, d0):
    """Minimize sigma_K(d) over |d| = 1 by projected subgradient descent."""
    d, best_d = d0, d0
    best_v = vec.dot(sk(d0), d0)
    for i in range(DEPTH_ITERS):
        s = sk(d)
        v = vec.dot(s, d)
        better = v < best_v
        best_d = torch.where(better[:, None], d, best_d)
        best_v = torch.where(better, v, best_v)
        g = s - v[:, None] * d
        d = nrm(d - DEPTH_STEPS[i] * g, d)
    return best_d, best_v


# ---------------------------------------------------------------------------
# Patch clipping manifold
# ---------------------------------------------------------------------------


def _rows(x, idx):
    """x[k, idx[k]] for x [K, P, ...], idx [K]."""
    shape = (x.shape[0], 1) + x.shape[2:]
    return x.gather(1, idx.reshape((-1, 1) + (1,) * (x.dim() - 2)).expand(shape))[:, 0]


def _dot2(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]


def _clip_halfplane(q, fids, count, n2, off, fid_base):
    """Sutherland-Hodgman clip of the [K, 16, 2] rings ``q`` against
    ``dot(n2, p) <= off``: kept points and crossings in ring order
    (``2 idx``, ``2 idx + 1``), the first 16 of them, padded with the first
    (reference ``_clip_halfplane``, whose ``lax.sort`` is this compaction)."""
    k_n, p_n = q.shape[0], q.shape[1]
    dev = q.device
    idx = torch.arange(p_n, device=dev).expand(k_n, p_n)
    nxt = torch.where(idx + 1 >= count[:, None], 0, idx + 1)
    nxt_q = q.gather(1, nxt[..., None].expand(-1, -1, 2))
    d_cur = _dot2(q, n2[:, None, :]) - off[:, None]
    d_nxt = _dot2(nxt_q, n2[:, None, :]) - off[:, None]
    in_cur = d_cur <= 0.0
    edge_valid = idx < count[:, None]
    crossing = edge_valid & (in_cur != (d_nxt <= 0.0))
    diff = d_cur - d_nxt
    t = d_cur / torch.where(torch.abs(diff) > 1e-12, diff, 1e-12)
    inter = q + (nxt_q - q) * torch.clamp(t, 0.0, 1.0)[..., None]

    emit_q = torch.cat([q, inter], 1)
    emit_f = torch.cat([fids, fid_base + idx.to(torch.int32)], 1)
    emit_ok = torch.cat([edge_valid & in_cur, crossing], 1)
    order_key = torch.cat([2 * idx, 2 * idx + 1], 1)
    key = torch.where(emit_ok, order_key, 2 * p_n + order_key)
    order = torch.argsort(key, dim=1)[:, :p_n]
    out_q = emit_q.gather(1, order[..., None].expand(-1, -1, 2))
    out_count = torch.clamp(emit_ok.sum(1), max=p_n).to(torch.int32)
    pad = idx >= out_count[:, None]
    out_q = torch.where(pad[..., None], out_q[:, 0:1], out_q)
    out_f = torch.where(pad, 0, emit_f.gather(1, order))
    return out_q, out_f, out_count


def reduce4(uv, seps, count):
    """Reduce a clipped 2D point set to <= 4 points: the deepest, the
    farthest from it, the largest and smallest signed area against that
    edge. Returns (sel i64[K, 4], ok bool[K, 4])."""
    k_n, p_n = seps.shape
    dev = seps.device
    rows = torch.arange(k_n, device=dev)
    valid = torch.arange(p_n, device=dev)[None, :] < count[:, None]
    idx0 = first_argmin(torch.where(valid, seps, 1e9))
    p0 = uv[rows, idx0]
    du = uv - p0[:, None, :]
    d2 = torch.where(valid, du[..., 0] * du[..., 0] + du[..., 1] * du[..., 1], -1.0)
    d2[rows, idx0] = -1.0
    idx1 = first_argmax(d2)
    e1 = uv[rows, idx1] - p0
    cr = e1[:, 0:1] * du[..., 1] - e1[:, 1:2] * du[..., 0]
    cr = torch.where(valid, cr, 0.0)
    cr[rows, idx0] = 0.0
    cr[rows, idx1] = 0.0
    idx2 = first_argmax(cr)
    idx3 = first_argmin(cr)
    sel = torch.stack([idx0, idx1, idx2, idx3], 1)
    first = torch.stack([
        torch.ones_like(idx0, dtype=torch.bool),
        idx1 != idx0,
        (idx2 != idx0) & (idx2 != idx1),
        (idx3 != idx0) & (idx3 != idx1) & (idx3 != idx2),
    ], 1)
    return sel, first & valid.gather(1, sel)


def _get_patch(patch_fn, prm, pos, quat, d_world):
    pts_l, nf_l, cnt = patch_fn(prm, quat_m.rotate_inv(quat, d_world))
    pts_w = pos[:, None, :] + quat_m.rotate(quat[:, None, :], pts_l)
    return pts_w, quat_m.rotate(quat, nf_l), cnt


def generic_manifold(type_a, type_b, pa, qa, prm_a, pb, qb, prm_b, pool=None):
    """Manifolds of K pairs of shape ``type_a`` (A) and ``type_b`` (B), both
    support-mapped (reference ``generic_convex_pair``, and
    ``generic_convex_pair_aux`` with its flat rule where a side is CONVEX).
    ``prm_*`` are the shape parameters [K, 3], or [K, 7] for CONVEX, whose
    vertices come from ``pool`` f32[V, 3]. Returns (normal f32[K,3], point_a
    f32[K,4,3], point_b f32[K,4,3], separation f32[K,4], feature_id
    i32[K,4], count i32[K])."""
    support_a, patch_a, prm_a, flat_a = _shape(type_a, prm_a, pool)
    support_b, patch_b, prm_b, flat_b = _shape(type_b, prm_b, pool)
    k_n = pa.shape[0]
    dev = pa.device
    sa = _world_support(support_a, prm_a, pa, qa)
    sb = _world_support(support_b, prm_b, pb, qb)
    sk = _minkowski_support(sa, sb)

    # --- direction ---------------------------------------------------------
    x = _fw_distance(sk, pa - pb)
    dist = vec.length_rn(x)
    ab = nrm(pb - pa)
    sep_dir = nrm(-x, ab)
    d_pen, overlap = _depth_direction(sk, ab)
    penetrating = (dist < 1e-4) | ((dist < 1e-2) & (overlap > 0.0))
    n = torch.where(penetrating[:, None], nrm(d_pen), sep_dir)

    # --- patches + polish ----------------------------------------------------
    pts_a, nf_a, cnt_a = _get_patch(patch_a, prm_a, pa, qa, n)
    pts_b, nf_b, cnt_b = _get_patch(patch_b, prm_b, pb, qb, -n)
    align_a = vec.dot(nf_a, n)
    align_b = vec.dot(nf_b, -n)
    elig_a = (align_a > _FACE_SNAP) & (cnt_a >= 2)
    elig_b = (align_b > _FACE_SNAP) & (cnt_b >= 2)
    snap_a = elig_a & (~elig_b | (align_a >= align_b))
    snap_b = elig_b & ~snap_a
    n = torch.where(snap_a[:, None], nf_a, torch.where(snap_b[:, None], -nf_b, n))
    # Flat shapes dominate: a frontal contact takes the normal of their plane.
    # Frontal also means that the other shape's centre lies in front of the
    # face the contact sees (its normal faces along the contact); the
    # reference asks only the alignment, and at a concave fold of a mesh it
    # snaps to a neighbouring triangle's back face and pushes a body resting
    # on the next triangle down through the mesh (ROADMAP 3b). A triangle's
    # origin lies in its plane.
    prefer_b = (flat_b & (align_b > 0.3) & (cnt_b >= 3)
                & (vec.dot(nf_b, pa - pb) > 0.0))
    prefer_a = (flat_a & (align_a > 0.3) & (cnt_a >= 3) & (vec.dot(nf_a, pb - pa) > 0.0)
                & (~prefer_b | (align_a > align_b)))
    n = torch.where(prefer_a[:, None], nf_a, torch.where(prefer_b[:, None], -nf_b, n))
    n = nrm(n)

    pts_a, nf_a, cnt_a = _get_patch(patch_a, prm_a, pa, qa, n)
    pts_b, nf_b, cnt_b = _get_patch(patch_b, prm_b, pb, qb, -n)

    # --- 2D frame ----------------------------------------------------------
    t1 = vec.any_orthonormal(n)
    t2 = vec.cross(n, t1)

    def to2d(p):
        return torch.stack([vec.dot(p, t1[:, None]), vec.dot(p, t2[:, None])], -1)

    a2, b2 = to2d(pts_a), to2d(pts_b)
    # Reference = the patch with more points (tie -> better aligned, by the
    # alignments of the first patches, as the reference has them).
    ref_is_a = (cnt_a > cnt_b) | ((cnt_a == cnt_b) & (align_a >= align_b))
    ref2 = torch.where(ref_is_a[:, None, None], a2, b2)
    ref_cnt = torch.where(ref_is_a, cnt_a, cnt_b)
    inc2 = torch.where(ref_is_a[:, None, None], b2, a2)
    inc_cnt = torch.where(ref_is_a, cnt_b, cnt_a)

    lanes = torch.arange(CLIP, device=dev)[None, :]
    q = torch.cat([inc2, inc2[:, 0:1].expand(-1, CLIP - PATCH, -1)], 1)
    in_ring = lanes < inc_cnt[:, None]
    q = torch.where(in_ring[..., None], q, q[:, 0:1])
    fids = torch.where(in_ring, lanes, 0).to(torch.int32)
    cnt = torch.clamp(inc_cnt, max=CLIP)

    ref_cnt_f = ref_cnt.to(torch.float32)
    centroid = torch.where((ref_cnt > 0)[:, None], ref2[:, 0], 0.0)
    for j in range(1, PATCH):
        centroid = centroid + torch.where((ref_cnt > j)[:, None], ref2[:, j], 0.0)
    centroid = centroid / torch.clamp(ref_cnt_f, min=1.0)[:, None]

    clip_on = ref_cnt >= 3
    x_dir = torch.zeros((k_n, 2), device=dev)
    x_dir[:, 0] = 1.0
    for e in range(PATCH):
        v0 = ref2[:, e]
        v1 = _rows(ref2, torch.where(ref_cnt <= e + 1, 0, e + 1))
        edge = v1 - v0
        n2 = torch.stack([-edge[:, 1], edge[:, 0]], -1)
        n2 = -(n2 * torch.sign(_dot2(n2, centroid - v0) + 1e-12)[:, None])
        active = clip_on & (ref_cnt > e) & (vec.sqrt_rn(_dot2(edge, edge)) > 1e-9)
        off = torch.where(active, _dot2(n2, v0), 1e12)
        n2 = torch.where(active[:, None], n2, x_dir)
        q, fids, cnt = _clip_halfplane(q, fids, cnt, n2, off, 16 + 8 * e)

    # --- lift back to 3D + separations ------------------------------------
    p3 = q[..., 0:1] * t1[:, None, :] + q[..., 1:2] * t2[:, None, :]
    p3n = vec.dot(p3, n[:, None, :])

    def lift(pts, nf):
        nfn = vec.dot(nf, n)
        safe = torch.abs(nfn) > 0.2
        p0 = pts[:, 0]
        s = torch.where(
            safe[:, None],
            (vec.dot(nf, p0)[:, None] - vec.dot(p3, nf[:, None, :]))
            / torch.where(safe, nfn, 1.0)[:, None],
            vec.dot(p0, n)[:, None] - p3n,
        )
        return p3 + s[..., None] * n[:, None, :]

    p_on_a = lift(pts_a, nf_a)
    p_on_b = lift(pts_b, nf_b)
    seps = vec.dot(p_on_b - p_on_a, n[:, None, :])

    sel, ok = reduce4(q, seps, cnt)
    clip_pa = p_on_a.gather(1, sel[..., None].expand(-1, -1, 3))
    clip_pb = p_on_b.gather(1, sel[..., None].expand(-1, -1, 3))
    clip_sep = torch.where(ok, seps.gather(1, sel), 1e9)
    clip_fid = torch.where(ok, fids.gather(1, sel), 0)
    clip_cnt = ok.sum(1).to(torch.int32)

    # --- degenerate: 1-2 points from the support witnesses ------------------
    both_seg = (cnt_a == 2) & (cnt_b == 2)
    dir_a = nrm(pts_a[:, 1] - pts_a[:, 0])
    parallel = torch.abs(vec.dot(dir_a, nrm(pts_b[:, 1] - pts_b[:, 0]))) > 0.999
    ta0 = vec.dot(pts_a[:, 0], dir_a)
    ta1 = vec.dot(pts_a[:, 1], dir_a)
    tb0 = vec.dot(pts_b[:, 0], dir_a)
    tb1 = vec.dot(pts_b[:, 1], dir_a)
    lo = torch.maximum(torch.minimum(ta0, ta1), torch.minimum(tb0, tb1))
    hi = torch.minimum(torch.maximum(ta0, ta1), torch.maximum(tb0, tb1))
    t_mid = torch.stack([lo, hi], 1)
    seg_pa = pts_a[:, 0:1] + (t_mid - ta0[:, None])[..., None] * dir_a[:, None, :]
    ba = pts_b[:, 0] - pts_a[:, 0]
    seg_pb = seg_pa + (ba - vec.dot(ba, dir_a)[:, None] * dir_a)[:, None, :]
    use_seg2 = both_seg & parallel & (hi >= lo)

    wa = sa(n)
    wb = sb(-n)
    u2 = use_seg2[:, None, None]
    deg_pa = torch.where(u2, seg_pa, _with_two(pts_a[:, :2], wa, pts_a[:, 1]))
    deg_pb = torch.where(u2, seg_pb, _with_two(pts_b[:, :2], wb, pts_b[:, 1]))
    deg_sep = vec.dot(deg_pb - deg_pa, n[:, None, :])
    deg_sep = torch.where(use_seg2[:, None], deg_sep,
                          torch.stack([vec.dot(wb - wa, n), deg_sep[:, 1]], 1))
    deg_cnt = torch.where(use_seg2, 2, 1).to(torch.int32)
    deg_sep = torch.where(torch.arange(2, device=dev)[None, :] < deg_cnt[:, None], deg_sep, 1e9)

    zeros2 = torch.zeros((k_n, 2, 3), device=dev)
    deg_pa = torch.cat([deg_pa, zeros2], 1)
    deg_pb = torch.cat([deg_pb, zeros2], 1)
    deg_sep = torch.cat([deg_sep, torch.full((k_n, 2), 1e9, device=dev)], 1)
    deg_fid = torch.tensor([[0, 1, 0, 0]], dtype=torch.int32, device=dev).expand(k_n, 4)

    use_clip = (ref_cnt >= 3) & (clip_cnt > 0)
    u1, u3 = use_clip[:, None], use_clip[:, None, None]
    return (
        n,
        torch.where(u3, clip_pa, deg_pa),
        torch.where(u3, clip_pb, deg_pb),
        torch.where(u1, clip_sep, deg_sep),
        torch.where(u1, clip_fid, deg_fid),
        torch.where(use_clip, clip_cnt, deg_cnt),
    )


def plane_patch_manifold(type_b, pa, qa, na, pb, qb, prm_b, pool=None):
    """Manifolds of K pairs of a half-space A (local normal ``na``, the
    first three lanes of its params) and a support-mapped shape B, in that
    canonical order (reference ``_swapped(support_patch_plane_pair(...))``,
    ``_swapped_aux`` for CONVEX): B's support patch along the plane's inward
    normal, its distances to the plane, reduced to 4 spread points. Same
    returns as ``generic_manifold``; the normal points from the plane to the
    shape."""
    _, patch_b, prm_b, _ = _shape(type_b, prm_b, pool)
    na = na[:, :3]
    dev = pa.device
    n_plane = quat_m.rotate(qa, na)
    pts_l, _, cnt = patch_b(prm_b, quat_m.rotate_inv(qb, -n_plane))
    pts_w = pb[:, None, :] + quat_m.rotate(qb[:, None, :], pts_l)
    valid = torch.arange(PATCH, device=dev)[None, :] < cnt[:, None]
    seps = torch.where(valid, vec.dot(pts_w - pa[:, None, :], n_plane[:, None, :]), 1e9)
    t1 = vec.any_orthonormal(n_plane)
    t2 = vec.cross(n_plane, t1)
    uv = torch.stack([vec.dot(pts_w, t1[:, None]), vec.dot(pts_w, t2[:, None])], -1)
    sel, ok = reduce4(uv, seps, cnt)
    p4 = pts_w.gather(1, sel[..., None].expand(-1, -1, 3))
    s4 = seps.gather(1, sel)
    return (
        n_plane,
        p4 - n_plane[:, None, :] * s4[..., None],
        p4,
        torch.where(ok, s4, 1e9),
        torch.where(ok, sel, 0).to(torch.int32),
        ok.sum(1).to(torch.int32),
    )
