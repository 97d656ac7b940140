"""Contact manifolds for the pair buffer (port of the parts of
``avian_tpu/geometry/narrowphase.py`` the ported paths need).

The reference evaluates every listed pair function on every slot under
``vmap`` + ``lax.switch``. Here pairs are bucketed by canonical shape code
and each bucket that holds pairs gets one launch of its kernel:

- Kernel A (``kernels/box_manifold.py``): box/box and box/plane;
- Kernel N (``kernels/round_manifold.py``): the six analytic pairs of
  spheres, capsules, boxes and half-spaces, whose plain versions are below;
- Kernel M (``kernels/convex_manifold.py``): the sixteen support-mapped
  pairs of spheres, capsules, boxes, cylinders, cones and segments
  (``geometry/convex.py``);
- Kernel O (same module): half-space against cylinder, cone or segment;
- Kernel P (``kernels/hull_manifold.py``): a pool-backed convex shape (hull,
  round cuboid, triangle) against a sphere, capsule, box, cylinder, cone,
  segment or another such shape, whose buckets carry all seven parameter
  lanes and the world's vertex pool;
- Kernel Q (same module): half-space against a pool-backed convex shape.

Inputs are swapped into canonical order (type_a <= type_b) first and the
results swapped back, as the reference does (narrowphase.py:470-534). A
half-space pair gets the empty manifold (the reference lists none); a pair
of any other shape raises ``NotImplementedError``.

Conventions: ``normal`` points from A to B, ``separation`` is negative when
penetrating, 4 points per manifold.
"""

from dataclasses import dataclass

import torch

from avian_tpu_torch.core.types import ShapeType
from avian_tpu_torch.geometry.box_box import _closest_segment_segment
from avian_tpu_torch.geometry.convex import first_argmin, nrm
from avian_tpu_torch.kernels import box_manifold as ka
from avian_tpu_torch.kernels import convex_manifold as km
from avian_tpu_torch.kernels import hull_manifold as kpq
from avian_tpu_torch.kernels import round_manifold as kn
from avian_tpu_torch.math import quat as quat_m
from avian_tpu_torch.math import vec

MAX_POINTS = 4
_S = ShapeType
# Canonical pair -> (kernel module, wrapper name, kind). The wrapper is
# looked up when a bucket runs, so that it can be swapped for its plain
# version.
PAIR_KERNELS = {
    (int(_S.SPHERE), int(_S.SPHERE)): (kn, "round_manifold", kn.SPHERE_SPHERE),
    (int(_S.SPHERE), int(_S.CAPSULE)): (kn, "round_manifold", kn.SPHERE_CAPSULE),
    (int(_S.SPHERE), int(_S.BOX)): (kn, "round_manifold", kn.SPHERE_BOX),
    (int(_S.SPHERE), int(_S.PLANE)): (kn, "round_manifold", kn.SPHERE_PLANE),
    (int(_S.CAPSULE), int(_S.CAPSULE)): (kn, "round_manifold", kn.CAPSULE_CAPSULE),
    (int(_S.CAPSULE), int(_S.PLANE)): (kn, "round_manifold", kn.CAPSULE_PLANE),
    (int(_S.BOX), int(_S.BOX)): (ka, "box_manifold", ka.BOX_BOX),
    (int(_S.BOX), int(_S.PLANE)): (ka, "box_manifold", ka.BOX_PLANE),
    (int(_S.PLANE), int(_S.CYLINDER)): (km, "plane_patch_manifold", km.PLANE_CYLINDER),
    (int(_S.PLANE), int(_S.CONE)): (km, "plane_patch_manifold", km.PLANE_CONE),
    (int(_S.PLANE), int(_S.SEGMENT)): (km, "plane_patch_manifold", km.PLANE_SEGMENT),
    (int(_S.PLANE), int(_S.CONVEX)): (kpq, "plane_hull_manifold", kpq.PLANE_CONVEX),
    **{pair: (km, "convex_manifold", kind) for kind, pair in enumerate(km.GENERIC_PAIRS)},
    **{pair: (kpq, "hull_manifold", kind) for kind, pair in enumerate(kpq.HULL_PAIRS)},
}
# Kernels whose buckets take every parameter lane and the vertex pool.
POOL_KERNELS = ("hull_manifold", "plane_hull_manifold")
SUPPORTED_PAIRS = tuple(sorted(PAIR_KERNELS))
_EMPTY_PAIRS = ((int(_S.PLANE), int(_S.PLANE)),)
_NUM_TYPES = 16


@dataclass(frozen=True)
class Manifold:
    """Fixed-capacity contact manifolds for C pairs."""

    normal: torch.Tensor      # f32[C, 3] world, from A to B
    point_a: torch.Tensor     # f32[C, 4, 3]
    point_b: torch.Tensor     # f32[C, 4, 3]
    separation: torch.Tensor  # f32[C, 4]
    feature_id: torch.Tensor  # i32[C, 4]
    count: torch.Tensor       # i32[C]


def empty(c, device) -> Manifold:
    normal = torch.zeros((c, 3), device=device)
    normal[:, 0] = 1.0
    return Manifold(
        normal=normal,
        point_a=torch.zeros((c, 4, 3), device=device),
        point_b=torch.zeros((c, 4, 3), device=device),
        separation=torch.full((c, 4), 1e9, device=device),
        feature_id=torch.zeros((c, 4), dtype=torch.int32, device=device),
        count=torch.zeros((c,), dtype=torch.int32, device=device),
    )


_BOX_CORNERS = [
    [-1.0, -1.0, -1.0], [1.0, -1.0, -1.0], [-1.0, 1.0, -1.0], [1.0, 1.0, -1.0],
    [-1.0, -1.0, 1.0], [1.0, -1.0, 1.0], [-1.0, 1.0, 1.0], [1.0, 1.0, 1.0],
]


def box_plane(pa, qa, ha, pb, qb, nb):
    """Box A (half extents ``ha``) vs half-space B (local normal ``nb``):
    the 4 deepest of the 8 corners, ties toward the lower corner index
    (stable sort, as ``jnp.argsort``). Batched over K pairs."""
    n = quat_m.rotate(qb, nb)
    corners_l = torch.tensor(_BOX_CORNERS, device=pa.device)[None] * ha[:, None, :]
    corners = pa[:, None, :] + quat_m.rotate(qa[:, None, :], corners_l)
    seps = vec.dot(corners, n[:, None, :]) - vec.dot(pb, n)[:, None]
    idx = torch.argsort(seps, dim=1, stable=True)[:, :4]
    sep4 = seps.gather(1, idx)
    p4 = corners.gather(1, idx[..., None].expand(-1, -1, 3))
    k_n = pa.shape[0]
    return (
        -n,
        p4,
        p4 - n[:, None, :] * sep4[..., None],
        sep4,
        idx.to(torch.int32),
        torch.full((k_n,), 4, dtype=torch.int32, device=pa.device),
    )


_Y = (0.0, 1.0, 0.0)


def _one_point(normal, pa, pb, sep):
    """A 1-point manifold: point 0 given, the others zero with separation
    1e9, feature ids 0."""
    k_n, dev = normal.shape[0], normal.device
    zeros = torch.zeros((k_n, 3, 3), device=dev)
    big = torch.full((k_n, 3), 1e9, device=dev)
    return (
        normal,
        torch.cat([pa[:, None], zeros], 1),
        torch.cat([pb[:, None], zeros], 1),
        torch.cat([sep[:, None], big], 1),
        torch.zeros((k_n, 4), dtype=torch.int32, device=dev),
        torch.ones((k_n,), dtype=torch.int32, device=dev),
    )


def _two_points(normal, pa0, pa1, pb0, pb1, s0, s1, f0, f1):
    k_n, dev = normal.shape[0], normal.device
    zeros = torch.zeros((k_n, 2, 3), device=dev)
    big = torch.full((k_n, 2), 1e9, device=dev)
    fid = torch.tensor([[f0, f1, 0, 0]], dtype=torch.int32, device=dev).expand(k_n, 4)
    return (
        normal,
        torch.cat([torch.stack([pa0, pa1], 1), zeros], 1),
        torch.cat([torch.stack([pb0, pb1], 1), zeros], 1),
        torch.cat([torch.stack([s0, s1], 1), big], 1),
        fid,
        torch.full((k_n,), 2, dtype=torch.int32, device=dev),
    )


def _axis_y(q):
    """Local +Y rotated by ``q`` [K, 4]."""
    return quat_m.rotate(q, torch.tensor(_Y, device=q.device).expand(q.shape[0], 3))


def sphere_sphere(pa, qa, prm_a, pb, qb, prm_b):
    ra, rb = prm_a[:, 0], prm_b[:, 0]
    d = pb - pa
    dist = vec.length_rn(d)
    n = nrm(d)
    return _one_point(n, pa + n * ra[:, None], pb - n * rb[:, None], dist - (ra + rb))


def sphere_capsule(pa, qa, prm_a, pb, qb, prm_b):
    ra = prm_a[:, 0]
    hb, rb = prm_b[:, 0], prm_b[:, 1]
    axis = _axis_y(qb)
    # Closest point on B's segment to the sphere centre.
    t = torch.minimum(torch.maximum(vec.dot(pa - pb, axis), -hb), hb)
    c = pb + axis * t[:, None]
    d = c - pa
    dist = vec.length_rn(d)
    n = nrm(d)
    return _one_point(n, pa + n * ra[:, None], c - n * rb[:, None], dist - (ra + rb))


def capsule_capsule(pa, qa, prm_a, pb, qb, prm_b):
    """Closest points of the two segments (1 point), or, for parallel axes
    with overlapping extents, the two ends of the overlap (2 points, ids 1
    and 2)."""
    ha, ra = prm_a[:, 0], prm_a[:, 1]
    hb, rb = prm_b[:, 0], prm_b[:, 1]
    ua = _axis_y(qa)
    ub = _axis_y(qb)
    s, t = _closest_segment_segment(pa, ua, ha, pb, ub, hb)
    ca = pa + ua * s[:, None]
    cb = pb + ub * t[:, None]
    d = cb - ca
    dist = vec.length_rn(d)
    n = nrm(d)
    m1 = _one_point(n, ca + n * ra[:, None], cb - n * rb[:, None], dist - (ra + rb))

    parallel = torch.abs(vec.dot(ua, ub)) > 0.999
    tb0 = vec.dot((pb - ub * hb[:, None]) - pa, ua)
    tb1 = vec.dot((pb + ub * hb[:, None]) - pa, ua)
    lo = torch.maximum(-ha, torch.minimum(tb0, tb1))
    hi = torch.minimum(ha, torch.maximum(tb0, tb1))
    has_overlap = parallel & (hi > lo)
    ca0 = pa + ua * lo[:, None]
    ca1 = pa + ua * hi[:, None]
    rel = pb - pa
    perp = rel - ua * vec.dot(rel, ua)[:, None]
    pdist = vec.length_rn(perp)
    np_ = vec.normalize_or_rn(perp, vec.any_orthonormal(ua))
    sep_par = pdist - (ra + rb)
    m2 = _two_points(
        np_, ca0 + np_ * ra[:, None], ca1 + np_ * ra[:, None],
        (ca0 + perp) - np_ * rb[:, None], (ca1 + perp) - np_ * rb[:, None],
        sep_par, sep_par, 1, 2,
    )
    return _select(has_overlap, m2, m1)


def sphere_box(pa, qa, prm_a, pb, qb, prm_b):
    """Sphere A vs box B: from the box surface toward the centre outside,
    out along the axis of least penetration inside (ties: the first axis;
    sign + where the centre's coordinate is >= 0)."""
    ra = prm_a[:, 0]
    h = prm_b
    c_local = quat_m.rotate_inv(qb, pa - pb)
    q = torch.minimum(torch.maximum(c_local, -h), h)
    delta = c_local - q
    d2 = vec.length_sq(delta)
    outside = d2 > 1e-12
    dist = vec.sqrt_rn(torch.clamp(d2, min=1e-12))
    # ``delta / dist``, as XLA compiles it: delta * rsqrt(d2).
    n_out = delta * (1.0 / dist)[:, None]

    face_dist = h - torch.abs(c_local)
    ax = first_argmin(face_dist)
    comp = c_local.gather(1, ax[:, None])[:, 0]
    sign = torch.where(comp >= 0.0, 1.0, -1.0)
    n_in = torch.eye(3, device=pa.device)[ax] * sign[:, None]
    depth_in = face_dist.gather(1, ax[:, None])[:, 0]

    n_local = torch.where(outside[:, None], n_out, n_in)
    sep = torch.where(outside, dist - ra, -(depth_in + ra))
    q_surf = torch.where(outside[:, None], q, c_local + n_in * depth_in[:, None])
    normal = -quat_m.rotate(qb, n_local)
    return _one_point(normal, pa + normal * ra[:, None], pb + quat_m.rotate(qb, q_surf), sep)


def sphere_plane(pa, qa, prm_a, pb, qb, nb):
    """Sphere A vs half-space B (local normal ``nb``)."""
    ra = prm_a[:, 0]
    n = quat_m.rotate(qb, nb)
    s = vec.dot(pa - pb, n)
    normal = -n
    return _one_point(normal, pa + normal * ra[:, None], pa - n * s[:, None], s - ra)


def capsule_plane(pa, qa, prm_a, pb, qb, nb):
    """Capsule A vs half-space B: both segment ends, ids 0 and 1."""
    ha, ra = prm_a[:, 0], prm_a[:, 1]
    n = quat_m.rotate(qb, nb)
    axis = _axis_y(qa)
    e0 = pa - axis * ha[:, None]
    e1 = pa + axis * ha[:, None]
    s0 = vec.dot(e0 - pb, n) - ra
    s1 = vec.dot(e1 - pb, n) - ra
    normal = -n
    pa0 = e0 + normal * ra[:, None]
    pa1 = e1 + normal * ra[:, None]
    return _two_points(normal, pa0, pa1, pa0 - n * s0[:, None], pa1 - n * s1[:, None],
                       s0, s1, 0, 1)


def _select(mask, yes, no):
    """Per pair, manifold ``yes`` where ``mask`` else ``no``."""
    return tuple(
        torch.where(mask.reshape((-1,) + (1,) * (y.dim() - 1)), y, n) for y, n in zip(yes, no)
    )


def allowed_pairs(shape_pairs):
    """The canonical pairs the narrowphase may evaluate (``None`` = all)."""
    if shape_pairs is None:
        return set(SUPPORTED_PAIRS)
    return {(int(a), int(b)) for a, b in shape_pairs}


@dataclass(frozen=True)
class Bucket:
    """The pairs of one canonical shape pair, ready for its kernel."""

    pair: tuple          # canonical (type_a, type_b)
    name: str            # the kernel's wrapper, a function of ``module``
    kind: int            # its first argument
    slots: torch.Tensor  # i64[K] pair-buffer slots
    swap: torch.Tensor   # bool[K] inputs were swapped into canonical order
    inputs: tuple        # (pa, qa, prm_a, pb, qb, prm_b[, pool]), contiguous f32
    module: object       # the kernel's module

    def run(self, twin=False):
        """The bucket's manifolds from its kernel, or from the kernel's plain
        version with ``twin``."""
        return getattr(self.module, self.name + ("_twin" if twin else ""))(self.kind, *self.inputs)


def canonical_spans(type_a, type_b, valid, shape_pairs=None):
    """Bucket items by the canonical shape pair of their two shape codes
    (i64 or i32 [P]): one stable sort of the pair codes and one host read of
    the bucket sizes. Returns ``(order, swap, spans)``: ``order`` i64[P] the
    valid items by code (items ascending within a code), ``swap`` bool[P]
    (per item) whether its codes were swapped into canonical order, and
    ``spans`` one ``(pair, start, end)`` of ``order`` for each canonical pair
    that has items, is in ``shape_pairs`` (``None`` = all) and has a kernel.
    Raises for a pair the port does not support; half-space pairs and pairs
    outside ``shape_pairs`` get no span (the empty manifold)."""
    swap = type_a > type_b
    lo = torch.minimum(type_a, type_b).long()
    hi = torch.maximum(type_a, type_b).long()
    code = torch.where(valid, lo * _NUM_TYPES + hi, _NUM_TYPES * _NUM_TYPES)
    # A scatter, not ``torch.bincount``, which reads the largest code back to
    # the host before it counts: the one host read is the counts'.
    counts = torch.zeros((_NUM_TYPES * _NUM_TYPES + 1,), dtype=torch.int64, device=code.device)
    counts = counts.scatter_add_(0, code, torch.ones_like(code)).tolist()
    allowed = allowed_pairs(shape_pairs)
    spans = []
    start = 0
    for flat, n_items in enumerate(counts[:-1]):
        pair = divmod(flat, _NUM_TYPES)
        if n_items and pair not in PAIR_KERNELS and pair not in _EMPTY_PAIRS:
            raise NotImplementedError(
                f"shape pair {ShapeType(pair[0]).name}/{ShapeType(pair[1]).name}"
                " is not ported yet (pairs of spheres, capsules, boxes, cylinders,"
                " cones, segments, pool-backed convex shapes and half-spaces are)"
            )
        end = start + n_items
        if n_items and pair in allowed and pair in PAIR_KERNELS:
            spans.append((pair, start, end))
        start = end
    return torch.argsort(code, stable=True), swap, spans


def pair_manifold_twin(pair, pa, qa, prm_a, pb, qb, prm_b, pool=None):
    """The plain version of canonical pair ``pair``'s kernel on K pairs in
    canonical order; ``prm_*`` [K, >= 7] shape parameters (each kernel takes
    the lanes it reads), ``pool`` the vertex pool for pool-backed shapes."""
    module, name, kind = PAIR_KERNELS[pair]
    twin = getattr(module, name + "_twin")
    if name in POOL_KERNELS:
        lanes = kpq.PARAM_LANES
        return twin(kind, pa, qa, prm_a[:, :lanes], pb, qb, prm_b[:, :lanes], pool)
    return twin(kind, pa, qa, prm_a[:, :3], pb, qb, prm_b[:, :3])


def manifold_buckets(shape_type, params, pos, quat, ca, cb, valid,
                     shape_pairs=None, convex_verts=None):
    """Bucket the valid pairs by canonical shape pair (``canonical_spans``)
    and gather every input once; each bucket's inputs are then a contiguous
    slice. Buckets of Kernels P and Q get the first ``kpq.PARAM_LANES``
    params and the vertex pool ``convex_verts``, the others the first three
    params. Raises for a pair the port does not support; skips pairs outside
    ``shape_pairs`` and half-space pairs."""
    order, swap, spans = canonical_spans(shape_type[ca.long()], shape_type[cb.long()], valid,
                                         shape_pairs)
    sw = swap[order]
    c_a = torch.where(sw, cb[order], ca[order]).long()
    c_b = torch.where(sw, ca[order], cb[order]).long()
    gathered = (pos[c_a], quat[c_a], params[c_a, :3], pos[c_b], quat[c_b], params[c_b, :3])
    wide = None
    buckets = []
    for pair, start, end in spans:
        module, name, kind = PAIR_KERNELS[pair]
        inputs = tuple(x[start:end] for x in gathered)
        if name in POOL_KERNELS:
            if convex_verts is None:
                raise ValueError(f"shape pair {pair} needs the vertex pool")
            if wide is None:
                lanes = kpq.PARAM_LANES
                wide = (params[c_a, :lanes], params[c_b, :lanes])
            inputs = (inputs[0], inputs[1], wide[0][start:end], inputs[3], inputs[4],
                      wide[1][start:end], convex_verts)
        buckets.append(Bucket(pair, name, kind, order[start:end], sw[start:end], inputs,
                              module))
    return buckets


def compute_manifolds(shape_type, params, pos, quat, ca, cb, valid,
                      shape_pairs=None, convex_verts=None):
    """Manifolds for every slot of the pair buffer (``convex_verts``: the
    world's vertex pool, for pool-backed convex shapes).

    Slots that hold no pair, and pairs whose canonical shape pair is not in
    ``shape_pairs``, get the empty manifold (the reference's ``_unsupported``
    branch). Returns ``(manifold, bucket_sizes)`` where ``bucket_sizes``
    maps each canonical shape pair launched to its number of pairs."""
    out = empty(ca.shape[0], pos.device)
    buckets = manifold_buckets(shape_type, params, pos, quat, ca, cb, valid, shape_pairs,
                               convex_verts)
    if not buckets:
        return out, {}
    # One scatter of every bucket's manifolds, swapped back where the inputs
    # were swapped.
    normal, p_a, p_b, sep, fid, cnt = (torch.cat(x) for x in zip(*(bk.run() for bk in buckets)))
    slots = torch.cat([bk.slots for bk in buckets])
    swap = torch.cat([bk.swap for bk in buckets])
    s2 = swap[:, None, None]
    out.normal[slots] = torch.where(swap[:, None], -normal, normal)
    out.point_a[slots] = torch.where(s2, p_b, p_a)
    out.point_b[slots] = torch.where(s2, p_a, p_b)
    out.separation[slots] = sep
    out.feature_id[slots] = fid
    out.count[slots] = cnt
    return out, {bk.pair: bk.slots.shape[0] for bk in buckets}
