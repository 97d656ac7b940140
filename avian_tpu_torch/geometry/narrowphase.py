"""Contact manifolds for the pair buffer (port of the parts of
``avian_tpu/geometry/narrowphase.py`` the slice needs).

The reference evaluates every listed pair function on every slot under
``vmap`` + ``lax.switch``. Here pairs are bucketed by canonical shape code
and each bucket that holds pairs gets one launch of Kernel A
(``kernels/box_manifold.py``): box/box and box/plane. Inputs are swapped
into canonical order (type_a <= type_b) first and the results swapped back,
as the reference does (narrowphase.py:470-534). Any other pair that
reaches the narrowphase raises ``NotImplementedError``.

Conventions: ``normal`` points from A to B, ``separation`` is negative when
penetrating, 4 points per manifold.
"""

from dataclasses import dataclass

import torch

from avian_tpu_torch.core.types import ShapeType
from avian_tpu_torch.kernels import box_manifold as ka
from avian_tpu_torch.math import quat as quat_m
from avian_tpu_torch.math import vec

MAX_POINTS = 4
SUPPORTED_PAIRS = ((int(ShapeType.BOX), int(ShapeType.BOX)),
                   (int(ShapeType.BOX), int(ShapeType.PLANE)))
_KIND = {SUPPORTED_PAIRS[0]: ka.BOX_BOX, SUPPORTED_PAIRS[1]: ka.BOX_PLANE}
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


def allowed_pairs(shape_pairs):
    """The canonical pairs the narrowphase may evaluate (``None`` = all)."""
    if shape_pairs is None:
        return set(SUPPORTED_PAIRS)
    return {(int(a), int(b)) for a, b in shape_pairs}


@dataclass(frozen=True)
class Bucket:
    """The pairs of one canonical shape pair, ready for Kernel A."""

    kind: int
    slots: torch.Tensor  # i64[K] pair-buffer slots
    swap: torch.Tensor   # bool[K] inputs were swapped into canonical order
    inputs: tuple        # (pa, qa, ha, pb, qb, hb), contiguous f32


def manifold_buckets(shape_type, params, pos, quat, ca, cb, valid,
                     shape_pairs=None):
    """Bucket the valid pairs by canonical shape pair (one host read of the
    bucket sizes). Raises for a pair the port does not support; skips pairs
    outside ``shape_pairs``."""
    ta = shape_type[ca.long()]
    tb = shape_type[cb.long()]
    swap = ta > tb
    lo = torch.minimum(ta, tb).long()
    hi = torch.maximum(ta, tb).long()
    code = torch.where(valid, lo * _NUM_TYPES + hi, -1)
    counts = torch.bincount(code[valid], minlength=_NUM_TYPES * _NUM_TYPES).tolist()
    allowed = allowed_pairs(shape_pairs)
    buckets = []
    for flat, n_pairs in enumerate(counts):
        if n_pairs == 0:
            continue
        pair = divmod(flat, _NUM_TYPES)
        if pair not in SUPPORTED_PAIRS:
            raise NotImplementedError(
                f"shape pair {ShapeType(pair[0]).name}/{ShapeType(pair[1]).name}"
                " is not ported yet (box/box and box/plane are)"
            )
        if pair not in allowed:
            continue
        slots = torch.nonzero(code == flat, as_tuple=True)[0]
        sw = swap[slots]
        c_a = torch.where(sw, cb[slots], ca[slots]).long()
        c_b = torch.where(sw, ca[slots], cb[slots]).long()
        inputs = (
            pos[c_a].contiguous(), quat[c_a].contiguous(),
            params[c_a, :3].contiguous(),
            pos[c_b].contiguous(), quat[c_b].contiguous(),
            params[c_b, :3].contiguous(),
        )
        buckets.append(Bucket(_KIND[pair], slots, sw, inputs))
    return buckets


def compute_manifolds(shape_type, params, pos, quat, ca, cb, valid,
                      shape_pairs=None):
    """Manifolds for every slot of the pair buffer.

    Slots that hold no pair, and pairs whose canonical shape pair is not in
    ``shape_pairs``, get the empty manifold (the reference's ``_unsupported``
    branch). Returns ``(manifold, bucket_sizes)`` where ``bucket_sizes``
    maps each Kernel A kind to the number of pairs it was launched on."""
    out = empty(ca.shape[0], pos.device)
    sizes = {}
    for bk in manifold_buckets(shape_type, params, pos, quat, ca, cb, valid,
                               shape_pairs):
        normal, p_a, p_b, sep, fid, cnt = ka.box_manifold(bk.kind, *bk.inputs)
        s1 = bk.swap[:, None]
        s2 = bk.swap[:, None, None]
        out.normal[bk.slots] = torch.where(s1, -normal, normal)
        out.point_a[bk.slots] = torch.where(s2, p_b, p_a)
        out.point_b[bk.slots] = torch.where(s2, p_a, p_b)
        out.separation[bk.slots] = sep
        out.feature_id[bk.slots] = fid
        out.count[bk.slots] = cnt
        sizes[bk.kind] = bk.slots.shape[0]
    return out, sizes
