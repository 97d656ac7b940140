"""Kernel S, ``shape_cast``: how far a shape travels along a ray before it
touches each collider.

Replaces the per-collider conservative advancement of
``avian_tpu/queries/shapecast.py::_sweep_all`` (:59, loop :92-121), which
the reference runs on every collider under ``vmap`` + ``lax.switch``: 16
rounds of the narrowphase's manifold between the query shape at
``origin + direction * t`` and the collider, advancing t by the smallest
separation over the closing speed along the normal, then one more manifold
at t for the witness points (of the first smallest separation) and the
normal. Here the caller (``queries/shapecast.py``) buckets the colliders by
the canonical pair of (query shape, collider shape) and launches one
instance per bucket.

A collider is up to 17 manifolds (up to some 15,000 dependent f32
operations each for a support-map pair) on its row read once, so the kernel
is bound by operations and latency. The CUDA source
(``csrc/shape_cast.cuh``) gives one thread to each collider and calls the
pair's device function of Kernels A, M, N, O, P or Q
(``csrc/pair_dispatch.cuh``); its instances are split over three
translation units by pair group. It follows the plain version's arithmetic
operation by operation (``-fmad=false``, IEEE ``sqrt`` and division), so
the two agree bit for bit where the hardware rounds the same.

The query is one f32[20] tensor: origin (3), rotation (4), unit direction
(3), the shape's params padded to 8 lanes (a CONVEX query shape indexes the
world's vertex pool through lanes 0 and 1), ``max_distance`` and
``max_distance + 1`` (each rounded once to f32, as the reference's weakly
typed Python floats are).

Its overlap mode, ``shape_overlap``, replaces the per-collider manifold of
``avian_tpu/queries/intersect.py::shape_intersections`` (:27, ``one`` :45):
no round, one manifold of the query shape at its origin against each of the
bucket's colliders, and whether it has a point of negative separation. It
launches the same instances with a flag, one manifold a thread on the
collider's row, bound by operations like a round of a cast.

Its manifold mode, ``shape_manifold``, replaces the per-collider manifold of
``avian_tpu/character/move_and_slide.py::depenetrate`` (:57, ``against``
:77, under ``vmap`` :87-89): the same one manifold, and the smallest of its
four separations and its normal (from the query shape to the collider),
which the depenetration's push reads. It is the 3D counterpart of the 0-round
launch of Kernel AE (``dim2/queries.py::manifold_vs_all``).

The plain PyTorch versions, ``shape_cast_twin``, ``shape_overlap_twin`` and
``shape_manifold_twin``, run on CPU tensors; on a CUDA tensor the wrappers
launch the kernel or raise.
"""

from typing import NamedTuple

import torch

from avian_tpu_torch.kernels.contact_rows import first_argmax
from avian_tpu_torch.kernels.convex_manifold import _disc_table
from avian_tpu_torch.kernels.swept_toi import GROUP
from avian_tpu_torch.math import vec

ROUNDS = 16
BIG = 1e30
EPS = 1e-4
QUERY_LEN = 20
# The kernel's modes (its ``overlap`` argument).
CAST, OVERLAP, MANIFOLD = 0, 1, 2
# The separation of the empty manifold (``geometry/narrowphase.py::empty``):
# what the manifold mode leaves at colliders outside every bucket.
EMPTY_SEP = 1e9


class CastOut(NamedTuple):
    """Per-collider results, written at the bucket's colliders."""

    t: torch.Tensor    # f32[M] travel distance
    hit: torch.Tensor  # bool[M] touched within max_distance
    pa: torch.Tensor   # f32[M, 3] witness on the query shape
    pb: torch.Tensor   # f32[M, 3] witness on the collider
    n: torch.Tensor    # f32[M, 3] normal from the query shape to the collider


def _manifold_at(pair, c, st, query, pos, quat, params, shape_type, pool):
    """``(swap bool[K, 1], manifold(qp))``: the pair manifold of the query
    shape at positions ``qp`` [K, 3] against the colliders ``c``, canonical
    sides swapped where the collider's shape code is the lower."""
    from avian_tpu_torch.geometry.narrowphase import pair_manifold_twin

    k_n = c.shape[0]
    swap = (st > shape_type[c])[:, None]
    rot, qprm = query[3:7].expand(k_n, 4), query[10:18].expand(k_n, 8)
    cp, cq, cprm = pos[c], quat[c], params[c]

    def manifold(qp):
        return pair_manifold_twin(
            pair, torch.where(swap, cp, qp), torch.where(swap, cq, rot),
            torch.where(swap, cprm, qprm), torch.where(swap, qp, cp), torch.where(swap, rot, cq),
            torch.where(swap, qprm, cprm), pool)

    return swap, manifold


def shape_cast_twin(pair, cols, st, query, pos, quat, params, shape_type, pool, out: CastOut):
    """Plain PyTorch version; see ``shape_cast``. Stops once a round changes
    no collider's t or hit flag: every later round would repeat it."""
    c = cols.long()
    k_n = c.shape[0]
    swap, at = _manifold_at(pair, c, st, query, pos, quat, params, shape_type, pool)
    o, d = query[0:3], query[7:10]
    max_d, lim = query[18], query[19]

    def manifold(t):
        return at(o + d * t[:, None])

    t = torch.zeros((k_n,), dtype=torch.float32, device=c.device)
    done = torch.zeros((k_n,), dtype=torch.bool, device=c.device)
    for k in range(ROUNDS):
        normal, _, _, sep4, _, _ = manifold(t)
        sep = sep4.amin(1)
        approach = vec.dot(d.expand(k_n, 3), torch.where(swap, -normal, normal))
        hit_now = sep < EPS
        step = torch.where(approach > 1e-6, sep / torch.clamp(approach, min=1e-6), BIG)
        new_t = torch.where(done | hit_now, t, t + torch.clamp(step, min=0.0))
        new_t, new_done = torch.minimum(new_t, lim), done | hit_now
        fixed = torch.equal(new_t, t) and torch.equal(new_done, done)
        t, done = new_t, new_done
        if fixed:
            break
    normal, p_a, p_b, sep4, _, _ = manifold(t)
    pi = first_argmax(-sep4)[:, None, None].expand(-1, 1, 3)
    p_a, p_b = p_a.gather(1, pi)[:, 0], p_b.gather(1, pi)[:, 0]
    out.t[c] = t
    out.hit[c] = done & (t <= max_d)
    out.pa[c] = torch.where(swap, p_b, p_a)
    out.pb[c] = torch.where(swap, p_a, p_b)
    out.n[c] = torch.where(swap, -normal, normal)
    return out


def _launch(what, mode, pair, cols, st, query, pos, quat, params, shape_type, pool,
            out: CastOut, rounds):
    """Check the tensors and launch S's instance of ``pair`` on the CUDA
    tensors in ``mode`` (``CAST``, ``OVERLAP`` or ``MANIFOLD``); False where
    ``cols`` is empty and nothing was launched."""
    from avian_tpu_torch.geometry.narrowphase import PAIR_KERNELS
    from avian_tpu_torch.kernels import build

    if cols.device.type != "cuda":
        raise RuntimeError(f"{what}: unsupported device {cols.device}")
    dev, f32 = cols.device, torch.float32
    m = pos.shape[0]
    build.require(what, dev, [
        ("cols", cols, cols.shape, torch.int32), ("query", query, (QUERY_LEN,), f32),
        ("pos", pos, (m, 3), f32), ("quat", quat, (m, 4), f32), ("params", params, (m, 8), f32),
        ("shape_type", shape_type, (m,), torch.int32), ("pool", pool, pool.shape, f32),
        ("t", out.t, (m,), f32), ("hit", out.hit, (m,), torch.bool),
        ("pa", out.pa, (m, 3), f32), ("pb", out.pb, (m, 3), f32), ("n", out.n, (m, 3), f32),
    ] + ([] if rounds is None else [("rounds", rounds, (m,), torch.int32)]))
    if not cols.shape[0]:
        return False
    group = GROUP[PAIR_KERNELS[pair][1]]
    build.launch(f"avian_shape_cast_{group}", dev, pair[0] * 16 + pair[1], cols.shape[0],
                 int(st), mode, cols, query, pos, quat, params, shape_type,
                 _disc_table(dev), pool, *out, rounds)
    return True


def shape_cast(pair, cols, st, query, pos, quat, params, shape_type, pool, out: CastOut,
               rounds=None):
    """Cast the query shape of type ``st`` (``query`` f32[20], see above)
    against the colliders ``cols`` (i32[K]), all of canonical shape pair
    ``pair`` with it; ``pos`` f32[M, 3], ``quat`` f32[M, 4], ``params``
    f32[M, 8] and ``shape_type`` i32[M] are the colliders', ``pool`` the
    vertex pool. Writes each collider's results into ``out``. A collider
    stops once it has hit; one more manifold follows. With ``rounds``
    (i32[M], the kernel only) each collider's rounds of advancement are
    written too: the data-dependent work of the launch."""
    from avian_tpu_torch.geometry.narrowphase import PAIR_KERNELS

    if pair not in PAIR_KERNELS:
        raise ValueError(f"shape_cast: no kernel for shape pair {pair}")
    if cols.device.type == "cpu":
        if rounds is not None:
            raise ValueError("shape_cast: the plain version counts no rounds")
        return shape_cast_twin(pair, cols, st, query, pos, quat, params, shape_type, pool, out)
    if _launch("shape_cast", CAST, pair, cols, st, query, pos, quat, params, shape_type, pool,
               out, rounds):
        shape_cast.launches += 1
    return out


shape_cast.launches = 0


def shape_overlap_twin(pair, cols, st, query, pos, quat, params, shape_type, pool, hit):
    """Plain PyTorch version; see ``shape_overlap``."""
    c = cols.long()
    _, at = _manifold_at(pair, c, st, query, pos, quat, params, shape_type, pool)
    _, _, _, sep4, _, count = at(query[0:3].expand(c.shape[0], 3))
    hit[c] = (count > 0) & (sep4.amin(1) < 0.0)
    return hit


def shape_overlap(pair, cols, st, query, pos, quat, params, shape_type, pool, out: CastOut):
    """Overlap mode of ``shape_cast``: whether the query shape at its origin
    (``query``'s rotation and params; its direction and distances unread)
    and each collider of ``cols`` have a manifold point of negative
    separation, written into ``out.hit``; nothing else of ``out`` is
    written."""
    from avian_tpu_torch.geometry.narrowphase import PAIR_KERNELS

    if pair not in PAIR_KERNELS:
        raise ValueError(f"shape_overlap: no kernel for shape pair {pair}")
    if cols.device.type == "cpu":
        shape_overlap_twin(pair, cols, st, query, pos, quat, params, shape_type, pool, out.hit)
        return out
    if _launch("shape_overlap", OVERLAP, pair, cols, st, query, pos, quat, params, shape_type, pool,
               out, None):
        shape_overlap.launches += 1
    return out


shape_overlap.launches = 0


def shape_manifold_twin(pair, cols, st, query, pos, quat, params, shape_type, pool, out: CastOut):
    """Plain PyTorch version; see ``shape_manifold``."""
    c = cols.long()
    swap, at = _manifold_at(pair, c, st, query, pos, quat, params, shape_type, pool)
    normal, _, _, sep4, _, _ = at(query[0:3].expand(c.shape[0], 3))
    out.t[c] = sep4.amin(1)
    out.n[c] = torch.where(swap, -normal, normal)
    return out


def shape_manifold(pair, cols, st, query, pos, quat, params, shape_type, pool, out: CastOut):
    """Manifold mode of ``shape_cast``: the manifold of the query shape at
    its origin (``query``'s rotation and params; its direction and distances
    unread) and each collider of ``cols``; its smallest separation is written
    into ``out.t`` and its normal, from the query shape to the collider, into
    ``out.n``; nothing else of ``out`` is written."""
    from avian_tpu_torch.geometry.narrowphase import PAIR_KERNELS

    if pair not in PAIR_KERNELS:
        raise ValueError(f"shape_manifold: no kernel for shape pair {pair}")
    if cols.device.type == "cpu":
        return shape_manifold_twin(pair, cols, st, query, pos, quat, params, shape_type, pool,
                                   out)
    if _launch("shape_manifold", MANIFOLD, pair, cols, st, query, pos, quat, params, shape_type,
               pool, out, None):
        shape_manifold.launches += 1
    return out


shape_manifold.launches = 0
