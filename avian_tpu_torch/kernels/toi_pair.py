"""Kernel AI, ``toi_pair``: times of impact of P pairs of shapes in linear
relative motion.

Replaces ``avian_tpu/geometry/contact_query.py::time_of_impact`` (:81, loop
:95-108), which the reference runs on one pair (``vmap`` over many): 16
rounds of conservative advancement, each the narrowphase's manifold of shape
a moved to ``pos_a + rel * t`` (``rel = vel_a - vel_b``) against shape b,
advancing t by the smallest separation over the closing speed along the
normal, ``dot(dirn, n) * |rel|``, or by ``2 max_t`` where the shapes do not
close, t clamped to ``max_t * 1.01``. It returns ``(hit and t <= max_t,
t)``. Here the caller (``geometry/contact_query.py``) buckets the pairs by
canonical shape pair and launches one instance per bucket.

A pair is up to 16 manifolds (up to some 15,000 dependent f32 operations
each for a support-map pair) on its row read once, so the kernel is bound by
operations and latency. The CUDA source (``csrc/toi_pair.cuh``) gives one
thread to each pair and calls the pair's device function of Kernels A, M, N,
O, P or Q (``csrc/pair_dispatch.cuh``), as R and S do; its instances are
split over three translation units of its own by pair group. Where a pair's
shape codes were swapped into canonical order, its moving shape is the
kernel's side B and the manifold's normal is negated back to point from a
to b (``toi_pair.cuh`` says how). It follows the plain version's arithmetic
operation by operation (``-fmad=false``, IEEE ``sqrt`` and division), so the
two agree bit for bit where the hardware rounds the same.

The plain PyTorch version, ``toi_pair_twin``, runs on CPU tensors; on a CUDA
tensor the wrapper launches the kernel or raises.
"""

from typing import NamedTuple

import torch

from avian_tpu_torch.kernels.convex_manifold import _disc_table
from avian_tpu_torch.kernels.swept_toi import GROUP
from avian_tpu_torch.math import vec

ROUNDS = 16
EPS = 1e-4


class ToiTables(NamedTuple):
    """Per-pair inputs, contiguous on one device (in the entry point's
    order)."""

    type_a: torch.Tensor  # i32[P] shape codes
    type_b: torch.Tensor  # i32[P]
    pos_a: torch.Tensor   # f32[P, 3]
    quat_a: torch.Tensor  # f32[P, 4]
    prm_a: torch.Tensor   # f32[P, 8] params (a CONVEX shape indexes ``pool``)
    pos_b: torch.Tensor   # f32[P, 3]
    quat_b: torch.Tensor  # f32[P, 4]
    prm_b: torch.Tensor   # f32[P, 8]
    rel: torch.Tensor     # f32[P, 3] vel_a - vel_b
    max_t: torch.Tensor   # f32[P]
    pool: torch.Tensor    # f32[V, 3] the vertex pool


def toi_pair_twin(pair, idx, tabs: ToiTables, hit, t, iters=ROUNDS):
    """Plain PyTorch version; see ``toi_pair``. Stops once a round changes
    no pair's t or hit flag: every later round would repeat it."""
    from avian_tpu_torch.geometry.narrowphase import pair_manifold_twin

    p = idx.long()
    k_n = p.shape[0]
    swap = (tabs.type_a[p] > tabs.type_b[p])[:, None]
    pa, qa, prm_a = tabs.pos_a[p], tabs.quat_a[p], tabs.prm_a[p]
    pb, qb, prm_b = tabs.pos_b[p], tabs.quat_b[p], tabs.prm_b[p]
    rel, max_t = tabs.rel[p], tabs.max_t[p]
    lim = max_t * 1.01
    dist0 = vec.length_rn(rel)
    dirn = vec.normalize_or_rn(rel, torch.eye(3, device=p.device)[0])
    # The canonical sides: shape a moves, and is side B where swapped.
    qa_c, qb_c = torch.where(swap, qb, qa), torch.where(swap, qa, qb)
    prm_a_c, prm_b_c = torch.where(swap, prm_b, prm_a), torch.where(swap, prm_a, prm_b)
    tt = torch.zeros((k_n,), dtype=torch.float32, device=p.device)
    done = torch.zeros((k_n,), dtype=torch.bool, device=p.device)
    for _ in range(iters):
        xa = pa + rel * tt[:, None]
        normal, _, _, sep4, _, _ = pair_manifold_twin(
            pair, torch.where(swap, pb, xa), qa_c, prm_a_c, torch.where(swap, xa, pb), qb_c,
            prm_b_c, tabs.pool)
        sep = sep4.amin(1)
        approach = vec.dot(dirn, torch.where(swap, -normal, normal)) * dist0
        hit_now = sep < EPS
        step = torch.where(approach > 1e-6, sep / torch.clamp(approach, min=1e-6), 2.0 * max_t)
        new_t = torch.where(done | hit_now, tt, tt + torch.clamp(step, min=0.0))
        new_t, new_done = torch.minimum(new_t, lim), done | hit_now
        fixed = torch.equal(new_t, tt) and torch.equal(new_done, done)
        tt, done = new_t, new_done
        if fixed:
            break
    hit[p] = done & (tt <= max_t)
    t[p] = tt
    return hit, t


def toi_pair(pair, idx, tabs: ToiTables, hit, t, iters=ROUNDS, rounds=None):
    """Times of impact of the pairs ``idx`` (i32[K]) of ``tabs``, all of
    canonical shape pair ``pair``: writes each pair's hit flag into ``hit``
    (bool[P]) and its t into ``t`` (f32[P]). With ``rounds`` (i32[P], the
    kernel only) each pair's rounds are written too: the data-dependent work
    of the launch."""
    from avian_tpu_torch.geometry.narrowphase import PAIR_KERNELS
    from avian_tpu_torch.kernels import build

    if pair not in PAIR_KERNELS:
        raise ValueError(f"toi_pair: no kernel for shape pair {pair}")
    if idx.device.type == "cpu":
        if rounds is not None:
            raise ValueError("toi_pair: the plain version counts no rounds")
        return toi_pair_twin(pair, idx, tabs, hit, t, iters)
    if idx.device.type != "cuda":
        raise RuntimeError(f"toi_pair: unsupported device {idx.device}")
    dev, f32 = idx.device, torch.float32
    p_n = tabs.pos_a.shape[0]
    build.require("toi_pair", dev, [
        ("idx", idx, idx.shape, torch.int32), ("type_a", tabs.type_a, (p_n,), torch.int32),
        ("type_b", tabs.type_b, (p_n,), torch.int32), ("pos_a", tabs.pos_a, (p_n, 3), f32),
        ("quat_a", tabs.quat_a, (p_n, 4), f32), ("prm_a", tabs.prm_a, (p_n, 8), f32),
        ("pos_b", tabs.pos_b, (p_n, 3), f32), ("quat_b", tabs.quat_b, (p_n, 4), f32),
        ("prm_b", tabs.prm_b, (p_n, 8), f32), ("rel", tabs.rel, (p_n, 3), f32),
        ("max_t", tabs.max_t, (p_n,), f32), ("pool", tabs.pool, tabs.pool.shape, f32),
        ("hit", hit, (p_n,), torch.bool), ("t", t, (p_n,), f32),
    ] + ([] if rounds is None else [("rounds", rounds, (p_n,), torch.int32)]))
    if idx.shape[0]:
        group = GROUP[PAIR_KERNELS[pair][1]]
        build.launch(f"avian_toi_pair_{group}", dev, pair[0] * 16 + pair[1], idx.shape[0],
                     int(iters), idx, *tabs[:10], _disc_table(dev), tabs.pool, hit, t, rounds)
        toi_pair.launches += 1
    return hit, t


toi_pair.launches = 0
