"""Kernel L, ``compact_pairs``: the broadphase after the sweep.

Replaces the compaction, the dense pass of the global colliders, the
joint-disabled probe and the pair keys of
``avian_tpu/pipeline/broadphase.py::broad_phase`` (:347-466):

1. ``pair_counts`` (one thread per grid entry, and one per (global
   collider, collider) candidate): the population count of each entry's
   candidate bits from Kernel B, the entries whose rank in their cell run
   exceeds the window (an int32 ``atomicAdd``, order-free), and the global
   pass's test of every candidate: active, not itself, each global pair
   once, AABB overlap, other body, layers, one side dynamic;
2. two ``torch.cumsum`` (the reference's ``jnp.cumsum``) give every grid
   entry and every accepted global candidate its first output slot;
3. ``pair_slots`` writes the grid pairs in (entry, bit) order, then the
   global pairs after the grid region in (global, collider) order;
4. ``pair_finish`` (one thread per slot): the joint-disabled probe, a binary
   search of the slot's body-pair key in the sorted keys of the active
   ``collision_disabled`` joints (the reference compares ``[C] x [J]``:
   1.6e9 tests at 10k bodies), then the canonical pair key, ``valid``,
   ``num_pairs`` (an int32 ``atomicAdd``) and ``dropped``.

All on the device: no ``nonzero``, no read to the host. Slots, keys and
``dropped`` equal the reference's exactly, which the narrowphase's key join
needs. On the H100 every launch is bound by bytes (a few per entry and per
slot) and by launch latency at these sizes.

The plain PyTorch version, ``compact_pairs_twin``, follows the reference's
output-driven dataflow (run expansion by ``searchsorted``, the r-th set bit
by a prefix count) and runs on CPU tensors; on a CUDA tensor the wrapper
launches the kernels or raises.
"""

from typing import NamedTuple

import torch

SENTINEL = 2**31 - 1
NO_JOINT_KEY = 2**63 - 1


class Pairs(NamedTuple):
    collider_a: torch.Tensor  # i32[C]
    collider_b: torch.Tensor  # i32[C]
    pair_key: torch.Tensor    # i64[C]; -1 for empty slots
    valid: torch.Tensor       # bool[C]
    num_pairs: torch.Tensor   # i32[]
    dropped: torch.Tensor     # i32[]


class Colliders(NamedTuple):
    """What the global pass reads per collider."""

    aabb_min: torch.Tensor    # f32[M, 3]
    aabb_max: torch.Tensor    # f32[M, 3]
    active: torch.Tensor      # bool[M]
    is_global: torch.Tensor   # bool[M]
    dyn: torch.Tensor         # bool[M]
    body: torch.Tensor        # i32[M]
    members: torch.Tensor     # i32[M]
    filter: torch.Tensor      # i32[M]


def joint_keys(joints, n_bodies):
    """i64[J]: sorted body-pair keys ``min * N + max`` of the active
    ``collision_disabled`` joints, ``NO_JOINT_KEY`` for the others."""
    a, b = joints.body_a.long(), joints.body_b.long()
    key = torch.minimum(a, b) * n_bodies + torch.maximum(a, b)
    key = torch.where(joints.active & joints.collision_disabled, key, NO_JOINT_KEY)
    return torch.sort(key).values.contiguous()


def global_ok(col: Colliders, g_idx, g_valid):
    """bool[G, M]: the global pass's candidate test."""
    m = col.active.shape[0]
    all_i = torch.arange(m, device=g_idx.device)
    overlap = (
        (col.aabb_min[g_idx][:, None, :] <= col.aabb_max[None, :, :])
        & (col.aabb_min[None, :, :] <= col.aabb_max[g_idx][:, None, :])
    ).all(dim=-1)
    mem, fil = col.members, col.filter
    return (
        g_valid[:, None]
        & col.active[None, :]
        & (g_idx[:, None] != all_i[None, :])
        & (~col.is_global[None, :] | (all_i[None, :] < g_idx[:, None]))
        & overlap
        & (col.body[g_idx][:, None] != col.body[None, :])
        & ((mem[g_idx][:, None] & fil[None, :]) != 0)
        & ((mem[None, :] & fil[g_idx][:, None]) != 0)
        & (col.dyn[g_idx][:, None] | col.dyn[None, :])
    )


def compact_pairs_twin(bits, rank, skey, scol, w, col: Colliders, g_idx, g_valid,
                       global_overflow, jkeys, n_bodies, c_cap) -> Pairs:
    """Plain PyTorch version; see ``compact_pairs``."""
    dev = bits.device
    n_e = bits.shape[0]
    m = col.active.shape[0]
    slots = torch.arange(c_cap, device=dev)
    window_overflow = ((rank > w) & (skey != SENTINEL)).sum()

    # Grid pairs, output-driven: each slot finds its entry and its bit.
    shifts = torch.arange(w, device=dev)
    bitmat = (bits[:, None] >> shifts[None, :]) & 1                  # [n_e, w]
    cnt = bitmat.sum(dim=1)
    ends = torch.cumsum(cnt, dim=0)
    total_grid = ends[-1] if n_e else torch.zeros((), dtype=torch.int64, device=dev)
    entry = torch.clamp(torch.searchsorted(ends, slots, right=True), max=max(n_e - 1, 0))
    r = slots - (ends[entry] - cnt[entry])
    k = (torch.cumsum(bitmat[entry], dim=1) <= r[:, None]).sum(dim=1) + 1
    ga = scol[entry]
    gb = scol[torch.clamp(entry + k, max=n_e - 1)]
    grid_got = slots < total_grid

    # Global pairs after the grid region, in (global, collider) order.
    gl_flat = global_ok(col, g_idx, g_valid).reshape(-1).long()
    gl_ends = torch.cumsum(gl_flat, dim=0)
    total_glob = gl_ends[-1]
    gl_id = torch.clamp(torch.searchsorted(gl_ends, slots - total_grid, right=True),
                        max=gl_flat.shape[0] - 1)
    glob_got = ~grid_got & (slots - total_grid < total_glob)

    ca = torch.where(grid_got, ga, torch.where(glob_got, gl_id % m, 0))
    cb = torch.where(grid_got, gb, torch.where(glob_got, g_idx[gl_id // m], 0))
    got = grid_got | glob_got
    pba, pbb = col.body[ca].long(), col.body[cb].long()
    pkey = torch.minimum(pba, pbb) * n_bodies + torch.maximum(pba, pbb)
    got = got & ~torch.isin(pkey, jkeys)
    lo, hi = torch.minimum(ca, cb), torch.maximum(ca, cb)
    dropped = (torch.clamp(total_grid + total_glob - c_cap, min=0) + window_overflow
               + global_overflow)
    return Pairs(
        collider_a=torch.where(got, ca, 0).to(torch.int32),
        collider_b=torch.where(got, cb, 0).to(torch.int32),
        pair_key=torch.where(got, lo * m + hi, -1),
        valid=got,
        num_pairs=got.sum().to(torch.int32),
        dropped=dropped.to(torch.int32),
    )


def compact_pairs(bits, rank, skey, scol, w, col: Colliders, g_idx, g_valid,
                  global_overflow, jkeys, n_bodies, c_cap) -> Pairs:
    """The broadphase's pairs in ``c_cap`` slots from Kernel B's candidate
    ``bits`` i64[8M] and run ``rank`` over the sorted cell keys ``skey`` (the
    collider of each sorted entry in ``scol`` i64[8M]), the global pass of
    the ``g_idx`` i64[G] colliders (``g_valid`` bool[G]; ``global_overflow``
    i64[] globals that did not fit), and the joint-disabled body pairs
    ``jkeys`` (``joint_keys``)."""
    dev = bits.device
    if dev.type == "cpu":
        return compact_pairs_twin(bits, rank, skey, scol, w, col, g_idx, g_valid,
                                  global_overflow, jkeys, n_bodies, c_cap)
    if dev.type != "cuda":
        raise RuntimeError(f"compact_pairs: unsupported device {dev}")
    from avian_tpu_torch.kernels import build

    n_e, m, g_cap, j_n = bits.shape[0], col.active.shape[0], g_idx.shape[0], jkeys.shape[0]
    f32, i32, i64, u8 = torch.float32, torch.int32, torch.int64, torch.bool
    build.require("compact_pairs", dev, (
        ("bits", bits, (n_e,), torch.int64), ("rank", rank, (n_e,), i32),
        ("skey", skey, (n_e,), i32),
        ("scol", scol, (n_e,), i64), ("aabb_min", col.aabb_min, (m, 3), f32),
        ("aabb_max", col.aabb_max, (m, 3), f32), ("active", col.active, (m,), u8),
        ("is_global", col.is_global, (m,), u8), ("dyn", col.dyn, (m,), u8),
        ("body", col.body, (m,), i32), ("members", col.members, (m,), i32),
        ("filter", col.filter, (m,), i32), ("g_idx", g_idx, (g_cap,), i64),
        ("g_valid", g_valid, (g_cap,), u8), ("global_overflow", global_overflow, (), i64),
        ("jkeys", jkeys, (j_n,), i64),
    ))
    if n_e == 0 or g_cap == 0 or c_cap == 0:
        raise ValueError("compact_pairs: needs grid entries, a global slot and a pair slot")
    gm = g_cap * m
    cnt = torch.empty((n_e,), dtype=i32, device=dev)
    gflag = torch.empty((gm,), dtype=i32, device=dev)
    window_overflow = torch.zeros((), dtype=i32, device=dev)
    build.launch("avian_pair_counts", dev, n_e, w, g_cap, m, bits, rank, skey, col.aabb_min,
                 col.aabb_max, col.active, col.is_global, col.dyn, col.body, col.members,
                 col.filter, g_idx, g_valid, cnt, gflag, window_overflow)
    compact_pairs.launches += 1
    return place_pairs(bits, cnt, gflag, window_overflow, scol, col.body, g_idx, global_overflow,
                       jkeys, n_bodies, c_cap)


def place_pairs(bits, cnt, gflag, window_overflow, scol, body, g_idx, global_overflow, jkeys,
                n_bodies, c_cap) -> Pairs:
    """Steps 2-4 above, from a sweep's candidate ``bits`` i64[E] and their
    popcounts ``cnt`` i32[E], the global candidates' flags ``gflag``
    i32[G * M] and the count of window overflows ``window_overflow`` i32[]:
    the launches of ``pair_slots`` and ``pair_finish`` on CUDA tensors,
    counted as this kernel's. Kernel U (``grid_pairs_2d``) shares them."""
    dev = bits.device
    from avian_tpu_torch.kernels import build

    n_e, m, g_cap, j_n = bits.shape[0], body.shape[0], g_idx.shape[0], jkeys.shape[0]
    gm = g_cap * m
    i32, i64, u8 = torch.int32, torch.int64, torch.bool
    ends = torch.cumsum(cnt, dim=0, dtype=i32)
    gl_ends = torch.cumsum(gflag, dim=0, dtype=i32)
    ca_tmp = torch.empty((c_cap,), dtype=i32, device=dev)
    cb_tmp = torch.empty((c_cap,), dtype=i32, device=dev)
    build.launch("avian_pair_slots", dev, n_e, g_cap, m, c_cap, bits, cnt, ends, scol, gflag,
                 gl_ends, g_idx, ca_tmp, cb_tmp)
    compact_pairs.launches += 1
    out = Pairs(
        collider_a=torch.empty((c_cap,), dtype=i32, device=dev),
        collider_b=torch.empty((c_cap,), dtype=i32, device=dev),
        pair_key=torch.empty((c_cap,), dtype=i64, device=dev),
        valid=torch.empty((c_cap,), dtype=u8, device=dev),
        num_pairs=torch.zeros((), dtype=i32, device=dev),
        dropped=torch.empty((), dtype=i32, device=dev),
    )
    build.launch("avian_pair_finish", dev, c_cap, n_e, gm, m, n_bodies, j_n, ends, gl_ends,
                 ca_tmp, cb_tmp, body, jkeys, window_overflow, global_overflow, *out)
    compact_pairs.launches += 1
    return out


compact_pairs.launches = 0
