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

Scenes. The inputs are B scenes, B = 1 for a single world and B > 1 for
the flat world that ``parallel.make_batched_step`` steps: the globals are
``g_idx`` [B, G] (each scene's own, lowest index first), the sorted entries
B equal runs (Kernel E's keys put the scene first), the colliders B runs of
M / B, and the slots B runs of ``c_cap`` each. The dense pass tests each
scene's globals against its own colliders only, and each scene's slots hold
its grid pairs and then its global pairs in the reference's order, with its
own ``num_pairs`` and ``dropped`` (i32[B]); what ``jax.vmap`` of the
reference gives each scene. An empty slot holds its scene's first collider.

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
    num_pairs: torch.Tensor   # i32[B]
    dropped: torch.Tensor     # i32[B]


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
    """bool[B, G, M / B]: the global pass's candidate test of each scene's
    globals ``g_idx`` [B, G] against its own colliders."""
    b = g_idx.shape[0]
    m_s = col.active.shape[0] // b
    cand = (torch.arange(b, device=g_idx.device)[:, None] * m_s
            + torch.arange(m_s, device=g_idx.device))
    gi, ci = g_idx.reshape(b, -1, 1), cand[:, None, :]
    overlap = ((col.aabb_min[gi] <= col.aabb_max[ci])
               & (col.aabb_min[ci] <= col.aabb_max[gi])).all(dim=-1)
    mem, fil = col.members, col.filter
    ok = (
        g_valid.reshape(b, -1, 1)
        & col.active[ci]
        & (gi != ci)
        & (~col.is_global[ci] | (ci < gi))
        & overlap
        & (col.body[gi] != col.body[ci])
        & ((mem[gi] & fil[ci]) != 0)
        & ((mem[ci] & fil[gi]) != 0)
        & (col.dyn[gi] | col.dyn[ci])
    )
    return ok


def compact_pairs_twin(bits, rank, skey, scol, w, col: Colliders, g_idx, g_valid,
                       global_overflow, jkeys, n_bodies, c_cap) -> Pairs:
    """Plain PyTorch version; see ``compact_pairs``."""
    dev = bits.device
    b = g_idx.shape[0]
    n_e, m = bits.shape[0], col.active.shape[0]
    e_s, m_s = n_e // b, m // b
    slots = torch.arange(c_cap, device=dev)         # a scene's slots
    base = torch.arange(b, device=dev)[:, None]     # [B, 1]
    live = (skey & SENTINEL) != SENTINEL
    window_overflow = ((rank > w) & live).reshape(b, e_s).sum(dim=1)

    # Grid pairs, output-driven: each slot finds its entry and its bit.
    shifts = torch.arange(w, device=dev)
    bitmat = (bits[:, None] >> shifts[None, :]) & 1                  # [n_e, w]
    cnt = bitmat.sum(dim=1).reshape(b, e_s)
    ends = torch.cumsum(cnt, dim=1)
    total_grid = (ends[:, -1:] if e_s
                  else torch.zeros((b, 1), dtype=torch.int64, device=dev))
    entry = torch.clamp(torch.searchsorted(ends, slots.expand(b, c_cap).contiguous(), right=True),
                        max=max(e_s - 1, 0))
    r = slots - (ends.gather(1, entry) - cnt.gather(1, entry))
    entry = entry + base * e_s
    k = (torch.cumsum(bitmat[entry], dim=-1) <= r[..., None]).sum(dim=-1) + 1
    ga = scol[entry]
    gb = scol[torch.clamp(entry + k, max=n_e - 1)]
    grid_got = slots < total_grid

    # Global pairs after the grid region, in (global, collider) order.
    gl_flat = global_ok(col, g_idx, g_valid).reshape(b, -1).long()
    gl_ends = torch.cumsum(gl_flat, dim=1)
    total_glob = gl_ends[:, -1:]
    gl_id = torch.clamp(torch.searchsorted(gl_ends, (slots - total_grid).contiguous(), right=True),
                        max=gl_flat.shape[1] - 1)
    glob_got = ~grid_got & (slots - total_grid < total_glob)

    first = base * m_s  # each scene's first collider
    g_of = g_idx.reshape(b, -1).gather(1, gl_id // m_s)
    ca = torch.where(grid_got, ga, torch.where(glob_got, first + gl_id % m_s, first)).reshape(-1)
    cb = torch.where(grid_got, gb, torch.where(glob_got, g_of, first)).reshape(-1)
    got = (grid_got | glob_got).reshape(-1)
    pba, pbb = col.body[ca].long(), col.body[cb].long()
    pkey = torch.minimum(pba, pbb) * n_bodies + torch.maximum(pba, pbb)
    got = got & ~torch.isin(pkey, jkeys)
    lo, hi = torch.minimum(ca, cb), torch.maximum(ca, cb)
    dropped = (torch.clamp(total_grid + total_glob - c_cap, min=0)[:, 0] + window_overflow
               + global_overflow)
    empty = first.expand(b, c_cap).reshape(-1)
    return Pairs(
        collider_a=torch.where(got, ca, empty).to(torch.int32),
        collider_b=torch.where(got, cb, empty).to(torch.int32),
        pair_key=torch.where(got, lo * m + hi, -1),
        valid=got,
        num_pairs=got.reshape(b, c_cap).sum(dim=1).to(torch.int32),
        dropped=dropped.to(torch.int32),
    )


def compact_pairs(bits, rank, skey, scol, w, col: Colliders, g_idx, g_valid,
                  global_overflow, jkeys, n_bodies, c_cap) -> Pairs:
    """The broadphase's pairs in ``c_cap`` slots from Kernel B's candidate
    ``bits`` i64[8M] and run ``rank`` over the sorted cell keys ``skey`` i64
    (the collider of each sorted entry in ``scol`` i64[8M]), the global pass
    of each of the B scenes' global colliders ``g_idx`` i64[B, G] (``g_valid``
    bool[B, G]; ``global_overflow`` i64[B] globals that did not fit), and the
    joint-disabled body pairs ``jkeys`` (``joint_keys``); ``c_cap`` is each
    scene's slots, B x ``c_cap`` in all (module docstring)."""
    dev = bits.device
    if dev.type == "cpu":
        return compact_pairs_twin(bits, rank, skey, scol, w, col, g_idx, g_valid,
                                  global_overflow, jkeys, n_bodies, c_cap)
    if dev.type != "cuda":
        raise RuntimeError(f"compact_pairs: unsupported device {dev}")
    from avian_tpu_torch.kernels import build

    n_e, m, j_n = bits.shape[0], col.active.shape[0], jkeys.shape[0]
    b, g_cap = g_idx.shape
    if n_e % b or m % b:
        raise ValueError(f"compact_pairs: {n_e} entries and {m} colliders in {b} scenes")
    f32, i32, i64, u8 = torch.float32, torch.int32, torch.int64, torch.bool
    build.require("compact_pairs", dev, (
        ("bits", bits, (n_e,), torch.int64), ("rank", rank, (n_e,), i32),
        ("skey", skey, (n_e,), i64),
        ("scol", scol, (n_e,), i64), ("aabb_min", col.aabb_min, (m, 3), f32),
        ("aabb_max", col.aabb_max, (m, 3), f32), ("active", col.active, (m,), u8),
        ("is_global", col.is_global, (m,), u8), ("dyn", col.dyn, (m,), u8),
        ("body", col.body, (m,), i32), ("members", col.members, (m,), i32),
        ("filter", col.filter, (m,), i32), ("g_idx", g_idx, (b, g_cap), i64),
        ("g_valid", g_valid, (b, g_cap), u8), ("global_overflow", global_overflow, (b,), i64),
        ("jkeys", jkeys, (j_n,), i64),
    ))
    if n_e == 0 or g_cap == 0 or c_cap == 0:
        raise ValueError("compact_pairs: needs grid entries, a global slot and a pair slot")
    cnt = torch.empty((n_e,), dtype=i32, device=dev)
    gflag = torch.empty((g_cap * m,), dtype=i32, device=dev)
    window_overflow = torch.zeros((b,), dtype=i32, device=dev)
    build.launch("avian_pair_counts", dev, n_e, w, g_cap, m, b, bits, rank, skey, col.aabb_min,
                 col.aabb_max, col.active, col.is_global, col.dyn, col.body, col.members,
                 col.filter, g_idx, g_valid, cnt, gflag, window_overflow)
    compact_pairs.launches += 1
    return place_pairs(bits, cnt, gflag, window_overflow, scol, col.body, g_idx, global_overflow,
                       jkeys, n_bodies, c_cap)


def place_pairs(bits, cnt, gflag, window_overflow, scol, body, g_idx, global_overflow, jkeys,
                n_bodies, c_cap) -> Pairs:
    """Steps 2-4 above, from a sweep's candidate ``bits`` i64[E] and their
    popcounts ``cnt`` i32[E], the global candidates' flags ``gflag``
    i32[B * G * M / B] and each scene's count of window overflows
    ``window_overflow`` i32[B]: the launches of ``pair_slots`` and
    ``pair_finish`` on CUDA tensors, counted as this kernel's. Kernel U
    (``grid_pairs_2d``) shares them."""
    dev = bits.device
    from avian_tpu_torch.kernels import build

    n_e, m, j_n = bits.shape[0], body.shape[0], jkeys.shape[0]
    b, g_cap = g_idx.shape
    gm = g_cap * m
    i32, i64, u8 = torch.int32, torch.int64, torch.bool
    ends = torch.cumsum(cnt, dim=0, dtype=i32)
    gl_ends = torch.cumsum(gflag, dim=0, dtype=i32)
    c_all = b * c_cap
    ca_tmp = torch.empty((c_all,), dtype=i32, device=dev)
    cb_tmp = torch.empty((c_all,), dtype=i32, device=dev)
    build.launch("avian_pair_slots", dev, n_e, g_cap, m, c_cap, b, bits, cnt, ends, scol, gflag,
                 gl_ends, g_idx, ca_tmp, cb_tmp)
    compact_pairs.launches += 1
    out = Pairs(
        collider_a=torch.empty((c_all,), dtype=i32, device=dev),
        collider_b=torch.empty((c_all,), dtype=i32, device=dev),
        pair_key=torch.empty((c_all,), dtype=i64, device=dev),
        valid=torch.empty((c_all,), dtype=u8, device=dev),
        num_pairs=torch.zeros((b,), dtype=i32, device=dev),
        dropped=torch.empty((b,), dtype=i32, device=dev),
    )
    build.launch("avian_pair_finish", dev, c_cap, n_e, gm, m, b, n_bodies, j_n, ends, gl_ends,
                 ca_tmp, cb_tmp, body, jkeys, window_overflow, global_overflow, *out)
    compact_pairs.launches += 1
    return out


compact_pairs.launches = 0
