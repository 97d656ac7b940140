"""Kernel U, ``grid_pairs_2d``: the 2D engine's grid broadphase after the sort.

Replaces ``avian_tpu/dim2/broadphase_impl.py::grid_pairs_2d`` (:23) from the
window sweep on: for every entry of the cell-sorted grid table (4 a collider)
and every ``k = 1..w`` it tests, as the reference does (:82-100), that entry
``i + k`` lies in the same cell, that this cell is the pair's canonical cell
(15 + 15-bit keys), that the AABBs overlap, that the bodies differ, that the
layer masks accept each other (``!= 0``) and that one side is dynamic, and
sets bit ``k - 1`` of a 32-bit mask; it counts the entries whose rank in
their cell run exceeds the window (:108-113); it runs the dense pass of the
at most 16 global colliders (half-spaces and colliders > 4x the median
extent, :135-172); it compacts the grid pairs in (entry, bit) order and the
global pairs after them in (global, collider) order into the C slots, drops
the pairs of bodies joined by a ``collision_disabled`` joint, and writes the
pair keys, ``num_pairs`` and ``dropped``. The window is the reference's, at
most 32, and the pairs equal the reference's as sets and in slot order.

Three launches around two ``torch.cumsum``: ``grid_counts_2d``, this
kernel's own (``csrc/grid_pairs_2d.cu``, one thread per grid entry and one
per (global, collider) candidate: the sweep, the popcount, the window
overflow as an int32 ``atomicAdd`` and the global test), then the slot and
finish kernels of Kernel L (``compact_pairs.place_pairs``), which do not
depend on the dimension, are shared, and count as L's launches. Every output slot is written by one thread, so reruns are
bitwise equal. On the H100 the sweep is bound by the loads of neighbouring
entries (4 floats and 6 ints each, shared through L1), the rest by bytes and
by launch latency.

The plain PyTorch versions, ``grid_pairs_2d_twin`` (the reference's sweep,
``sweep_2d_twin``, followed by Kernel L's plain compaction) and
``grid_counts_2d_twin``, run on CPU tensors; on a CUDA tensor the wrappers
launch the kernels or raise.
"""

import torch

from avian_tpu_torch.kernels import compact_pairs as kl

SENTINEL = 2**31 - 1
MAX_WINDOW = 32  # bits of the candidate mask
F_COLS = 4  # aabb_min(2), aabb_max(2)
I_COLS = 6  # min-cell(2), body, layer members, layer filter, dynamic


def cell_key(c):
    return ((c[..., 0] & 0x7FFF) << 15) | (c[..., 1] & 0x7FFF)


def sweep_2d_twin(skey, sf, si, w):
    """The reference's window sweep: (bits i64[n_e] with bit ``k - 1`` set
    when entry ``i + k`` pairs with entry ``i``, rank i32[n_e] of each entry
    in its cell run, capped at ``w + 1``)."""
    n_e = skey.shape[0]
    dev = skey.device
    spad_key = torch.cat([skey, torch.full((w,), SENTINEL, dtype=torch.int32, device=dev)])
    inf4 = torch.tensor([float("inf")] * 2 + [-float("inf")] * 2, device=dev)
    spad_f = torch.cat([sf, inf4.expand(w, F_COLS)])
    spad_i = torch.cat([si, torch.zeros((w, I_COLS), dtype=torch.int32, device=dev)])
    a_min, a_max = sf[:, 0:2], sf[:, 2:4]
    a_i0, a_body, a_mem, a_fil, a_dyn = si[:, 0:2], si[:, 2], si[:, 3], si[:, 4], si[:, 5]
    bits = torch.zeros((n_e,), dtype=torch.int64, device=dev)
    for k in range(1, w + 1):
        b_key = spad_key[k:k + n_e]
        b_f = spad_f[k:k + n_e]
        b_i = spad_i[k:k + n_e]
        ok = (
            (b_key == skey) & (skey != SENTINEL)
            & (cell_key(torch.maximum(a_i0, b_i[:, 0:2])) == skey)
            & ((b_f[:, 0:2] <= a_max) & (a_min <= b_f[:, 2:4])).all(dim=-1)
            & (a_body != b_i[:, 2])
            & ((a_mem & b_i[:, 4]) != 0) & ((b_i[:, 3] & a_fil) != 0)
            & ((a_dyn | b_i[:, 5]) > 0)
        )
        bits = bits | (ok.long() << (k - 1))
    idx = torch.arange(n_e, device=dev)
    new_run = torch.ones((n_e,), dtype=torch.bool, device=dev)
    new_run[1:] = skey[1:] != skey[:-1]
    run_start = torch.cummax(torch.where(new_run, idx, 0), dim=0).values
    rank = torch.clamp(idx - run_start, max=w + 1)
    return bits, rank.to(torch.int32)


def grid_pairs_2d_twin(skey, scol, sf, si, w, col: kl.Colliders, g_idx, g_valid,
                       global_overflow, jkeys, n_bodies, c_cap) -> kl.Pairs:
    """Plain PyTorch version; see ``grid_pairs_2d``."""
    bits, rank = sweep_2d_twin(skey, sf, si, w)
    return _one_scene(kl.compact_pairs_twin(bits, rank, skey, scol, w, col, g_idx[None],
                                            g_valid[None], global_overflow.reshape(1), jkeys,
                                            n_bodies, c_cap))


def _one_scene(pairs: kl.Pairs) -> kl.Pairs:
    """Kernel L's pairs of one scene with the world's 0-d counts."""
    return pairs._replace(num_pairs=pairs.num_pairs[0], dropped=pairs.dropped[0])


def grid_counts_2d_twin(skey, sf, si, w, col: kl.Colliders, g_idx, g_valid):
    """Plain PyTorch version; see ``grid_counts_2d``."""
    bits, rank = sweep_2d_twin(skey, sf, si, w)
    cnt = ((bits[:, None] >> torch.arange(w, device=bits.device)) & 1).sum(1).to(torch.int32)
    gflag = kl.global_ok(col, g_idx[None], g_valid[None]).reshape(-1).to(torch.int32)
    window_overflow = ((rank > w) & (skey != SENTINEL)).sum().to(torch.int32)
    return bits, cnt, gflag, window_overflow


def _check(skey, scol, sf, si, w, col, g_idx, g_valid, global_overflow, jkeys, c_cap):
    from avian_tpu_torch.kernels import build

    n_e, m, g_cap, j_n = skey.shape[0], col.active.shape[0], g_idx.shape[0], jkeys.shape[0]
    if not 1 <= w <= MAX_WINDOW:
        raise ValueError(f"grid_pairs_2d: window {w} outside 1..{MAX_WINDOW}")
    f32, i32, i64, u8 = torch.float32, torch.int32, torch.int64, torch.bool
    build.require("grid_pairs_2d", skey.device, (
        ("skey", skey, (n_e,), i32), ("scol", scol, (n_e,), i64),
        ("sf", sf, (n_e, F_COLS), f32), ("si", si, (n_e, I_COLS), i32),
        ("aabb_min", col.aabb_min, (m, 2), f32), ("aabb_max", col.aabb_max, (m, 2), f32),
        ("active", col.active, (m,), u8), ("is_global", col.is_global, (m,), u8),
        ("dyn", col.dyn, (m,), u8), ("body", col.body, (m,), i32),
        ("members", col.members, (m,), i32), ("filter", col.filter, (m,), i32),
        ("g_idx", g_idx, (g_cap,), i64), ("g_valid", g_valid, (g_cap,), u8),
        ("global_overflow", global_overflow, (), i64), ("jkeys", jkeys, (j_n,), i64),
    ))
    if n_e == 0 or g_cap == 0 or c_cap == 0:
        raise ValueError("grid_pairs_2d: needs grid entries, a global slot and a pair slot")


def grid_counts_2d(skey, sf, si, w, col: kl.Colliders, g_idx, g_valid):
    """The one launch of Kernel U's own source: ``(bits i64[E]`` with bit
    ``k - 1`` set when entry ``i + k`` pairs with entry ``i``, ``cnt`` i32[E]
    their popcounts, ``gflag`` i32[G * M] the accepted global candidates,
    ``window_overflow`` i32[] the entries past the window). The caller has
    checked the inputs (``grid_pairs_2d``)."""
    dev = skey.device
    if dev.type == "cpu":
        return grid_counts_2d_twin(skey, sf, si, w, col, g_idx, g_valid)
    if dev.type != "cuda":
        raise RuntimeError(f"grid_counts_2d: unsupported device {dev}")
    from avian_tpu_torch.kernels import build

    n_e, m, g_cap = skey.shape[0], col.active.shape[0], g_idx.shape[0]
    i32 = torch.int32
    bits = torch.empty((n_e,), dtype=torch.int64, device=dev)
    cnt = torch.empty((n_e,), dtype=i32, device=dev)
    gflag = torch.empty((g_cap * m,), dtype=i32, device=dev)
    window_overflow = torch.zeros((), dtype=i32, device=dev)
    build.launch("avian_grid_counts_2d", dev, n_e, w, g_cap, m, skey, sf, si, col.aabb_min,
                 col.aabb_max, col.active, col.is_global, col.dyn, col.body, col.members,
                 col.filter, g_idx, g_valid, bits, cnt, gflag, window_overflow)
    grid_counts_2d.launches += 1
    return bits, cnt, gflag, window_overflow


grid_counts_2d.launches = 0


def grid_pairs_2d(skey, scol, sf, si, w, col: kl.Colliders, g_idx, g_valid,
                  global_overflow, jkeys, n_bodies, c_cap) -> kl.Pairs:
    """The broadphase's pairs in ``c_cap`` slots.

    ``skey`` i32[4M] sorted cell keys (``SENTINEL`` for no cell), ``scol``
    i64[4M] the collider of each sorted entry, ``sf`` f32[4M, 4] and ``si``
    i32[4M, 6] its fields in sorted order, ``w`` the window (1..32); ``col``
    the colliders' columns of the global pass (2D AABBs), ``g_idx`` i64[G]
    the global colliders (``g_valid`` bool[G]; ``global_overflow`` i64[]
    globals that did not fit) and ``jkeys`` the joint-disabled body pairs
    (``compact_pairs.joint_keys``)."""
    dev = skey.device
    if dev.type == "cpu":
        return grid_pairs_2d_twin(skey, scol, sf, si, w, col, g_idx, g_valid,
                                  global_overflow, jkeys, n_bodies, c_cap)
    if dev.type != "cuda":
        raise RuntimeError(f"grid_pairs_2d: unsupported device {dev}")
    _check(skey, scol, sf, si, w, col, g_idx, g_valid, global_overflow, jkeys, c_cap)
    bits, cnt, gflag, window_overflow = grid_counts_2d(skey, sf, si, w, col, g_idx, g_valid)
    return _one_scene(kl.place_pairs(bits, cnt, gflag, window_overflow.reshape(1), scol,
                                     col.body, g_idx[None], global_overflow.reshape(1), jkeys,
                                     n_bodies, c_cap))
