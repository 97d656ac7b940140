"""Kernel G, ``color_edges``: persistent constraint-graph edge colouring and
the per-colour buckets.

Replaces ``avian_tpu/pipeline/coloring.py::color_constraints`` (:41) and
``avian_tpu/pipeline/solver.py::_bucketize`` (:127), with the run rank they
share (``kernels/run_rank.py``). Within a colour no two constraints share a
dynamic body, which is what lets Kernel D give every row of a colour its own
thread. The rules are the reference's, kept exactly, because colours feed
back through ``Contacts.color`` and one differing edge changes every later
step: a fixed-degree adjacency (the first 32 incidences of a body, in edge
order), validation of the carried colours, 4 proposal rounds (lowest free
colour of both ends, highest for an edge with a non-dynamic end, the lowest
edge index wins a conflict), and the overflow colour for what is left.

``color_edges`` is 13 launches around one ``torch.sort`` of the incidence
keys: keys, rows, init, one ``win`` to validate the carried colours, then
``propose`` and ``win`` per round, and ``finish``. The two launches of a
round read and write different arrays (proposal, then colour), so there is
no race within a launch; merging them would need a grid-wide barrier.
``bucket_edges`` is one launch after one ``torch.sort`` of the colours.

On the H100 the work is integer gathers: an edge scans the rows of its two
ends, at most 64 proposals, held in L2. The bodies' used colours are one u32
bitmask each, set with ``atomicOr`` (order-free). The plain version builds
``[N, 32, 32]`` int64 tensors for the row winner, five times a step.

The plain PyTorch versions, ``color_edges_twin`` and ``bucket_edges_twin``,
run on CPU tensors; on a CUDA tensor the wrappers launch the kernels or raise.
"""

import torch

from avian_tpu_torch.kernels.run_rank import run_rank_twin

ASSIGN_ROUNDS = 4
MAX_DEGREE = 32


def color_edges_twin(body_a, body_b, dyn_a, dyn_b, edge_mask, n_bodies,
                     max_colors, prev_color=None):
    """Plain PyTorch version; see ``color_edges``."""
    e = body_a.shape[0]
    d = MAX_DEGREE
    dev = body_a.device
    assignable = max_colors - 1
    edge_idx = torch.arange(e, device=dev)

    # ---- fixed-degree CSR adjacency -------------------------------------
    bodies2 = torch.cat([body_a, body_b]).to(torch.int32)
    edge2 = torch.cat([edge_idx, edge_idx])
    inc_ok = torch.cat([edge_mask & dyn_a, edge_mask & dyn_b])
    key = torch.where(inc_ok, bodies2, n_bodies)
    sorted_key, order = torch.sort(key, stable=True)
    rank = run_rank_twin(sorted_key)
    slot_ok = (rank < d) & (sorted_key < n_bodies)
    slot = torch.clamp(sorted_key, 0, n_bodies - 1).long() * d + rank
    table = torch.full((n_bodies * d + 1,), e, dtype=torch.int64, device=dev)
    table[torch.where(slot_ok, slot, n_bodies * d)] = edge2[order]
    body_edges = table[:-1].reshape(n_bodies, d)  # edge ids; e = empty
    fit2 = torch.zeros((2 * e,), dtype=torch.bool, device=dev)
    fit2[order] = slot_ok
    colorable = edge_mask & (~dyn_a | fit2[:e]) & (~dyn_b | fit2[e:])
    entry_slot = torch.where(slot_ok, slot, n_bodies * d)

    def unsort_entry_flag(entry_flag):
        """Map a per-CSR-slot bool [N, D] back to a per-edge conjunction."""
        flat = torch.cat(
            [entry_flag.reshape(-1), torch.ones((1,), dtype=torch.bool, device=dev)]
        )
        back = torch.zeros((2 * e,), dtype=torch.bool, device=dev)
        back[order] = torch.where(slot_ok, flat[entry_slot], True)
        return (~dyn_a | back[:e]) & (~dyn_b | back[e:])

    def row_values(per_edge, pad):
        padded = torch.cat(
            [per_edge, torch.full((1,), pad, dtype=per_edge.dtype, device=dev)]
        )
        return padded[body_edges]

    def row_winner_ok(row_val):
        """Per CSR slot: no lower-indexed edge of the row holds the same
        non-negative value."""
        same = (row_val[:, :, None] == row_val[:, None, :]) & (row_val[:, None, :] >= 0)
        cand = torch.where(same, body_edges[:, None, :], e)
        winner = cand.amin(dim=-1)
        return (row_val < 0) | (winner == body_edges)

    # ---- carry + validate persistent colors ---------------------------
    if prev_color is None:
        color = torch.full((e,), -1, dtype=torch.int64, device=dev)
    else:
        prev = prev_color.long()
        carried = torch.where(
            colorable & (prev >= 0) & (prev < assignable), prev, -1
        )
        keep = unsort_entry_flag(row_winner_ok(row_values(carried, -2)))
        color = torch.where(keep, carried, -1)

    # ---- assign new/demoted edges ----------------------------------------
    lanes = torch.arange(assignable, device=dev)
    used = (row_values(color, -2)[:, :, None] == lanes[None, None, :]).any(dim=1)
    prefer_high = ~dyn_a | ~dyn_b
    unassigned = colorable & (color < 0)
    ba, bb = body_a.long(), body_b.long()
    for _ in range(ASSIGN_ROUNDS):
        both_avail = (
            (~used[ba] | ~dyn_a[:, None])
            & (~used[bb] | ~dyn_b[:, None])
            & unassigned[:, None]
        )
        has = both_avail.any(dim=-1)
        low = torch.argmax(both_avail.to(torch.int8), dim=-1)
        high = assignable - 1 - torch.argmax(both_avail.flip(-1).to(torch.int8), dim=-1)
        prop = torch.where(has, torch.where(prefer_high, high, low), -3)
        win = unsort_entry_flag(row_winner_ok(row_values(prop, -4))) & has & unassigned
        color = torch.where(win, prop, color)
        unassigned = unassigned & ~win
        row_new = row_values(torch.where(win, prop, -5), -6)
        used = used | (row_new[:, :, None] == lanes[None, None, :]).any(dim=1)

    is_overflow = (edge_mask & ~colorable) | unassigned
    color = torch.where(color < 0, max_colors - 1, color)
    return color.to(torch.int32), is_overflow


def color_edges(body_a, body_b, dyn_a, dyn_b, edge_mask, n_bodies, max_colors,
                prev_color=None):
    """Assign a colour in ``[0, max_colors)`` to each edge.

    ``body_a``/``body_b`` i32[E] endpoints, ``dyn_a``/``dyn_b`` bool[E]
    whether that end is a dynamic body, ``edge_mask`` bool[E] the live edges,
    ``prev_color`` i32[E] last step's colours (or ``None``). Returns
    ``(color i32[E], is_overflow bool[E])``; the last colour holds what found
    no proper colour."""
    dev = body_a.device
    if dev.type == "cpu":
        return color_edges_twin(body_a, body_b, dyn_a, dyn_b, edge_mask, n_bodies,
                                max_colors, prev_color)
    if dev.type != "cuda":
        raise RuntimeError(f"color_edges: unsupported device {dev}")
    if not 1 <= max_colors <= 33:
        raise ValueError(f"color_edges: max_colors {max_colors} outside 1..33 "
                         "(the used colours of a body are one u32)")
    from avian_tpu_torch.kernels import build

    e, d, assignable = body_a.shape[0], MAX_DEGREE, max_colors - 1
    i32, u8 = torch.int32, torch.bool
    rows_in = [
        ("body_a", body_a, (e,), i32), ("body_b", body_b, (e,), i32),
        ("dyn_a", dyn_a, (e,), u8), ("dyn_b", dyn_b, (e,), u8),
        ("edge_mask", edge_mask, (e,), u8),
    ]
    if prev_color is not None:
        rows_in.append(("prev_color", prev_color, (e,), i32))
    build.require("color_edges", dev, rows_in)
    color = torch.empty((e,), dtype=i32, device=dev)
    is_overflow = torch.empty((e,), dtype=u8, device=dev)
    if e == 0:
        return color, is_overflow

    def launch(name, *args):
        build.launch(name, dev, *args)
        color_edges.launches += 1

    key = torch.empty((2 * e,), dtype=i32, device=dev)
    launch("avian_color_keys", e, n_bodies, body_a, body_b, dyn_a, dyn_b, edge_mask, key)
    skey, order = torch.sort(key, stable=True)
    rows = torch.empty((n_bodies, d), dtype=i32, device=dev)
    fit = torch.empty((2 * e,), dtype=u8, device=dev)
    used = torch.empty((n_bodies,), dtype=i32, device=dev)  # u32 bitmasks
    launch("avian_color_rows", n_bodies, 2 * e, e, d, skey, order, rows, fit, used)
    colorable = torch.empty((e,), dtype=u8, device=dev)
    prop = torch.empty((e,), dtype=i32, device=dev)
    launch("avian_color_init", e, assignable, int(prev_color is not None), dyn_a, dyn_b,
           edge_mask, fit, prev_color if prev_color is not None else color, colorable,
           prop, color)
    win = ("avian_color_win", e, d, body_a, body_b, dyn_a, dyn_b, prop, rows, color, used)
    launch(*win)  # validates the carried colours
    for _ in range(ASSIGN_ROUNDS):
        launch("avian_color_propose", e, assignable, body_a, body_b, dyn_a, dyn_b,
               colorable, color, used, prop)
        launch(*win)
    launch("avian_color_finish", e, max_colors, edge_mask, colorable, color, is_overflow)
    return color, is_overflow


color_edges.launches = 0


def bucket_edges_twin(color, active_mask, num_colors, cap):
    """Plain PyTorch version; see ``bucket_edges``."""
    c = color.shape[0]
    key = torch.where(active_mask, color, num_colors).to(torch.int32)
    sorted_key, order = torch.sort(key, stable=True)
    rank = run_rank_twin(sorted_key)
    in_cap = (rank < cap) & (sorted_key < num_colors)
    slot = torch.clamp(sorted_key, 0, num_colors - 1).long() * cap + rank
    slot = torch.where(in_cap, slot, num_colors * cap)
    flat = torch.full((num_colors * cap + 1,), c, dtype=torch.int64, device=color.device)
    flat[slot] = order
    buckets = flat[:-1].reshape(num_colors, cap)
    valid = buckets < c
    buckets = torch.where(valid, buckets, 0)
    dropped = ((sorted_key < num_colors) & ~in_cap).sum().to(torch.int32)
    num_overflow = (valid[-1].sum() + dropped).to(torch.int32)
    return buckets, valid, dropped, num_overflow


def bucket_edges(color, active_mask, num_colors, cap):
    """Fixed-capacity per-colour index buckets.

    ``color`` i32[C], ``active_mask`` bool[C]. Returns ``buckets``
    i64[colors, cap] (the active constraints of each colour in index order,
    0 in empty slots), ``valid`` bool[colors, cap], ``dropped`` i32[] (rows
    beyond a bucket's capacity) and ``num_overflow`` i32[] (rows in the last
    colour plus ``dropped``)."""
    dev = color.device
    if dev.type == "cpu":
        return bucket_edges_twin(color, active_mask, num_colors, cap)
    if dev.type != "cuda":
        raise RuntimeError(f"bucket_edges: unsupported device {dev}")
    from avian_tpu_torch.kernels import build

    c = color.shape[0]
    build.require("bucket_edges", dev, (
        ("color", color, (c,), torch.int32), ("active_mask", active_mask, (c,), torch.bool),
    ))
    key = torch.where(active_mask, color, num_colors)
    skey, order = torch.sort(key, stable=True)
    buckets = torch.empty((num_colors, cap), dtype=torch.int64, device=dev)
    valid = torch.empty((num_colors, cap), dtype=torch.bool, device=dev)
    counts = torch.empty((2,), dtype=torch.int32, device=dev)
    build.launch("avian_bucket_slots", dev, c, num_colors, cap, skey, order, buckets,
                 valid, counts)
    bucket_edges.launches += 1
    return buckets, valid, counts[0], counts[1]


bucket_edges.launches = 0
