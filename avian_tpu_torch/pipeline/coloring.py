"""Persistent constraint-graph edge coloring (port of
``avian_tpu/pipeline/coloring.py::color_constraints``).

Within a color no two constraints share a dynamic body, which is what lets
Kernel D give every row of a color its own thread with disjoint writes.
Plain PyTorch in this port: a fixed-degree CSR adjacency, validation of
carried colors, 4 proposal rounds (lowest available color, highest for
edges against a non-dynamic body, lowest edge index wins), and the overflow
color for what is left. The result equals the reference's exactly.
"""

import torch

_ASSIGN_ROUNDS = 4
MAX_DEGREE = 32


def run_rank(sorted_key):
    """Rank of each element within its run of equal sorted keys."""
    n = sorted_key.shape[0]
    idx = torch.arange(n, device=sorted_key.device)
    new_run = torch.ones((n,), dtype=torch.bool, device=sorted_key.device)
    new_run[1:] = sorted_key[1:] != sorted_key[:-1]
    return idx - torch.cummax(torch.where(new_run, idx, 0), dim=0).values


def color_constraints(body_a, body_b, dyn_a, dyn_b, edge_mask, n_bodies,
                      max_colors, prev_color=None):
    """Assign a color in [0, max_colors) to each edge; returns
    ``(color i32[E], is_overflow bool[E])``."""
    e = body_a.shape[0]
    d = MAX_DEGREE
    dev = body_a.device
    assignable = max_colors - 1
    edge_idx = torch.arange(e, device=dev)

    # ---- fixed-degree CSR adjacency -------------------------------------
    bodies2 = torch.cat([body_a, body_b]).long()
    edge2 = torch.cat([edge_idx, edge_idx])
    inc_ok = torch.cat([edge_mask & dyn_a, edge_mask & dyn_b])
    key = torch.where(inc_ok, bodies2, n_bodies)
    sorted_key, order = torch.sort(key, stable=True)
    rank = run_rank(sorted_key)
    slot_ok = (rank < d) & (sorted_key < n_bodies)
    slot = torch.clamp(sorted_key, 0, n_bodies - 1) * d + rank
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
    for _ in range(_ASSIGN_ROUNDS):
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
