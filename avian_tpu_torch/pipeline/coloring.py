"""Persistent constraint-graph edge coloring (port of
``avian_tpu/pipeline/coloring.py::color_constraints``).

Within a color no two constraints share a dynamic body, which is what lets
Kernel D give every row of a color its own thread with disjoint writes.
The work is Kernel G (``kernels/color_edges.py``): a fixed-degree adjacency,
validation of carried colors, 4 proposal rounds (lowest available color,
highest for edges against a non-dynamic body, lowest edge index wins), and
the overflow color for what is left. The result equals the reference's
exactly.
"""

from avian_tpu_torch.kernels import color_edges as kg

MAX_DEGREE = kg.MAX_DEGREE


def color_constraints(body_a, body_b, dyn_a, dyn_b, edge_mask, n_bodies,
                      max_colors, prev_color=None):
    """Assign a color in [0, max_colors) to each edge; returns
    ``(color i32[E], is_overflow bool[E])``."""
    return kg.color_edges(
        body_a, body_b, dyn_a, dyn_b, edge_mask, n_bodies, max_colors, prev_color
    )
