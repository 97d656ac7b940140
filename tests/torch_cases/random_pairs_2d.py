"""Seeded pairs of random 2D colliders of every kind, for holding Kernel V
(``avian_tpu_torch/kernels/manifold_2d.py``) to its plain version and to the
reference: the CPU cases of ``cases_dim2.py``, the card's in
``cases_cuda.py`` and ``chip_smoke.py``'s ``dim2 kernels`` phase import it."""

import numpy as np
import torch

from avian_tpu_torch.core.device import resolve
from avian_tpu_torch.dim2.builder import _ccw, convex_hull_2d


def random_shape(rng, kind):
    """(local CCW vertices [n, 2], radius, is_plane) of one seeded shape of
    ``kind``: 0 circle (its vertex offset half the time), 1 box (rounded a
    third of the time), 2 capsule, 3 segment (a fifth of them degenerate, both
    ends equal), 4 triangle, 5 regular polygon of 3..8 sides, 6 hull of 8
    random points, 7 half-space (its normal as the vertex)."""
    if kind == 0:
        off = rng.uniform(-0.3, 0.3, 2) if rng.random() < 0.5 else np.zeros(2)
        return off[None, :], rng.uniform(0.1, 0.6), False
    if kind == 1:
        hx, hy = rng.uniform(0.1, 0.8, 2)
        r = rng.uniform(0.0, 0.1) if rng.random() < 0.3 else 0.0
        return np.array([(hx, -hy), (hx, hy), (-hx, hy), (-hx, -hy)]), r, False
    if kind == 2:
        h = rng.uniform(0.1, 0.6)
        return np.array([(0.0, -h), (0.0, h)]), rng.uniform(0.1, 0.4), False
    if kind == 3:
        a = rng.uniform(-0.8, 0.8, 2)
        b = a.copy() if rng.random() < 0.2 else rng.uniform(-0.8, 0.8, 2)
        return np.stack([a, b]), 0.0, False
    if kind == 4:
        return _ccw(rng.uniform(-0.8, 0.8, (3, 2))), 0.0, False
    if kind == 5:
        sides = int(rng.integers(3, 9))
        rad = rng.uniform(0.2, 0.8)
        ang = 2 * np.pi * np.arange(sides) / sides
        r = rng.uniform(0.0, 0.1) if rng.random() < 0.3 else 0.0
        return np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1), r, False
    if kind == 6:
        return convex_hull_2d(rng.uniform(-0.8, 0.8, (8, 2))), 0.0, False
    theta = rng.uniform(0.0, 2 * np.pi)
    return np.array([(np.cos(theta), np.sin(theta))]), 0.0, True


def random_pairs(k: int, seed: int = 0, kinds=None, device=None):
    """``k`` seeded pairs of random 2D colliders of every kind
    (``random_shape``), for holding Kernel V to its plain version and the
    reference. A pair's second collider lies within reach of the first, a
    quarter of them turned by at most 1e-3 rad against it (near-parallel
    faces). ``kinds`` i64[k, 2] fixes the pairs' kinds. Returns
    ``(ca i64[k], cb i64[k], tables)``, ``tables`` a dict of the 2k
    colliders' ``pos`` f32[2k, 2], ``angle`` f32[2k], ``verts`` f32[2k, 8, 2],
    ``count`` i32[2k], ``radius`` f32[2k] and ``plane`` bool[2k]."""
    device = resolve(device)
    rng = np.random.default_rng(seed)
    if kinds is None:
        kinds = rng.integers(0, 8, (k, 2))
    verts = np.zeros((2 * k, 8, 2), np.float32)
    count = np.ones(2 * k, np.int32)
    radius = np.zeros(2 * k, np.float32)
    plane = np.zeros(2 * k, bool)
    pos = np.zeros((2 * k, 2), np.float32)
    angle = np.zeros(2 * k, np.float32)
    for i in range(k):
        base = rng.uniform(-50.0, 50.0, 2)
        a0 = rng.uniform(-np.pi, np.pi)
        parallel = rng.random() < 0.25
        for side, slot in ((0, i), (1, k + i)):
            v, r, is_plane = random_shape(rng, int(kinds[i, side]))
            n = v.shape[0]
            verts[slot, :n] = v
            verts[slot, n:] = v[-1]
            count[slot], radius[slot], plane[slot] = n, r, is_plane
            pos[slot] = base + (rng.uniform(-1.2, 1.2, 2) if side else 0.0)
            angle[slot] = (a0 + rng.uniform(-1e-3, 1e-3) if parallel
                           else rng.uniform(-np.pi, np.pi))
    tables = dict(pos=pos, angle=angle, verts=verts, count=count, radius=radius, plane=plane)
    tables = {key: torch.from_numpy(val).to(device) for key, val in tables.items()}
    idx = torch.arange(k, device=device)
    return idx, idx + k, tables
