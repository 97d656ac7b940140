"""Kernel AG, ``ray_cast_grid``: grid-accelerated first-hit ray casts, one
result per ray.

Replaces ``avian_tpu/queries/accel.py::cast_ray_grid`` (:118;
``test_collider`` :144, ``visit`` :167, the dense pass :198-203), which the
reference runs per ray under ``vmap`` (``update_ray_casters`` :269): a 3D
DDA walks ``max_cells`` cells of the query grid (Amanatides-Woo, the first
axis of the smallest ``t_max`` advancing), whatever it has hit; in each cell
a binary search of the sorted keys (``searchsorted``, left) finds the cell's
run, and its first ``cell_window`` entries are tested with Kernel T's ray
tests; then the up to 16 global colliders. A hit is taken only where
strictly nearer, so the first visited cell, and in it the first entry, wins
ties. Each ray carries its own ``max_distance`` and ``solid`` flag.

It is not the brute-force cast (``queries/raycast.py``): a cell run longer
than ``cell_window`` is cut, a hit beyond ``max_cells`` cells is missed, and
more than 16 global colliders are never tested.

A ray is 64 binary searches of some 18 steps and the tests of the entries it
meets: some 60 operations on an analytic shape, some 60,000 on a hull (T's
sphere-traced march), so the kernel is bound by operations. The CUDA kernel
(``csrc/ray_cast_grid.cu``) gives one thread to each ray, keeps the walk in
registers and calls T's device code (``csrc/ray_cast.cuh``) through a switch
on the collider's ray kind; it follows the plain version's arithmetic
operation by operation (``-fmad=false``, IEEE ``sqrt`` and division, the
first extremum on ties), so the two agree bit for bit where the hardware
rounds the same.

The plain PyTorch version, ``ray_cast_grid_twin``, runs on CPU tensors; on a
CUDA tensor the wrapper launches the kernel or raises.
"""

from typing import NamedTuple

import torch

from avian_tpu_torch.geometry import convex
from avian_tpu_torch.kernels import ray_cast as kt
from avian_tpu_torch.kernels.grid_sweep import cell_key
from avian_tpu_torch.math import quat as quat_m

BIG = kt.BIG


class GridTables(NamedTuple):
    """The query grid and the colliders, as the kernel reads them."""

    cell: torch.Tensor          # f32[] cell size
    skey: torch.Tensor          # i32[NE] sorted cell keys
    scol: torch.Tensor          # i32[NE] collider of each sorted entry
    global_idx: torch.Tensor    # i32[G] the dense pass's colliders
    global_valid: torch.Tensor  # bool[G]
    kind: torch.Tensor          # i32[M] each collider's ray kind (ray_cast.KINDS)
    ok: torch.Tensor            # bool[M] the query filter's mask
    pos: torch.Tensor           # f32[M, 3]
    quat: torch.Tensor          # f32[M, 4]
    params: torch.Tensor        # f32[M, 8]
    pool: torch.Tensor          # f32[V, 3] the vertex pool


def ray_cast_grid_twin(rays, max_dist, solid, tabs: GridTables, max_cells, window):
    """Plain PyTorch version; see ``ray_cast_grid``. Tests only the entries of
    a cell's run that the query filter admits (the others give 1e30)."""
    r_n, dev = rays.shape[0], rays.device
    o, d = rays[:, :3], rays[:, 3:]
    ne = tabs.skey.shape[0]
    t_best = torch.full((r_n,), BIG, device=dev)
    n_best = torch.zeros((r_n, 3), device=dev)
    ci_best = torch.full((r_n,), -1, dtype=torch.int32, device=dev)
    rows = torch.arange(r_n, device=dev)

    def visit(cis, valid):
        """Take each ray's first nearest of its entries ``cis`` i64[R, W]
        where strictly nearer than its best."""
        nonlocal t_best, n_best, ci_best
        t = torch.full(cis.shape, BIG, device=dev)
        n = torch.zeros(cis.shape + (3,), device=dev)
        rr, ww = torch.nonzero(valid & tabs.ok[cis], as_tuple=True)
        c = cis[rr, ww]
        kinds = tabs.kind[c]
        for kind in torch.unique(kinds).tolist():
            sel = kinds == kind
            rk, wk, ck = rr[sel], ww[sel], c[sel]
            q = tabs.quat[ck]
            tk, nk = kt.ray_local(kind, quat_m.rotate_inv(q, o[rk] - tabs.pos[ck]),
                                  quat_m.rotate_inv(q, d[rk]), tabs.params[ck], solid[rk],
                                  tabs.pool)
            t[rk, wk] = torch.where((tk <= max_dist[rk]) & (tk >= 0.0), tk, BIG)
            n[rk, wk] = quat_m.rotate(q, nk)
        j = convex.first_argmin(t)
        tj = t[rows, j]
        better = tj < t_best
        t_best = torch.where(better, tj, t_best)
        n_best = torch.where(better[:, None], n[rows, j], n_best)
        ci_best = torch.where(better, cis[rows, j].to(torch.int32), ci_best)

    inv = 1.0 / torch.where(d.abs() > 1e-12, d, torch.where(d >= 0.0, 1e-12, -1e-12))
    step = torch.where(d >= 0.0, 1, -1).to(torch.int32)
    cc = torch.floor(o / tabs.cell).to(torch.int32)
    t_max = ((cc.to(torch.float32) + (step > 0).to(torch.float32)) * tabs.cell - o) * inv
    t_delta = (tabs.cell * inv).abs()
    lanes = torch.arange(window, device=dev)
    axes = torch.arange(3, device=dev)
    for _ in range(max_cells):
        key = cell_key(cc)
        start = torch.searchsorted(tabs.skey, key)
        idx = torch.clamp(start[:, None] + lanes, max=ne - 1)
        visit(tabs.scol[idx].long(), tabs.skey[idx] == key[:, None])
        move = axes[None, :] == convex.first_argmin(t_max)[:, None]
        cc = torch.where(move, cc + step, cc)
        t_max = torch.where(move, t_max + t_delta, t_max)
    g_n = tabs.global_idx.shape[0]
    visit(tabs.global_idx.long().expand(r_n, g_n), tabs.global_valid.expand(r_n, g_n))
    return t_best, n_best, ci_best


def ray_cast_grid(rays, max_dist, solid, tabs: GridTables, max_cells=64, window=32, work=None):
    """``(t f32[R], normal f32[R, 3], collider i32[R])``: each ray's nearest
    hit through the query grid (``BIG``, zero and -1 for none). ``rays``
    f32[R, 6] holds each ray's origin and unit direction, ``max_dist``
    f32[R] and ``solid`` bool[R] its limits. With ``work`` (i64[3], the
    kernel only) the launch adds its analytic ray tests, hull tests and
    hull vertex rows: the data-dependent work of the launch."""
    dev = rays.device
    if dev.type == "cpu":
        if work is not None:
            raise ValueError("ray_cast_grid: the plain version counts no work")
        return ray_cast_grid_twin(rays, max_dist, solid, tabs, max_cells, window)
    if dev.type != "cuda":
        raise RuntimeError(f"ray_cast_grid: unsupported device {dev}")
    from avian_tpu_torch.kernels import build

    r_n, m = rays.shape[0], tabs.pos.shape[0]
    ne, g_n = tabs.skey.shape[0], tabs.global_idx.shape[0]
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    build.require("ray_cast_grid", dev, [
        ("rays", rays, (r_n, 6), f32), ("max_dist", max_dist, (r_n,), f32),
        ("solid", solid, (r_n,), b8), ("cell", tabs.cell, (), f32),
        ("skey", tabs.skey, (ne,), i32), ("scol", tabs.scol, (ne,), i32),
        ("global_idx", tabs.global_idx, (g_n,), i32),
        ("global_valid", tabs.global_valid, (g_n,), b8), ("kind", tabs.kind, (m,), i32),
        ("ok", tabs.ok, (m,), b8), ("pos", tabs.pos, (m, 3), f32),
        ("quat", tabs.quat, (m, 4), f32), ("params", tabs.params, (m, 8), f32),
        ("pool", tabs.pool, tabs.pool.shape, f32),
    ] + ([] if work is None else [("work", work, (3,), torch.int64)]))
    t = torch.empty((r_n,), dtype=f32, device=dev)
    n = torch.empty((r_n, 3), dtype=f32, device=dev)
    ci = torch.empty((r_n,), dtype=i32, device=dev)
    if r_n:
        build.launch("avian_ray_cast_grid", dev, r_n, int(max_cells), int(window), ne, g_n, rays,
                     max_dist, solid, *tabs, t, n, ci, work)
        ray_cast_grid.launches += 1
    return t, n, ci


ray_cast_grid.launches = 0
