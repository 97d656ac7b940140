"""Kernel B, ``grid_sweep``: the same-cell window sweep of the broadphase.

Replaces the window loop of ``avian_tpu/pipeline/broadphase.py::broad_phase``
(broadphase.py:297-345): for every entry ``i`` of the cell-sorted grid table
and every ``k = 1..w`` it tests, exactly as the reference does, that entry
``i + k`` lies in the same cell, that this cell is the pair's canonical cell,
that the two AABBs overlap, that the bodies differ, that the layer masks
accept each other and that one side is dynamic, and sets bit ``k - 1`` of a
64-bit mask. It also emits each entry's rank in its cell run, which the caller
turns into the ``window_overflow`` count.

On the H100 the sweep is bound by the loads of neighbouring entries: each
entry reads at most ``w`` following rows of 6 floats and 7 ints, which are
contiguous in the sorted order and shared with the neighbouring threads
through L1. The CUDA kernel (``csrc/grid_sweep.cu``) gives one thread to each
entry, stops at the end of the cell run (the reference's remaining window
positions are all ``same_cell == False``), and caps the run rank at
``w + 1`` (all ``window_overflow`` needs), so a long run of empty entries
costs O(w) per thread rather than O(run). The window is
``w = min(sap_window, 8M - 1)``; up to the reference's limit of 32 the pair
set, slot order and ``dropped`` match the reference exactly, and the port
also takes 33..64 (the reference refuses them), which pairs the entries of
a cell run of up to 65 where the reference drops those past 33 (ROADMAP 3b:
the window cliff; the terrain path needs it).

The keys are Kernel E's (``collider_aabbs.cell_keys``): int64, a scene above
the 31 bits of the packed cell or of ``SENTINEL`` (``scene_key``). A run of
equal keys is one cell of one scene, so the flat world of many scenes that
``parallel.make_batched_step`` steps pairs no two scenes, and a single
world (scene 0) sweeps exactly the reference's 32-bit keys. The plain
version also takes int32 keys.

The plain PyTorch version, ``grid_sweep_twin``, runs on CPU tensors; on a
CUDA tensor the wrapper launches the kernel or raises.
"""

import ctypes

import torch

SENTINEL = 2**31 - 1
MAX_WINDOW = 64  # bits of the candidate mask
F_COLS = 6  # aabb_min(3), aabb_max(3)
I_COLS = 7  # min-cell(3), body, layer members, layer filter, dynamic


def cell_key(c):
    return ((c[..., 0] & 1023) << 20) | ((c[..., 1] & 1023) << 10) | (c[..., 2] & 1023)


def scene_key(scene, key):
    """i64: the 31-bit packed cell (or ``SENTINEL``) ``key`` of scene
    ``scene``, the scene above it. Scene 0's keys are the 32-bit ones."""
    return (scene.long() << 31) | key.long()


def cell_bits(skey):
    """The packed cell of a (scene) key: ``SENTINEL`` where there is none."""
    return skey & SENTINEL


def grid_sweep_twin(skey, sf, si, w):
    """Plain PyTorch version: (bits i64[n_e], rank i32[n_e])."""
    n_e = skey.shape[0]
    dev = skey.device
    spad_key = torch.cat([skey, torch.full((w,), SENTINEL, dtype=skey.dtype, device=dev)])
    cell = cell_bits(skey)
    inf6 = torch.tensor([float("inf")] * 3 + [-float("inf")] * 3, device=dev)
    spad_f = torch.cat([sf, inf6.expand(w, F_COLS)])
    spad_i = torch.cat([si, torch.zeros((w, I_COLS), dtype=torch.int32, device=dev)])
    a_min, a_max = sf[:, 0:3], sf[:, 3:6]
    a_i0, a_body, a_mem, a_fil, a_dyn = (
        si[:, 0:3], si[:, 3], si[:, 4], si[:, 5], si[:, 6]
    )
    bits = torch.zeros((n_e,), dtype=torch.int64, device=dev)
    for k in range(1, w + 1):
        b_key = spad_key[k:k + n_e]
        b_f = spad_f[k:k + n_e]
        b_i = spad_i[k:k + n_e]
        same_cell = (b_key == skey) & (cell != SENTINEL)
        overlap = ((b_f[:, 0:3] <= a_max) & (a_min <= b_f[:, 3:6])).all(dim=-1)
        canon_key = cell_key(torch.maximum(a_i0, b_i[:, 0:3]))
        ok = (
            same_cell
            & (canon_key == cell)
            & overlap
            & (a_body != b_i[:, 3])
            & ((a_mem & b_i[:, 5]) != 0)
            & ((b_i[:, 4] & a_fil) != 0)
            & ((a_dyn | b_i[:, 6]) > 0)
        )
        bits = bits | (ok.long() << (k - 1))
    idx = torch.arange(n_e, device=dev)
    new_run = torch.ones((n_e,), dtype=torch.bool, device=dev)
    new_run[1:] = skey[1:] != skey[:-1]
    run_start = torch.cummax(torch.where(new_run, idx, 0), dim=0).values
    rank = torch.clamp(idx - run_start, max=w + 1)
    return bits, rank.to(torch.int32)


def grid_sweep(skey, sf, si, w):
    """Window sweep over the cell-sorted grid entries.

    ``skey`` i64[n_e] sorted scene and cell keys (``cell_bits`` ``SENTINEL``
    = no cell; Kernel E's ``cell_keys``), ``sf``
    f32[n_e, 6], ``si`` i32[n_e, 7] the entries' fields in sorted order.
    Returns ``bits`` (i64 bit pattern of the 64-bit candidate mask) and the
    run rank capped at ``w + 1``."""
    if skey.device.type == "cpu":
        return grid_sweep_twin(skey, sf, si, w)
    if skey.device.type != "cuda":
        raise RuntimeError(f"grid_sweep: unsupported device {skey.device}")
    n_e = skey.shape[0]
    if not (1 <= w <= MAX_WINDOW):
        raise ValueError(f"grid_sweep: window {w} outside 1..{MAX_WINDOW}")
    if skey.dtype != torch.int64 or si.dtype != torch.int32 or sf.dtype != torch.float32:
        raise TypeError("grid_sweep: want i64 keys, f32[.,6] and i32[.,7] tables")
    if sf.shape != (n_e, F_COLS) or si.shape != (n_e, I_COLS):
        raise ValueError(f"grid_sweep: shapes {tuple(sf.shape)}, {tuple(si.shape)}")
    if not (sf.device == si.device == skey.device):
        raise ValueError("grid_sweep: inputs on different devices")
    if not (skey.is_contiguous() and sf.is_contiguous() and si.is_contiguous()):
        raise ValueError("grid_sweep: inputs must be contiguous")
    from avian_tpu_torch.kernels import build

    bits = torch.empty((n_e,), dtype=torch.int64, device=skey.device)
    rank = torch.empty((n_e,), dtype=torch.int32, device=skey.device)
    if n_e == 0:
        return bits, rank
    lib = build.library()
    with torch.cuda.device(skey.device):
        err = lib.avian_grid_sweep(
            skey.data_ptr(), sf.data_ptr(), si.data_ptr(),
            bits.data_ptr(), rank.data_ptr(), ctypes.c_int(n_e),
            ctypes.c_int(w), torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, "grid_sweep")
    grid_sweep.launches += 1
    return bits, rank


grid_sweep.launches = 0
