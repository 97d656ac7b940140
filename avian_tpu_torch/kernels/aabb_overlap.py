"""Kernel AH, ``aabb_overlap``: which colliders' stored AABBs overlap each of
Q query boxes.

Replaces the mask of ``avian_tpu/queries/intersect.py::aabb_intersections``
(:14): ``collider_query_mask & all((aabb_min <= hi) & (lo <= aabb_max))``
over every collider. One thread per (box, collider) compares six floats and
writes one byte: a fused compare, bound by bytes (the colliders' 24 bytes of
AABB and 1 of mask read once, 1 byte written a pair). The CUDA kernel is
``csrc/aabb_overlap.cu``.

The plain PyTorch version, ``aabb_overlap_twin``, runs on CPU tensors; on a
CUDA tensor the wrapper launches the kernel or raises.
"""

import torch


def aabb_overlap_twin(lo, hi, aabb_min, aabb_max, ok):
    """Plain PyTorch version; see ``aabb_overlap``."""
    return ok[None, :] & ((aabb_min[None] <= hi[:, None]) & (lo[:, None] <= aabb_max[None])).all(-1)


def aabb_overlap(lo, hi, aabb_min, aabb_max, ok):
    """bool[Q, M]: ``ok`` bool[M] and the overlap of the closed boxes
    [``lo``, ``hi``] f32[Q, 3] with the colliders' [``aabb_min``,
    ``aabb_max``] f32[M, 3]."""
    dev = lo.device
    if dev.type == "cpu":
        return aabb_overlap_twin(lo, hi, aabb_min, aabb_max, ok)
    if dev.type != "cuda":
        raise RuntimeError(f"aabb_overlap: unsupported device {dev}")
    from avian_tpu_torch.kernels import build

    q_n, m = lo.shape[0], aabb_min.shape[0]
    f32 = torch.float32
    build.require("aabb_overlap", dev, (
        ("lo", lo, (q_n, 3), f32), ("hi", hi, (q_n, 3), f32),
        ("aabb_min", aabb_min, (m, 3), f32), ("aabb_max", aabb_max, (m, 3), f32),
        ("ok", ok, (m,), torch.bool),
    ))
    out = torch.empty((q_n, m), dtype=torch.bool, device=dev)
    if q_n * m:
        build.launch("avian_aabb_overlap", dev, q_n, m, lo, hi, aabb_min, aabb_max, ok, out)
        aabb_overlap.launches += 1
    return out


aabb_overlap.launches = 0
