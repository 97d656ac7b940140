"""Kernel P, ``hull_manifold``, and Kernel Q, ``plane_hull_manifold``:
contact manifolds of pool-backed convex shapes (hulls, round cuboids and
the triangles of trimeshes and heightfields).

Kernel P replaces ``avian_tpu/geometry/convex.py::generic_convex_pair_aux``
(:881) with ``support_convex`` (:762), ``patch_convex`` (:789) and the flat
rule of ``generic_convex_pair`` (:533-545), for the seven canonical pairs of
``HULL_PAIRS``: a sphere, capsule, box, cylinder, cone, segment or CONVEX
shape against a CONVEX shape. Kernel Q replaces
``support_patch_plane_pair_aux`` (:902) behind the reference's
``_swapped_aux`` (``narrowphase.py:388-390``): a half-space against a CONVEX
shape, the half-space first.

A CONVEX shape's params are 7 lanes ``(offset, count, hx, hy, hz, flat,
radius)``; its vertices are ``count`` (at most 32) rows of the world's
vertex pool from ``offset``. A pair of Kernel P is Kernel M's pipeline (24
Frank-Wolfe and 20 subgradient steps, two rounds of patches, 8 clips of a
16-point ring, a 4-point reduction) with a scan of the hull's vertices in
every support call and ``patch_convex``'s band selection, top 8 and angle
sort in every hull patch: some 20,000 dependent operations on 104 bytes of
pair input, up to 384 bytes of vertices and 148 bytes out, so it is bound by
latency, not bytes. The CUDA source (``csrc/hull_manifold.cu``) is a
template on the first shape's type, one instance per pair of
``HULL_PAIRS``; CONVEX/CONVEX reads both flat flags at run time. One thread
takes one pair and reads a hull's vertices from the pool as it needs them,
never past ``offset + count``. It shares Kernel M's device code
(``csrc/convex_pair.cuh``) and follows the plain version's arithmetic
operation by operation (``-fmad=false``, IEEE ``sqrt`` and division, the
first extremum on ties, the top 8 as a stable descending selection, the
angle order as a stable insertion sort), so the two agree bit for bit where
``atan2`` orders the same. Kernel Q is one hull patch and one 4-point
reduction.

The plain PyTorch versions, ``hull_manifold_twin`` and
``plane_hull_manifold_twin`` (``geometry/convex.py``), run on CPU tensors;
on a CUDA tensor the wrappers launch the kernel or raise.
"""

import torch

from avian_tpu_torch.core.types import ShapeType
from avian_tpu_torch.geometry import convex
from avian_tpu_torch.kernels.convex_manifold import _disc_table

_S = ShapeType
HULL_PAIRS = tuple((int(a), int(_S.CONVEX)) for a in (
    _S.SPHERE, _S.CAPSULE, _S.BOX, _S.CYLINDER, _S.CONE, _S.SEGMENT, _S.CONVEX))
PLANE_CONVEX = 0
PARAM_LANES = 7


def _pool(pool, device):
    f32 = torch.float32
    if pool.dtype != f32 or pool.dim() != 2 or pool.shape[1] != 3 or pool.device != device:
        raise TypeError(f"pool must be f32[V, 3] on {device}")
    return pool.contiguous()


def hull_manifold_twin(kind, pa, qa, prm_a, pb, qb, prm_b, pool):
    """Plain PyTorch version; see ``hull_manifold``."""
    if not 0 <= kind < len(HULL_PAIRS):
        raise ValueError(f"unknown hull_manifold kind {kind}")
    ta, tb = HULL_PAIRS[kind]
    return convex.generic_manifold(ta, tb, pa, qa, prm_a, pb, qb, prm_b, pool)


def hull_manifold(kind, pa, qa, prm_a, pb, qb, prm_b, pool):
    """Manifolds of K pairs of the canonical shape pair ``HULL_PAIRS[kind]``
    (B always CONVEX). Inputs f32 [K, 3] / [K, 4], ``prm_*`` the first
    ``PARAM_LANES`` shape parameters [K, 7], ``pool`` the vertex pool f32[V,
    3]. Returns (normal f32[K,3], point_a f32[K,4,3], point_b f32[K,4,3],
    separation f32[K,4], feature_id i32[K,4], count i32[K])."""
    if pa.device.type == "cpu":
        return hull_manifold_twin(kind, pa, qa, prm_a, pb, qb, prm_b, pool)
    if pa.device.type != "cuda":
        raise RuntimeError(f"hull_manifold: unsupported device {pa.device}")
    if not 0 <= kind < len(HULL_PAIRS):
        raise ValueError(f"unknown hull_manifold kind {kind}")
    from avian_tpu_torch.kernels import build

    pool = _pool(pool, pa.device)
    out = build.launch_manifold("avian_hull_manifold", kind, (pa, qa, prm_a, pb, qb, prm_b),
                                _disc_table(pa.device), pool, prm_width=PARAM_LANES)
    if pa.shape[0]:
        hull_manifold.launches += 1
    return out


hull_manifold.launches = 0


def plane_hull_manifold_twin(kind, pa, qa, na, pb, qb, prm_b, pool):
    """Plain PyTorch version; see ``plane_hull_manifold``."""
    if kind != PLANE_CONVEX:
        raise ValueError(f"unknown plane_hull_manifold kind {kind}")
    return convex.plane_patch_manifold(int(_S.CONVEX), pa, qa, na, pb, qb, prm_b, pool)


def plane_hull_manifold(kind, pa, qa, na, pb, qb, prm_b, pool):
    """Manifolds of K pairs of a half-space A (local normal in the first
    three of its ``PARAM_LANES`` params ``na``) and a CONVEX shape B
    (``kind`` is ``PLANE_CONVEX``). Same returns as ``hull_manifold``; the
    normal points from the plane to the shape."""
    if pa.device.type == "cpu":
        return plane_hull_manifold_twin(kind, pa, qa, na, pb, qb, prm_b, pool)
    if pa.device.type != "cuda":
        raise RuntimeError(f"plane_hull_manifold: unsupported device {pa.device}")
    if kind != PLANE_CONVEX:
        raise ValueError(f"unknown plane_hull_manifold kind {kind}")
    from avian_tpu_torch.kernels import build

    pool = _pool(pool, pa.device)
    out = build.launch_manifold("avian_plane_hull_manifold", kind, (pa, qa, na, pb, qb, prm_b),
                                pool, prm_width=PARAM_LANES)
    if pa.shape[0]:
        plane_hull_manifold.launches += 1
    return out


plane_hull_manifold.launches = 0
