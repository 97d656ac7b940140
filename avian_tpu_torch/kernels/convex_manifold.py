"""Kernel M, ``convex_manifold``, and Kernel O, ``plane_patch_manifold``:
contact manifolds of support-mapped convex shapes.

Kernel M replaces ``avian_tpu/geometry/convex.py::generic_convex_pair``
(:468), the reference's support-map fallback for every pair without a
dedicated function. Those are the sixteen pairs of ``GENERIC_PAIRS``: sphere
with cylinder and cone; capsule with box, cylinder and cone; box with
cylinder and cone; cylinder/cylinder, cylinder/cone and cone/cone; and a
segment with each of sphere, capsule, box, cylinder, cone and segment.
Kernel O replaces ``support_patch_plane_pair`` (:702) behind the reference's
``_swapped`` wrapper (``narrowphase.py:313-326``): a half-space against a
cylinder, a cone or a segment, the half-space first. (A pool-backed convex
shape's pairs are Kernels P and Q, ``kernels/hull_manifold.py``.)

A pair of Kernel M is some 24 Frank-Wolfe and 20 subgradient steps, each
two support functions under two rotations, then two rounds of support
patches, 8 half-plane clips of a 16-point ring and a 4-point reduction:
about 15,000 dependent f32 operations on 80 bytes in and 148 out, so the
kernel is bound by latency and registers, not by bytes. The CUDA source
(``csrc/convex_manifold.cu``) is a template on the two shape types,
instantiated once per pair of ``GENERIC_PAIRS``; the caller buckets pairs by
shape code, so a warp runs one support function per side without
divergence. One thread takes one pair; the rings and patches live in local
memory. The kernel branches where the reference selects (the clipped or the
degenerate manifold), computes only the branch it keeps, and follows the
plain version's arithmetic operation by operation (``-fmad=false``, IEEE
``sqrt`` and division), so the two agree to the last bit. Kernel O shares
the patch code: one patch and one reduction, bound by bytes.

The disc tables (``DISC_COS``/``DISC_SIN``, numpy's float32 values) are
passed to the kernel from here; it computes no ``cos``.

The plain PyTorch versions, ``convex_manifold_twin`` and
``plane_patch_manifold_twin`` (``geometry/convex.py``), run on CPU tensors;
on a CUDA tensor the wrappers launch the kernel or raise.
"""

import functools

import torch

from avian_tpu_torch.core.types import ShapeType
from avian_tpu_torch.geometry import convex

_S = ShapeType
GENERIC_PAIRS = tuple((int(a), int(b)) for a, b in (
    (_S.SPHERE, _S.CYLINDER), (_S.SPHERE, _S.CONE),
    (_S.CAPSULE, _S.BOX), (_S.CAPSULE, _S.CYLINDER), (_S.CAPSULE, _S.CONE),
    (_S.BOX, _S.CYLINDER), (_S.BOX, _S.CONE),
    (_S.CYLINDER, _S.CYLINDER), (_S.CYLINDER, _S.CONE), (_S.CONE, _S.CONE),
    (_S.SPHERE, _S.SEGMENT), (_S.CAPSULE, _S.SEGMENT), (_S.BOX, _S.SEGMENT),
    (_S.CYLINDER, _S.SEGMENT), (_S.CONE, _S.SEGMENT), (_S.SEGMENT, _S.SEGMENT),
))
PLANE_CYLINDER = 0
PLANE_CONE = 1
PLANE_SEGMENT = 2
PLANE_SHAPES = (int(_S.CYLINDER), int(_S.CONE), int(_S.SEGMENT))

@functools.cache
def _disc_table(device):
    """DISC_COS ++ DISC_SIN as f32[16] on ``device``."""
    return torch.cat([torch.from_numpy(convex.DISC_COS),
                      torch.from_numpy(convex.DISC_SIN)]).to(device)


def convex_manifold_twin(kind, pa, qa, prm_a, pb, qb, prm_b):
    """Plain PyTorch version; see ``convex_manifold``."""
    if not 0 <= kind < len(GENERIC_PAIRS):
        raise ValueError(f"unknown convex_manifold kind {kind}")
    ta, tb = GENERIC_PAIRS[kind]
    return convex.generic_manifold(ta, tb, pa, qa, prm_a, pb, qb, prm_b)


def convex_manifold(kind, pa, qa, prm_a, pb, qb, prm_b):
    """Manifolds of K pairs of the canonical shape pair
    ``GENERIC_PAIRS[kind]``. Inputs f32 [K, 3] / [K, 4], ``prm_*`` the first
    three shape parameters. Returns (normal f32[K,3], point_a f32[K,4,3],
    point_b f32[K,4,3], separation f32[K,4], feature_id i32[K,4], count
    i32[K])."""
    if pa.device.type == "cpu":
        return convex_manifold_twin(kind, pa, qa, prm_a, pb, qb, prm_b)
    if pa.device.type != "cuda":
        raise RuntimeError(f"convex_manifold: unsupported device {pa.device}")
    if not 0 <= kind < len(GENERIC_PAIRS):
        raise ValueError(f"unknown convex_manifold kind {kind}")
    from avian_tpu_torch.kernels import build

    out = build.launch_manifold("avian_convex_manifold", kind,
                                (pa, qa, prm_a, pb, qb, prm_b), _disc_table(pa.device))
    if pa.shape[0]:
        convex_manifold.launches += 1
    return out


convex_manifold.launches = 0


def plane_patch_manifold_twin(kind, pa, qa, na, pb, qb, prm_b):
    """Plain PyTorch version; see ``plane_patch_manifold``."""
    if not 0 <= kind < len(PLANE_SHAPES):
        raise ValueError(f"unknown plane_patch_manifold kind {kind}")
    return convex.plane_patch_manifold(PLANE_SHAPES[kind], pa, qa, na, pb, qb, prm_b)


def plane_patch_manifold(kind, pa, qa, na, pb, qb, prm_b):
    """Manifolds of K pairs of a half-space A (local normal ``na``) and the
    cylinder (``PLANE_CYLINDER``), cone (``PLANE_CONE``) or segment
    (``PLANE_SEGMENT``) B. Same returns as ``convex_manifold``."""
    if pa.device.type == "cpu":
        return plane_patch_manifold_twin(kind, pa, qa, na, pb, qb, prm_b)
    if pa.device.type != "cuda":
        raise RuntimeError(f"plane_patch_manifold: unsupported device {pa.device}")
    if not 0 <= kind < len(PLANE_SHAPES):
        raise ValueError(f"unknown plane_patch_manifold kind {kind}")
    from avian_tpu_torch.kernels import build

    out = build.launch_manifold("avian_plane_patch_manifold", kind,
                                (pa, qa, na, pb, qb, prm_b), _disc_table(pa.device))
    if pa.shape[0]:
        plane_patch_manifold.launches += 1
    return out


plane_patch_manifold.launches = 0
