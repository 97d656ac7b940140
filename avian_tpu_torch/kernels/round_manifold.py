"""Kernel N, ``round_manifold``: contact manifolds of the six analytic pairs
of round shapes: sphere/sphere, sphere/capsule, sphere/box, sphere/plane,
capsule/capsule and capsule/plane.

Replaces ``avian_tpu/geometry/narrowphase.py::sphere_sphere`` (:88),
``sphere_capsule`` (:96), ``capsule_capsule`` (:109) with
``_closest_segment_segment`` (:154), ``sphere_box`` (:172), ``sphere_plane``
(:204) and ``capsule_plane`` (:214). The reference runs them, with every
other listed pair function, on every slot of the pair buffer; here the
caller buckets pairs by shape code and launches the kernel once per bucket,
``kind`` selecting the pair function for the whole launch (no divergence
within a warp).

On the H100 a pair is a few dozen to a few hundred f32 operations on 80
bytes of poses and parameters, writing a 4-point manifold of 148 bytes: the
kernel is bound by bytes. The CUDA kernel (``csrc/round_manifold.cu``) gives
one thread to each pair and writes each output once. It is compiled with
``-fmad=false`` and spells every sum out in the plain version's order, so
the two agree to the last bit.

The plain PyTorch version, ``round_manifold_twin`` (the pair functions of
``geometry/narrowphase.py``), runs on CPU tensors; on a CUDA tensor the
wrapper launches the kernel or raises.
"""

SPHERE_SPHERE = 0
SPHERE_CAPSULE = 1
SPHERE_BOX = 2
SPHERE_PLANE = 3
CAPSULE_CAPSULE = 4
CAPSULE_PLANE = 5
KINDS = ("sphere_sphere", "sphere_capsule", "sphere_box", "sphere_plane",
         "capsule_capsule", "capsule_plane")


def round_manifold_twin(kind, pa, qa, prm_a, pb, qb, prm_b):
    """Plain PyTorch version; see ``round_manifold``."""
    from avian_tpu_torch.geometry import narrowphase

    if not 0 <= kind < len(KINDS):
        raise ValueError(f"unknown round_manifold kind {kind}")
    return getattr(narrowphase, KINDS[kind])(pa, qa, prm_a, pb, qb, prm_b)


def round_manifold(kind, pa, qa, prm_a, pb, qb, prm_b):
    """Manifolds of K pairs in canonical order (A is the sphere, or the
    capsule of capsule/capsule and capsule/plane; a half-space B carries its
    local normal in ``prm_b``). Inputs f32 [K, 3] / [K, 4], ``prm_*`` the
    first three shape parameters. Returns (normal f32[K,3], point_a
    f32[K,4,3], point_b f32[K,4,3], separation f32[K,4], feature_id i32[K,4],
    count i32[K])."""
    if pa.device.type == "cpu":
        return round_manifold_twin(kind, pa, qa, prm_a, pb, qb, prm_b)
    if pa.device.type != "cuda":
        raise RuntimeError(f"round_manifold: unsupported device {pa.device}")
    if not 0 <= kind < len(KINDS):
        raise ValueError(f"unknown round_manifold kind {kind}")
    from avian_tpu_torch.kernels import build

    out = build.launch_manifold("avian_round_manifold", kind, (pa, qa, prm_a, pb, qb, prm_b))
    if pa.shape[0]:
        round_manifold.launches += 1
    return out


round_manifold.launches = 0
