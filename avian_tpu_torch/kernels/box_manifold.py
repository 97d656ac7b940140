"""Kernel A, ``box_manifold``: contact manifolds of box/box and box/plane pairs.

Replaces ``avian_tpu/geometry/box_box.py::box_box`` (with ``_face_manifold``
and ``_clip_axis``) and ``avian_tpu/geometry/narrowphase.py::box_plane``.
The reference runs both, and every other listed pair function, on every
slot of the pair buffer under ``vmap`` + ``lax.switch``; here the caller
buckets pairs by shape code and launches the kernel once per bucket, with
``kind`` selecting the pair function for the whole launch.

On the H100 a box/box pair is thousands of dependent f32 operations on data
that fits in registers (two poses in, a 4-point manifold out, 176 bytes),
so the kernel is bound by latency and register pressure, not by memory.
The CUDA kernel (``csrc/box_manifold.cu``) gives one thread to each pair,
keeps the clip polygon in a fixed 8-slot array, and replaces the
reference's per-clip sort of 16 emitted points by emitting them in ring
order directly. It is compiled with ``-fmad=false`` and spells every sum
out in the plain version's order, so the two agree to the last bit where
the hardware rounding does: ties in the SAT axis choice and in box/plane's
corner order then break the same way, which keeps feature ids, and with
them warm starting, identical.

The plain PyTorch version, ``box_manifold_twin``, runs on CPU tensors; on a
CUDA tensor the wrapper launches the kernel or raises.
"""

import ctypes

import torch

BOX_BOX = 0
BOX_PLANE = 1


def box_manifold_twin(kind, pa, qa, ha, pb, qb, hb):
    """Plain PyTorch version; see ``box_manifold``."""
    if kind == BOX_BOX:
        from avian_tpu_torch.geometry.box_box import box_box

        return box_box(pa, qa, ha, pb, qb, hb)
    if kind == BOX_PLANE:
        from avian_tpu_torch.geometry.narrowphase import box_plane

        return box_plane(pa, qa, ha, pb, qb, hb)
    raise ValueError(f"unknown box_manifold kind {kind}")


def box_manifold(kind, pa, qa, ha, pb, qb, hb):
    """Manifolds of K pairs in canonical order (A is a box; B is a box for
    ``BOX_BOX``, a half-space with local normal ``hb`` for ``BOX_PLANE``).

    Inputs f32 [K, 3] / [K, 4]. Returns (normal f32[K,3], point_a f32[K,4,3],
    point_b f32[K,4,3], separation f32[K,4], feature_id i32[K,4], count i32[K])."""
    if pa.device.type == "cpu":
        return box_manifold_twin(kind, pa, qa, ha, pb, qb, hb)
    if pa.device.type != "cuda":
        raise RuntimeError(f"box_manifold: unsupported device {pa.device}")
    if kind not in (BOX_BOX, BOX_PLANE):
        raise ValueError(f"unknown box_manifold kind {kind}")
    k_n = pa.shape[0]
    for name, x, width in (("pa", pa, 3), ("qa", qa, 4), ("ha", ha, 3),
                           ("pb", pb, 3), ("qb", qb, 4), ("hb", hb, 3)):
        if x.device != pa.device or x.dtype != torch.float32:
            raise TypeError(f"box_manifold: {name} must be f32 on {pa.device}")
        if x.shape != (k_n, width) or not x.is_contiguous():
            raise ValueError(
                f"box_manifold: {name} must be contiguous [{k_n}, {width}], "
                f"got {tuple(x.shape)}"
            )
    from avian_tpu_torch.kernels import build

    dev = pa.device
    normal = torch.empty((k_n, 3), dtype=torch.float32, device=dev)
    point_a = torch.empty((k_n, 4, 3), dtype=torch.float32, device=dev)
    point_b = torch.empty((k_n, 4, 3), dtype=torch.float32, device=dev)
    sep = torch.empty((k_n, 4), dtype=torch.float32, device=dev)
    fid = torch.empty((k_n, 4), dtype=torch.int32, device=dev)
    count = torch.empty((k_n,), dtype=torch.int32, device=dev)
    if k_n == 0:
        return normal, point_a, point_b, sep, fid, count
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.avian_box_manifold(
            ctypes.c_int(kind), ctypes.c_int(k_n),
            pa.data_ptr(), qa.data_ptr(), ha.data_ptr(),
            pb.data_ptr(), qb.data_ptr(), hb.data_ptr(),
            normal.data_ptr(), point_a.data_ptr(), point_b.data_ptr(),
            sep.data_ptr(), fid.data_ptr(), count.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, "box_manifold")
    box_manifold.launches += 1
    return normal, point_a, point_b, sep, fid, count


box_manifold.launches = 0
