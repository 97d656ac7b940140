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
    from avian_tpu_torch.kernels import build

    out = build.launch_manifold("avian_box_manifold", kind, (pa, qa, ha, pb, qb, hb))
    if pa.shape[0]:
        box_manifold.launches += 1
    return out


box_manifold.launches = 0
