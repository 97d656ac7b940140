"""User-defined collider shapes (port of ``avian_tpu/api/custom_shapes.py``).

A custom shape is its support function. The engine's support-map pipeline
(Frank-Wolfe distance, subgradient depth, support-patch clipping) then gives
its manifolds against every built-in shape and every other custom shape;
the ray cast and the point projection march on the same function.

A :class:`CustomShape` holds, in the collider's local frame and on the
collider's 7 parameter lanes:

- ``support(prm f32[N, 7], d f32[N, 3]) -> f32[N, 3]``: the farthest point
  along ``d`` (not necessarily normalized), batched over N rows;
- ``aabb_half_extents(prm f32[N, 7]) -> f32[N, 3]``: a conservative local
  box, which the broadphase rotates with ``|R|``;
- ``patch(prm, d) -> (pts f32[N, 8, 3], normal f32[N, 3], count i32[N])``
  (optional): the contact patch most anti-parallel to ``d``; without one, the
  single support point (``point_patch``);
- ``cuda``: CUDA C++ source of the same functions as device functions on the
  ``V3`` type of ``csrc/common.cuh``::

      __device__ V3 support(const float* prm, V3 d);
      __device__ V3 aabb_half_extents(const float* prm);
      // optional; fills pts[0..8), returns the count:
      __device__ int patch(const float* prm, V3 d, V3* pts, V3& normal);

The torch functions are the plain versions: the CPU runs them, and the card
holds its kernels against them. On the card, ``kernels/custom_build.py``
compiles the world's shapes' sources into the kernels that take them (the
custom instances of Kernels E, M, O, P and AF, and Kernel AJ). A shape
without ``cuda`` steps on the CPU and raises on a CUDA world; there is no
fallback to the plain versions on the card. Written to do the torch
version's float operations in the same order, the device source makes the
kernels bit-equal to their plain versions.

Registration: ``SceneBuilder.custom_collider(body, shape=..., params=...,
mass=..., inertia=...)``; ``finalize`` stores the tuple as
``World.custom_shapes``, and the step and the queries read it. The shape's
code is ``CUSTOM_SHAPE_BASE + index``. An explicit ``physics_step(...,
custom_shapes=(...))`` takes precedence over the world's tuple. Swept CCD
does not see custom shapes, as in the reference.

``CustomShape`` hashes by identity, as the reference's does.
"""

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from avian_tpu_torch.core.types import CUSTOM_SHAPE_BASE  # noqa: F401 (re-exported)
from avian_tpu_torch.geometry.convex import PATCH, nrm


def point_patch(support):
    """The default patch: the single support point along the normalized
    direction (smooth shapes)."""

    def patch(prm, d):
        dn = nrm(d)
        pts = support(prm, dn)[:, None, :].expand(-1, PATCH, -1)
        return pts, dn, torch.ones((d.shape[0],), dtype=torch.int32, device=d.device)

    return patch


@dataclass(frozen=True, eq=False)  # eq=False: hashes by identity
class CustomShape:
    name: str
    support: Callable
    aabb_half_extents: Callable
    patch: Optional[Callable] = None
    cuda: Optional[str] = None

    def patch_fn(self):
        return self.patch if self.patch is not None else point_patch(self.support)


def resolve(world, custom_shapes=()):
    """The custom shapes a call uses: an explicit tuple takes precedence
    over the world's."""
    return tuple(custom_shapes) if custom_shapes else tuple(world.custom_shapes)


def refuse(world, what):
    """Raise for an entry point that does not yet take custom shapes, on a
    world with custom shapes. A collider of a custom code without the tuple
    (``custom_collider(index=...)``) raises in the entry point's own host
    read of its buckets (``narrowphase.canonical_spans``,
    ``queries.raycast.ray_kinds``), which keeps the character at one read a
    call."""
    if world.custom_shapes:
        raise NotImplementedError(
            f"{what} does not take custom shapes yet (ROADMAP queue 1: the custom "
            "instances of Kernels S, AG and AI)")
