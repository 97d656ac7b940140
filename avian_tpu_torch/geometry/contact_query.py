"""Standalone shape-pair queries (port of
``avian_tpu/geometry/contact_query.py``, the reference's ``contact_query``
module, ``src/collision/collider/parry/contact_query.rs:1-15``):
``contact_manifolds``, ``contact``, ``closest_points``, ``distance``,
``intersection_test`` and ``time_of_impact``.

Each function takes two shapes as ``(shape_type, pos, quat, params)`` with
params of up to 8 lanes (a CONVEX shape indexes the world's vertex pool,
``convex_verts``, through lanes 0 and 1), and ``shape_pairs`` like
``geometry/narrowphase.py::compute_manifolds``. Like the reference under
``jax.vmap``, every tensor argument may also carry a leading batch axis [P]:
the pairs are then bucketed by canonical shape pair with one host read, and
each bucket is one launch. The manifolds are the narrowphase's pair kernels
(A, M, N, O, P, Q) on a two-row table of the shapes; ``time_of_impact`` is
Kernel AI (``kernels/toi_pair.py``). Inputs that are not tensors land on
``device`` (the card unless the caller asks for the CPU).
"""

import numpy as np
import torch

from avian_tpu_torch.core.device import resolve
from avian_tpu_torch.core.types import CUSTOM_SHAPE_BASE
from avian_tpu_torch.geometry.convex import first_argmin
from avian_tpu_torch.geometry.narrowphase import (PAIR_KERNELS, POOL_KERNELS, Manifold,
                                                  allowed_pairs, canonical_spans,
                                                  compute_manifolds)
from avian_tpu_torch.kernels import toi_pair as kai

__all__ = ["contact_manifolds", "contact", "closest_points", "distance", "intersection_test",
           "time_of_impact"]

_NUM_TYPES = 16


def _device(args, device):
    for x in args:
        if isinstance(x, torch.Tensor):
            return x.device
    return resolve(device)


def _tensor(x, dtype, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x, dtype=np.float32 if dtype.is_floating_point
                                      else np.int32), device=device)


def _shapes(type_a, pos_a, quat_a, params_a, type_b, pos_b, quat_b, params_b, device,
            custom_shapes):
    """``(batched, (type_a, pos_a, quat_a, params_a, type_b, ...))``: every
    argument as a contiguous tensor with a leading axis [P] on one device,
    params padded to 8 lanes."""
    args = (type_a, pos_a, quat_a, params_a, type_b, pos_b, quat_b, params_b)
    if custom_shapes or any(int(torch.as_tensor(t).max()) >= CUSTOM_SHAPE_BASE
                            for t in (type_a, type_b)):
        raise NotImplementedError(
            "the contact queries do not take custom shapes yet (ROADMAP queue 1: the custom "
            "instances of Kernels S, AG and AI)")
    dev = _device(args, device)
    f32, i32 = torch.float32, torch.int32
    out = [_tensor(x, dt, dev) for x, dt in zip(args, (i32, f32, f32, f32) * 2)]
    batched = out[1].dim() == 2
    if not batched:
        out = [x[None] for x in out]
    for k in (3, 7):
        prm = out[k]
        out[k] = torch.cat([prm, prm.new_zeros((prm.shape[0], 8 - prm.shape[1]))], 1)
    return batched, tuple(x.contiguous() for x in out)


def _one(batched, x):
    return x if batched else x[0]


def _manifolds(shapes, shape_pairs, convex_verts) -> Manifold:
    """The P pairs' manifolds through ``compute_manifolds`` on a two-row
    table (row i shape a of pair i, row P + i its shape b)."""
    ta, pa, qa, prm_a, tb, pb, qb, prm_b = shapes
    p_n, dev = ta.shape[0], ta.device
    idx = torch.arange(p_n, dtype=torch.int32, device=dev)
    pool = None if convex_verts is None else _tensor(convex_verts, torch.float32, dev)
    m, _ = compute_manifolds(torch.cat([ta, tb]), torch.cat([prm_a, prm_b]), torch.cat([pa, pb]),
                             torch.cat([qa, qb]), idx, idx + p_n,
                             torch.ones((p_n,), dtype=torch.bool, device=dev), shape_pairs,
                             None if pool is None else pool.contiguous())
    # A pair that no kernel evaluates (half-space pairs, pairs outside the
    # hint) has the empty manifold, whose normal the reference un-swaps too.
    covered = torch.zeros((_NUM_TYPES * _NUM_TYPES,), dtype=torch.bool)
    for a, b in allowed_pairs(shape_pairs) & set(PAIR_KERNELS):
        covered[a * _NUM_TYPES + b] = True
    code = torch.minimum(ta, tb).long() * _NUM_TYPES + torch.maximum(ta, tb).long()
    flip = (ta > tb) & ~covered.to(dev)[code]
    return Manifold(normal=torch.where(flip[:, None], -m.normal, m.normal), point_a=m.point_a,
                    point_b=m.point_b, separation=m.separation, feature_id=m.feature_id,
                    count=m.count)


def contact_manifolds(type_a, pos_a, quat_a, params_a, type_b, pos_b, quat_b, params_b,
                      shape_pairs=None, convex_verts=None, custom_shapes=(),
                      device=None) -> Manifold:
    """The full manifold (up to 4 points) between two shapes: the kernels
    the narrowphase uses."""
    batched, shapes = _shapes(type_a, pos_a, quat_a, params_a, type_b, pos_b, quat_b, params_b,
                              device, custom_shapes)
    m = _manifolds(shapes, shape_pairs, convex_verts)
    if batched:
        return m
    return Manifold(*(x[0] for x in (m.normal, m.point_a, m.point_b, m.separation,
                                      m.feature_id, m.count)))


def _contact(shapes, prediction_distance, shape_pairs, convex_verts):
    m = _manifolds(shapes, shape_pairs, convex_verts)
    i = first_argmin(m.separation)  # over all four lanes, as the reference
    sep = m.separation.gather(1, i[:, None])[:, 0]
    found = (m.count > 0) & (sep <= prediction_distance)
    rows = torch.arange(i.shape[0], device=i.device)
    return found, m.point_a[rows, i], m.point_b[rows, i], m.normal, -sep


def contact(type_a, pos_a, quat_a, params_a, type_b, pos_b, quat_b, params_b,
            prediction_distance=0.0, shape_pairs=None, convex_verts=None, custom_shapes=(),
            device=None):
    """Deepest contact within ``prediction_distance``: (found, point_a,
    point_b, normal, penetration)."""
    batched, shapes = _shapes(type_a, pos_a, quat_a, params_a, type_b, pos_b, quat_b, params_b,
                              device, custom_shapes)
    out = _contact(shapes, prediction_distance, shape_pairs, convex_verts)
    return tuple(_one(batched, x) for x in out)


def closest_points(type_a, pos_a, quat_a, params_a, type_b, pos_b, quat_b, params_b,
                   shape_pairs=None, convex_verts=None, custom_shapes=(), device=None):
    """(are_intersecting, point_on_a, point_on_b)."""
    batched, shapes = _shapes(type_a, pos_a, quat_a, params_a, type_b, pos_b, quat_b, params_b,
                              device, custom_shapes)
    found, pa, pb, _, pen = _contact(shapes, float("inf"), shape_pairs, convex_verts)
    return tuple(_one(batched, x) for x in (found & (pen > 0.0), pa, pb))


def distance(type_a, pos_a, quat_a, params_a, type_b, pos_b, quat_b, params_b,
             shape_pairs=None, convex_verts=None, custom_shapes=(), device=None):
    """Minimum distance between the shapes (0 when intersecting, ``inf``
    where the manifold is empty)."""
    batched, shapes = _shapes(type_a, pos_a, quat_a, params_a, type_b, pos_b, quat_b, params_b,
                              device, custom_shapes)
    m = _manifolds(shapes, shape_pairs, convex_verts)
    sep = m.separation.amin(1)
    return _one(batched, torch.where(m.count > 0, torch.clamp(sep, min=0.0), float("inf")))


def intersection_test(type_a, pos_a, quat_a, params_a, type_b, pos_b, quat_b, params_b,
                      shape_pairs=None, convex_verts=None, custom_shapes=(), device=None):
    """True if the shapes overlap (a separation strictly below 0)."""
    batched, shapes = _shapes(type_a, pos_a, quat_a, params_a, type_b, pos_b, quat_b, params_b,
                              device, custom_shapes)
    m = _manifolds(shapes, shape_pairs, convex_verts)
    return _one(batched, (m.count > 0) & (m.separation.amin(1) < 0.0))


def time_of_impact(type_a, pos_a, quat_a, params_a, vel_a, type_b, pos_b, quat_b, params_b,
                   vel_b, max_t, iters: int = kai.ROUNDS, shape_pairs=None, convex_verts=None,
                   custom_shapes=(), device=None):
    """Linear-sweep time of impact in ``[0, max_t]`` by ``iters`` rounds of
    conservative advancement (Kernel AI; the reference delegates to Parry's
    ``cast_shapes``). Returns ``(hit, t)``. ``max_t`` (a number or f32[P])
    and ``max_t * 1.01``, the clamp of t, are f32. A pair that no kernel
    evaluates (a half-space pair, a pair outside the hint) never hits and
    ends at the clamp, as the reference's empty manifold does wherever ``1e9
    / |vel_a - vel_b|`` exceeds it."""
    batched, shapes = _shapes(type_a, pos_a, quat_a, params_a, type_b, pos_b, quat_b, params_b,
                              device, custom_shapes)
    ta, pa, qa, prm_a, tb, pb, qb, prm_b = shapes
    dev, p_n = ta.device, ta.shape[0]
    rel = (_tensor(vel_a, torch.float32, dev) - _tensor(vel_b, torch.float32, dev))
    rel = rel.reshape(p_n, 3).contiguous()
    max_t = _tensor(max_t, torch.float32, dev).expand(p_n).contiguous()
    order, _, spans = canonical_spans(ta, tb, torch.ones((p_n,), dtype=torch.bool, device=dev),
                                      shape_pairs)
    if convex_verts is None:
        if any(PAIR_KERNELS[pair][1] in POOL_KERNELS for pair, _, _ in spans):
            raise ValueError("time_of_impact: a pool-backed shape needs convex_verts")
        pool = torch.zeros((1, 3), dtype=torch.float32, device=dev)
    else:
        pool = _tensor(convex_verts, torch.float32, dev).contiguous()
    tabs = kai.ToiTables(ta, tb, pa, qa, prm_a, pb, qb, prm_b, rel, max_t, pool)
    hit = torch.zeros((p_n,), dtype=torch.bool, device=dev)
    t = max_t * 1.01
    order = order.to(torch.int32)
    for pair, start, end in spans:
        kai.toi_pair(pair, order[start:end].contiguous(), tabs, hit, t, iters)
    return _one(batched, hit), _one(batched, t)
