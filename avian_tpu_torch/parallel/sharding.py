"""Batched scenes on one card (port of ``avian_tpu/parallel/sharding.py``).

The reference steps B scenes with ``jax.vmap`` of its step. Kernels do not
``vmap``, so the port lays the B scenes end to end as one flat world and
runs the one pipeline over it: N·B bodies, M·B colliders, C·B contact
slots, J·B joints and V·B pool vertices, scene ``s`` owning rows
``[s·N, (s+1)·N)`` and so on. Only indices change on the way in and out
(``flatten``/``unflatten``): collider bodies, joint bodies, contact colliders
and bodies, pair keys, island labels and pool offsets. The world's own
leaves keep one entry a scene: ``gravity`` f32[B, 3], ``time`` f32[B],
``diverged`` bool[B] and ``contacts.next_contact_id`` i32[B]
(``World.scene_count``).

What ``vmap`` makes per scene and the step would otherwise compute once for
the whole world is per scene inside the kernels and the stages: the cell
keys of Kernel E carry the scene above the cell, so Kernel B's runs and
every pair stay inside a scene; the cell size and the median extent are
per scene (``broadphase.sweep_cell``); Kernel L's dense pass tests each
scene's globals (at most ``MAX_GLOBALS`` a scene) against its own colliders
and gives each scene its own ``C`` slots, pair count and drops; contact ids
count per scene; Kernel K reads each body's scene gravity. The step is the
single world's own, ``pipeline/step.py::step_scenes``, whose early-out and
NaN quarantine are per scene: a scene with nothing to move gets the
early-out's result (forces cleared, ``time + dt``, nothing else touched)
while others step, and a scene with a non-finite body is frozen and flagged
alone. A single world is the same code at B = 1.

One deliberate difference: Kernel G's colour buckets are the flat world's,
sized from its whole C (``pipeline/solver.py``). A scene loses rows to a
full bucket only when the pooled bucket is full, where the reference's
scene would lose them when its own bucket is (ROADMAP 3a).

``make_batched_step`` refuses swept CCD (its ``max_swept_colliders`` cap is
one per world, ``pipeline/ccd.py``) and worlds with custom shapes; it takes
no hooks and no custom joints, as the reference's takes none.
"""

from dataclasses import fields

import torch

from avian_tpu_torch.core.config import PhysicsConfig
from avian_tpu_torch.core.state import World
from avian_tpu_torch.core.types import ShapeType
from avian_tpu_torch.pipeline import step as step_m

_F32_EXACT = 2**24  # pool offsets live in f32 params


def _map(group, fn):
    return group.replace(**{f.name: fn(f.name, getattr(group, f.name)) for f in fields(group)})


def replicate_world(world: World, batch: int) -> World:
    """``batch`` copies of ``world`` along a new leading axis: every leaf gets
    the reference's ``[B]`` axis (``bodies.pos`` f32[B, N, 3], ``gravity``
    f32[B, 3], ``time`` f32[B], ``diverged`` bool[B], contacts ``[B, C,
    ...]``), indices local to each scene. The copies are real: the kernels
    write in place, and a stride-0 view would alias every scene."""
    if world.scene_count != 1:
        raise ValueError("replicate_world: the world is batched already")

    def rep(_, x):
        return x.unsqueeze(0).repeat((batch,) + (1,) * x.dim())

    return world.replace(
        bodies=_map(world.bodies, rep), colliders=_map(world.colliders, rep),
        contacts=_map(world.contacts, rep), joints=_map(world.joints, rep),
        gravity=rep(0, world.gravity), time=rep(0, world.time),
        diverged=rep(0, world.diverged), convex_verts=rep(0, world.convex_verts),
    )


def _sizes(world: World, flat: bool):
    """(B, N, M, V): scenes, and bodies, colliders and pool vertices a scene."""
    b = world.gravity.shape[0]
    n, m = world.bodies.capacity, world.colliders.capacity
    v = world.convex_verts.shape[-2]
    if flat:
        n, m, v = n // b, m // b, v // b
    if b * v >= _F32_EXACT:
        raise ValueError(f"make_batched_step: {b} scenes of {v} pool vertices pass the f32 "
                         "offsets' exact range")
    return b, n, m, v


def _pool_offsets(params, shape_type, shift):
    """``params`` with each pool-backed convex shape's offset (lane 0) moved
    by ``shift`` f32[B, 1]."""
    convex = shape_type == int(ShapeType.CONVEX)
    lane0 = torch.where(convex, params[..., 0] + shift, params[..., 0])
    return torch.cat([lane0[..., None], params[..., 1:]], dim=-1)


def flatten(world: World) -> World:
    """The flat world of a batched one (module docstring): leaves [B, K, ...]
    become [B·K, ...] and scene-local indices global."""
    b, n, m, v = _sizes(world, flat=False)
    s = torch.arange(b, device=world.device)[:, None]

    def flat(x):
        return x.reshape(b * x.shape[1], *x.shape[2:])

    def shifted(x, k):
        return flat(x + (s * k).to(x.dtype))

    col = world.colliders
    colliders = _map(col, lambda name, x: (
        shifted(x, n) if name == "body_idx"
        else flat(_pool_offsets(x, col.shape_type, (s * v).float())) if name == "params"
        else flat(x)))
    c = world.contacts
    evicted = c.evicted

    def contact_leaf(name, x):
        if name in ("collider_a", "collider_b"):
            return shifted(x, m)
        if name in ("body_a", "body_b"):
            return shifted(x, n)
        if name in ("evicted_body_a", "evicted_body_b"):
            return flat(torch.where(evicted, x + (s * n).to(x.dtype), 0))
        return x if name == "next_contact_id" else flat(x)

    contacts = _map(c, contact_leaf)
    lo = torch.minimum(contacts.collider_a, contacts.collider_b).long()
    hi = torch.maximum(contacts.collider_a, contacts.collider_b).long()
    contacts = contacts.replace(
        pair_key=torch.where(contacts.pair_key >= 0, lo * (b * m) + hi, -1))
    return world.replace(
        bodies=_map(world.bodies, lambda name, x: shifted(x, n) if name == "island" else flat(x)),
        colliders=colliders, contacts=contacts,
        joints=_map(world.joints, lambda name, x: (
            shifted(x, n) if name in ("body_a", "body_b") else flat(x))),
        convex_verts=flat(world.convex_verts),
    )


def unflatten(world: World) -> World:
    """The batched world of a flat one: ``flatten`` undone."""
    b, n, m, v = _sizes(world, flat=True)
    s = torch.arange(b, device=world.device)[:, None]

    def unflat(x):
        return x.reshape(b, x.shape[0] // b, *x.shape[1:])

    def unshifted(x, k):
        return unflat(x) - (s * k).to(x.dtype)

    col = _map(world.colliders, lambda name, x: (
        unshifted(x, n) if name == "body_idx" else unflat(x)))
    col = col.replace(params=_pool_offsets(col.params, col.shape_type, -(s * v).float()))
    evicted = unflat(world.contacts.evicted)

    def contact_leaf(name, x):
        if name in ("collider_a", "collider_b"):
            return unshifted(x, m)
        if name in ("body_a", "body_b"):
            return unshifted(x, n)
        if name in ("evicted_body_a", "evicted_body_b"):
            return torch.where(evicted, unshifted(x, n), 0)
        return x if name == "next_contact_id" else unflat(x)

    contacts = _map(world.contacts, contact_leaf)
    lo = torch.minimum(contacts.collider_a, contacts.collider_b).long()
    hi = torch.maximum(contacts.collider_a, contacts.collider_b).long()
    contacts = contacts.replace(pair_key=torch.where(contacts.pair_key >= 0, lo * m + hi, -1))
    return world.replace(
        bodies=_map(world.bodies, lambda name, x: (
            unshifted(x, n) if name == "island" else unflat(x))),
        colliders=col, contacts=contacts,
        joints=_map(world.joints, lambda name, x: (
            unshifted(x, n) if name in ("body_a", "body_b") else unflat(x))),
        convex_verts=unflat(world.convex_verts),
    )


def make_batched_step(config: PhysicsConfig):
    """The batched step: ``step(world, return_diagnostics=False)`` advances a
    batched world (``replicate_world``) by ``config.dt`` and returns it, or
    ``(world, diagnostics)`` with each diagnostic ``[B]``, as ``jax.vmap``
    of the reference's ``physics_step(..., return_diagnostics=True)`` gives
    them."""
    if config.swept_ccd:
        raise NotImplementedError(
            "make_batched_step: swept CCD caps its swept colliders per world "
            "(pipeline/ccd.py); ROADMAP 3a")

    def step(world: World, return_diagnostics=False):
        if world.gravity.dim() != 2:
            raise ValueError("make_batched_step: a world of one scene; batch it with "
                             "replicate_world")
        if world.custom_shapes:
            raise NotImplementedError(
                "make_batched_step: worlds with custom shapes; ROADMAP 3a")
        out = step_m.step_scenes(flatten(world), config, return_diagnostics)
        if return_diagnostics:
            return unflatten(out[0]), out[1]
        return unflatten(out)

    return step


def gather_metrics(per_scene_metrics):
    """The mean over the scene axis of every per-scene diagnostic (a tensor
    ``[B, ...]``; integers and flags as float32); nested dicts are walked."""
    if isinstance(per_scene_metrics, dict):
        return {k: gather_metrics(v) for k, v in per_scene_metrics.items()}
    if isinstance(per_scene_metrics, torch.Tensor):
        x = per_scene_metrics
        return (x if x.is_floating_point() else x.to(torch.float32)).mean(dim=0)
    return per_scene_metrics
