"""Shared helpers of the PyTorch-port parity cases (``cases_*.py``).

Worlds pass between the two packages as numpy arrays: ``World.from_numpy``
takes the JAX world mapped through ``np.asarray``, and ``to_jax`` rebuilds a
JAX world from the port's ``to_numpy`` on a template of the same scene.
This module holds no tests.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from avian_tpu.core.config import PhysicsConfig as JConfig
from avian_tpu_torch.core.config import PhysicsConfig as TConfig
from avian_tpu_torch.core.state import World as TWorld
from avian_tpu_torch.pipeline.step import physics_step as t_step

PAIRS = ((2, 2), (2, 3))  # box/box, box/plane

# The port's CPU tensors here are tiny: one intra-op thread is fastest, and
# leaves the cores to the other test workers.
torch.set_num_threads(1)


def pile_configs(**kw):
    """The cube-pile slice's config in both packages."""
    return (
        JConfig(substeps=4, shape_pairs=PAIRS, **kw),
        TConfig(substeps=4, shape_pairs=PAIRS, **kw),
    )


def to_torch(jax_world) -> TWorld:
    return TWorld.from_numpy(jax.tree.map(np.asarray, jax_world))


def to_jax(port_world: TWorld, template):
    """A JAX world with the port world's leaves and the template's static
    metadata."""
    tn = port_world.to_numpy()

    def group(obj, leaves):
        return obj.replace(**{k: jnp.asarray(v) for k, v in leaves.items()})

    return template.replace(
        bodies=group(template.bodies, tn["bodies"]),
        colliders=group(template.colliders, tn["colliders"]),
        contacts=group(template.contacts, tn["contacts"]),
        joints=group(template.joints, tn["joints"]),
        gravity=jnp.asarray(tn["gravity"]),
        time=jnp.asarray(tn["time"]),
        diverged=jnp.asarray(tn["diverged"]),
        convex_verts=jnp.asarray(tn["convex_verts"]),
    )


def _resting_pile(builder, side, layers, seed):
    """Unit cubes stacked in columns, resting face on face on the ground
    and on each other, with a seeded sideways jitter that makes the columns
    touch."""
    rng = np.random.default_rng(seed)
    g = builder.add_body(body_type=0)
    builder.half_space(g, normal=(0, 1, 0))
    for layer in range(layers):
        for i in range(side):
            for j in range(side):
                jx, jz = rng.uniform(-0.02, 0.02, size=2)
                body = builder.add_body(
                    pos=(i * 1.0 + jx, 0.5 + layer * 1.0 + 1e-3, j * 1.0 + jz)
                )
                builder.box(body, 0.5, 0.5, 0.5, friction=0.5)
    n = side * side * layers
    return builder.finalize(
        max_bodies=n + 1, max_colliders=n + 1, max_contacts=16 * n
    )


def settled_pile(side=4, layers=4, steps=6, seed=0):
    """A resting pile of ``side * side * layers`` (64) cubes stepped
    ``steps`` times by the port on CPU; returns (port world, JAX template of
    the same scene). Contacts, colors and warm-start impulses are populated."""
    from avian_tpu.core.builder import SceneBuilder as JBuilder
    from avian_tpu_torch.core.builder import SceneBuilder as TBuilder

    template = _resting_pile(JBuilder(), side, layers, seed)
    world = _resting_pile(TBuilder(), side, layers, seed)
    _, tcfg = pile_configs()
    for _ in range(steps):
        world = t_step(world, tcfg)
    return world, template


def as_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_columns(ref, port, atol=0.0, skip=(), only=None):
    """Every field of a reference dataclass against the port's: discrete
    fields exactly, float fields within ``atol``."""
    names = only or [f.name for f in dataclasses.fields(ref)]
    for name in names:
        if name in skip:
            continue
        r = np.asarray(getattr(ref, name))
        p = as_numpy(getattr(port, name))
        if r.dtype == np.uint32:
            r = r.view(np.int32)
        assert r.shape == p.shape, (name, r.shape, p.shape)
        if np.issubdtype(r.dtype, np.floating):
            np.testing.assert_allclose(p, r, rtol=0, atol=atol, err_msg=name)
        else:
            np.testing.assert_array_equal(p, r.astype(p.dtype), err_msg=name)
