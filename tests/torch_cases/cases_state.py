"""The port's types, config, state, builder and scenes against the JAX
reference: the same scene must come out leaf for leaf identical."""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import golden_common
from port_common import assert_worlds_equal
from avian_tpu import scenes as jscenes
from avian_tpu.core import config as jconfig
from avian_tpu.core import types as jtypes
from avian_tpu_torch import scenes as tscenes
from avian_tpu_torch.core import config as tconfig
from avian_tpu_torch.core import types as ttypes
from avian_tpu_torch.core.builder import SceneBuilder
from avian_tpu_torch.core.state import World

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.parametrize(
    "enum", ["BodyType", "ShapeType", "CoefficientCombine", "JointType"]
)
def test_enums_match(enum):
    ref = {m.name: int(m) for m in getattr(jtypes, enum)}
    port = {m.name: int(m) for m in getattr(ttypes, enum)}
    assert port == ref


def test_lock_bits_match():
    for name in ("LOCK_TX", "LOCK_TY", "LOCK_TZ", "LOCK_RX", "LOCK_RY",
                 "LOCK_RZ", "LOCK_TRANSLATION", "LOCK_ROTATION"):
        assert getattr(ttypes, name) == getattr(jtypes, name)
    assert ttypes.NUM_SHAPE_TYPES == jtypes.NUM_SHAPE_TYPES


@pytest.mark.parametrize("cls", ["PhysicsConfig", "SolverConfig", "NarrowPhaseConfig"])
def test_config_defaults_match(cls):
    ref = dataclasses.asdict(getattr(jconfig, cls)())
    port = dataclasses.asdict(getattr(tconfig, cls)())
    assert port == ref
    assert tconfig.PhysicsConfig(dt=0.02, substeps=4).substep_dt == 0.005


def _scenes():
    ref_stack3, _ = golden_common.scenes()["stack3"]
    return {
        "cube_pile_27": (jscenes.cube_pile(27)[0], tscenes.cube_pile(27, device="cpu")[0]),
        "cube_pile_27_16N": (
            jscenes.cube_pile(27, seed=3, max_contacts=16 * 27)[0],
            tscenes.cube_pile(27, seed=3, max_contacts=16 * 27, device="cpu")[0],
        ),
        "stack3": (ref_stack3, tscenes.stack3(device="cpu")[0]),
    }


@pytest.mark.parametrize("name", ["cube_pile_27", "cube_pile_27_16N", "stack3"])
def test_scene_matches_reference_leaf_for_leaf(name):
    ref, port = _scenes()[name]
    assert_worlds_equal(ref, port)


def test_from_numpy_round_trip_and_port_dtypes():
    ref, _ = jscenes.cube_pile(8, max_contacts=64)
    tree = jax.tree.map(np.asarray, ref)
    world = World.from_numpy(tree, device="cpu")
    assert world.colliders.layer_members.dtype == torch.int32
    assert int(world.colliders.layer_members[0]) == -1  # 0xFFFFFFFF
    assert world.contacts.pair_key.dtype == torch.int64
    back = world.to_numpy()
    np.testing.assert_array_equal(back["colliders"]["layer_filter"], tree.colliders.layer_filter)
    assert back["colliders"]["layer_filter"].dtype == np.uint32
    np.testing.assert_array_equal(back["contacts"]["pair_key"], tree.contacts.pair_key)
    assert back["contacts"]["pair_key"].dtype == np.int32
    moved = world.to("cpu")
    assert torch.equal(moved.bodies.pos, world.bodies.pos)
    assert moved.device.type == "cpu"


def test_pair_key_rebuilt_as_int64_from_the_pair():
    world, _ = tscenes.cube_pile(8, max_contacts=64, device="cpu")
    c = world.contacts
    c = c.replace(
        active=torch.tensor([True] + [False] * 63),
        collider_a=torch.tensor([5] + [0] * 63, dtype=torch.int32),
        collider_b=torch.tensor([2] + [0] * 63, dtype=torch.int32),
    )
    tree = world.replace(contacts=c).to_numpy()

    class _Tree:
        pass

    obj = _Tree()
    for k, v in tree.items():
        if isinstance(v, dict):
            sub = _Tree()
            sub.__dict__.update(v)
            setattr(obj, k, sub)
        else:
            setattr(obj, k, v)
    rebuilt = World.from_numpy(obj, device="cpu")
    assert int(rebuilt.contacts.pair_key[0]) == 2 * 9 + 5
    assert int(rebuilt.contacts.pair_key[1]) == -1


def test_entry_points_default_to_the_card_and_say_so_without_one():
    """``device=None`` means CUDA; without a card that raises and names the
    missing card, instead of quietly building a CPU world."""
    assert not torch.cuda.is_available()  # these cases run on the CPU
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tscenes.cube_pile(8)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        World.zeros(4)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        World.from_numpy(jax.tree.map(np.asarray, jscenes.cube_pile(8, max_contacts=64)[0]))
    assert tscenes.cube_pile(8, device="cpu")[0].device.type == "cpu"


def test_builder_refuses_unported_shapes():
    """Raw TRIANGLE, TRIMESH and HEIGHTFIELD codes (the builder makes those
    shapes out of pool-backed CONVEX triangles) and convex decomposition are
    refused. Custom shapes are ported: ``custom_collider`` stores code
    ``CUSTOM_SHAPE_BASE + index`` and, as the reference's, refuses a
    collider without mass and inertia."""
    b = SceneBuilder()
    body = b.add_body()
    for shape in (ttypes.ShapeType.TRIANGLE, ttypes.ShapeType.TRIMESH,
                  ttypes.ShapeType.HEIGHTFIELD):
        with pytest.raises(NotImplementedError):
            b.add_collider(body, shape, (0.5,))
    with pytest.raises(NotImplementedError):
        b.convex_decomposition(body, [(0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1)],
                               [(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)])
    assert b.custom_collider(body, index=0, mass=1.0, inertia=(1.0, 1.0, 1.0)) == 0
    assert b._colliders[0]["shape"] == ttypes.CUSTOM_SHAPE_BASE
    with pytest.raises(ValueError):
        b.custom_collider(body, index=0)


def test_import_leaves_jax_out():
    code = (
        "import sys, avian_tpu_torch, avian_tpu_torch.pipeline.step;"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'avian_tpu' or m.startswith('avian_tpu.')];"
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=REPO)
