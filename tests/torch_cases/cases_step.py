"""The ported slice end to end: one ``physics_step`` of a settled pile
against the JAX reference (1e-4 abs), the ``stack3`` golden trajectory
(1e-3), the all-asleep early-out, the NaN quarantine, determinism, and the
cases the slice refuses. The reference's step is read from
``step_reference.npz`` (``port_common.Recording``, keyed by a digest of its
inputs; rerecord with ``record_references.py cases_step.py``)."""

import os

import jax
import numpy as np
import pytest
import torch

from avian_tpu import BodyType as JBodyType
from avian_tpu import SceneBuilder as JBuilder
from avian_tpu.pipeline.step import physics_step as j_step
from avian_tpu_torch import PhysicsConfig, World, physics_step, rollout, scenes
from avian_tpu_torch.core.state import Joints

from port_common import Recording, pile_configs, settled_pile, to_jax, to_torch

GOLDEN = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "golden", "stack3.npz"
)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


RECORDING = Recording("step")


def _ref_step(jw, jcfg):
    rw, rd = j_step(jw, jcfg, return_diagnostics=True)
    return {"bodies": {n: getattr(rw.bodies, n) for n in (
                "pos", "quat", "lin_vel", "ang_vel", "sleep_timer", "sleeping", "island")},
            "contacts": {n: getattr(rw.contacts, n) for n in (
                "pair_key", "collider_a", "collider_b", "active", "touching", "num_points",
                "color", "contact_id", "was_touching", "normal_impulse")},
            "time": rw.time, "diag": dict(rd)}


def test_one_step_of_settled_pile_matches_reference():
    tw, template = settled_pile()
    jcfg, tcfg = pile_configs()
    start = to_jax(tw, template)
    ref = RECORDING((start, repr(jcfg)), lambda: _ref_step(start, jcfg))
    jw, jd = ref, ref.diag
    pw, pd = physics_step(tw, tcfg, return_diagnostics=True)
    for name in ("pos", "quat", "lin_vel", "ang_vel", "sleep_timer"):
        np.testing.assert_allclose(_np(getattr(pw.bodies, name)), _np(getattr(jw.bodies, name)),
                                   atol=1e-4, rtol=0, err_msg=name)
    for name in ("sleeping", "island"):
        np.testing.assert_array_equal(_np(getattr(pw.bodies, name)), _np(getattr(jw.bodies, name)))
    for name in ("pair_key", "collider_a", "collider_b", "active", "touching", "num_points",
                 "color", "contact_id", "was_touching"):
        np.testing.assert_array_equal(_np(getattr(pw.contacts, name)),
                                      _np(getattr(jw.contacts, name)).astype(_np(getattr(pw.contacts, name)).dtype),
                                      err_msg=name)
    np.testing.assert_allclose(_np(pw.contacts.normal_impulse).sum(1),
                               _np(jw.contacts.normal_impulse).sum(1), atol=1e-4, rtol=0)
    np.testing.assert_allclose(_np(pw.time), _np(jw.time), rtol=0, atol=0)
    for key in ("num_pairs", "dropped_pairs", "overflow_dropped", "num_overflow",
                "num_touching", "num_contact_points", "num_sleeping", "nonfinite_bodies"):
        assert int(pd[key]) == int(jd[key]), key
    assert set(jd) <= set(pd)
    assert pd["stepped"] and int(pd["num_touching"]) > 64


def test_stack3_first_200_steps_follow_the_golden():
    golden = np.load(GOLDEN)["pos"]
    world, _ = scenes.stack3(device="cpu")
    config = PhysicsConfig(dt=1.0 / 64.0, max_colors=8)
    frames = []
    for i in range(200):
        world = physics_step(world, config)
        if (i + 1) % 10 == 0:
            frames.append(_np(world.bodies.pos))
    drift = np.abs(np.stack(frames) - golden[:20]).max()
    assert drift <= 1e-3, drift
    assert bool(world.bodies.sleeping[1:].all())  # the stack came to rest


def _asleep_stack():
    """``stack3`` with every dynamic body asleep and a force written to the
    static ground only (a force on a sleeping dynamic body wakes it, see
    ``cases_ccd.py::test_constant_force_wakes_a_sleeping_body``), so that
    nothing can move and the skipped step still has an accumulator to
    clear."""
    world, _ = scenes.stack3(device="cpu")
    b = world.bodies
    dyn = b.body_type == 1
    return world.replace(bodies=b.replace(
        sleeping=dyn.clone(), sleep_pos=b.pos.clone(), sleep_quat=b.quat.clone(),
        force=torch.where(dyn[:, None], 0.0, torch.ones_like(b.force)),
    ))


def test_all_asleep_early_out_skips_the_step():
    world = _asleep_stack()
    config = PhysicsConfig(dt=1.0 / 64.0, max_colors=8)
    out, diag = physics_step(world, config, return_diagnostics=True)
    assert diag["stepped"] is False
    assert torch.equal(out.bodies.pos, world.bodies.pos)
    assert float(out.time) == pytest.approx(1.0 / 64.0)
    assert float(out.bodies.force.abs().max()) == 0.0


def test_velocity_written_to_a_sleeping_body_wakes_the_step():
    """The reference's early-out skips this step and loses the write; the
    port steps and the body moves."""
    world = _asleep_stack()
    b = world.bodies
    lin = b.lin_vel.clone()
    lin[3] = torch.tensor([2.0, 0.0, 0.0])
    world = world.replace(bodies=b.replace(lin_vel=lin))
    config = PhysicsConfig(dt=1.0 / 64.0, max_colors=8)
    out, diag = physics_step(world, config, return_diagnostics=True)
    assert diag["stepped"] is True
    assert not bool(out.bodies.sleeping[3])  # woken, velocity kept
    assert float(out.bodies.lin_vel[3, 0]) == 2.0
    out = physics_step(out, config)
    assert float(out.bodies.pos[3, 0]) > float(world.bodies.pos[3, 0])


def test_nan_quarantine_freezes_and_flags():
    world, _ = scenes.stack3(device="cpu")
    b = world.bodies
    lin = b.lin_vel.clone()
    lin[2, 1] = float("nan")
    world = world.replace(bodies=b.replace(lin_vel=lin))
    out, diag = physics_step(world, PhysicsConfig(dt=1.0 / 64.0), return_diagnostics=True)
    assert bool(out.diverged) and bool(diag["diverged"])
    assert int(diag["nonfinite_bodies"]) >= 1
    assert torch.equal(out.bodies.pos, world.bodies.pos)


def test_rollout_and_determinism():
    config = pile_configs()[1]
    world, _ = scenes.cube_pile(27, max_contacts=16 * 27, device="cpu")
    a = rollout(world, config, 6)
    b = world
    for _ in range(6):
        b = physics_step(b, config)
    for name in ("pos", "quat", "lin_vel", "ang_vel"):
        assert torch.equal(getattr(a.bodies, name), getattr(b.bodies, name)), name


class _Idle:
    """A custom constraint that changes nothing."""

    def prepare(self, world, s, config):
        return None

    def solve(self, s, data, h):
        return s, data


@pytest.mark.parametrize("case", ["hooks", "custom_joints", "custom_shapes"])
def test_unported_features_raise(case):
    """The step takes hooks, custom joints and custom shapes: an object with
    neither hook, a constraint that changes nothing and a custom shape no
    collider uses leave ``stack3``'s step bit for bit as it is without them;
    a collider whose code names a custom shape past the given tuple
    raises."""
    from avian_tpu_torch.api import CustomShape

    world, _ = scenes.stack3(device="cpu")
    shape = CustomShape("unused", support=lambda prm, d: d, aabb_half_extents=lambda prm: prm[:, :3])
    kw = {"hooks": object(), "custom_joints": _Idle(), "custom_shapes": (shape,)}[case]
    plain = physics_step(world, PhysicsConfig())
    got = physics_step(world, PhysicsConfig(), **{case: kw})
    for name in ("pos", "quat", "lin_vel", "ang_vel"):
        assert torch.equal(getattr(got.bodies, name), getattr(plain.bodies, name)), name
    if case == "custom_shapes":
        st = world.colliders.shape_type.clone()
        st[1] = 17  # a second custom shape, which the tuple lacks
        bad = world.replace(colliders=world.colliders.replace(shape_type=st))
        with pytest.raises(ValueError):
            physics_step(bad, PhysicsConfig(), **{case: kw})


def test_an_active_joint_is_solved():
    """A fixed joint between the first two cubes of ``stack3`` (joints are
    ported): the step keeps their anchors together and stores its force."""
    world, ids = scenes.stack3(device="cpu")
    j = Joints.zeros(1, device="cpu")
    a, b = ids[0], ids[1]
    offset = world.bodies.pos[b] - world.bodies.pos[a]
    world = world.replace(joints=j.replace(
        active=torch.ones(1, dtype=torch.bool), body_a=torch.tensor([a], dtype=torch.int32),
        body_b=torch.tensor([b], dtype=torch.int32), frame_pos_a=offset[None, :].clone()))
    for _ in range(30):
        world = physics_step(world, PhysicsConfig())
    gap = world.bodies.pos[b] - world.bodies.pos[a]
    assert float((gap - offset).abs().max()) < 0.01
    assert float(world.joints.total_lambda.abs().max()) > 0.0
    assert int(world.joints.color[0]) >= 0


def test_unported_shape_pair_raises():
    """A collider with the TRIMESH code written into the world directly (the
    builders make trimeshes out of CONVEX triangles) resting on the ground
    reaches the narrowphase: refused."""
    b = JBuilder()
    g = b.add_body(body_type=JBodyType.STATIC)
    b.half_space(g)
    s = b.add_body(pos=(0.0, 0.1, 0.0))
    b.segment(s, (-0.5, 0.0, 0.0), (0.5, 0.0, 0.0))
    jw = b.finalize(max_bodies=2, max_colliders=2, max_contacts=16)
    world = World.from_numpy(jax.tree.map(np.asarray, jw), device="cpu")
    col = world.colliders
    world = world.replace(colliders=col.replace(shape_type=torch.tensor([3, 9], dtype=torch.int32)))
    with pytest.raises(NotImplementedError):
        physics_step(world, PhysicsConfig())
    assert to_torch(jw).colliders.shape_type.tolist() == [3, 6]  # half-space, segment
