"""Collision hooks and custom joints of the 3D step against the JAX
reference: ``tests/test_hooks.py``'s two scenes (a ``filter_pairs`` that
drops every pair, the conveyor's ``modify_contacts``) and
``tests/test_custom_constraint.py``'s three (the centre-distance pendulum
and the axis alignment in worlds with no joint slots, and the custom
distance beside a built-in spherical joint), stepped by both packages, the
port's hooks and constraints being the PyTorch versions of
``shared_ext.py``: every body within ``STEP_TOL`` of the reference after
every step, and the JAX tests' own checks on the port.

The reference's trajectories are read from ``extensions_reference.npz``
(``port_common.Recording``, keyed by a digest of its inputs; rerecord with
``record_references.py cases_extensions.py``), except the filtered scene's,
which runs live and is held to the recording."""

from port_common import ieee_reference

ieee_reference()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from avian_tpu import SceneBuilder as JBuilder  # noqa: E402
from avian_tpu.api import custom as jcc  # noqa: E402
from avian_tpu.core.config import PhysicsConfig as JConfig  # noqa: E402
from avian_tpu.math import quat as jquat  # noqa: E402
from avian_tpu.pipeline.step import physics_step as j_step  # noqa: E402
from avian_tpu_torch import SceneBuilder as TBuilder, physics_step  # noqa: E402
from avian_tpu_torch.core.config import PhysicsConfig as TConfig  # noqa: E402
from avian_tpu_torch.math import quat as tquat  # noqa: E402
from avian_tpu_torch.pipeline import xpbd as txpbd  # noqa: E402

import shared_ext as se  # noqa: E402
from port_common import Recording, as_numpy  # noqa: E402

STEP_TOL = 1e-4
# tests/conftest.py's TEST_SHAPE_PAIRS, which tests/test_hooks.py and
# tests/test_custom_constraint.py step with.
PAIRS = ((0, 0), (0, 1), (0, 2), (0, 3), (1, 1), (1, 3), (2, 2), (2, 3))
KW = dict(max_colors=4, shape_pairs=PAIRS)
RECORDING = Recording("extensions")


# ---- the reference's hooks and constraints (tests/test_hooks.py,
# tests/test_custom_constraint.py) ----------------------------------------------

class _JDisableAll:
    def filter_pairs(self, world, ca, cb, valid):
        return valid & False


class _JConveyor:
    def modify_contacts(self, world, contacts):
        on_belt = (contacts.body_a == 0) | (contacts.body_b == 0)
        sign = jnp.where(contacts.body_a == 0, -1.0, 1.0)
        sv = jnp.where(on_belt[:, None], sign[:, None] * jnp.asarray([2.0, 0.0, 0.0]),
                       contacts.surface_velocity)
        return contacts.replace(surface_velocity=sv)


class _JCenterDistance:
    def __init__(self, body_a, body_b, rest, compliance=0.0):
        self.body_a, self.body_b = body_a, body_b
        self.rest, self.compliance = rest, compliance

    def prepare(self, world, s, config):
        return {"cd": jcc.center_difference(world, self.body_a, self.body_b),
                "lagrange": jnp.zeros((), jnp.float32)}

    def solve(self, s, data, h):
        ba = jnp.asarray([self.body_a], jnp.int32)
        bb = jnp.asarray([self.body_b], jnp.int32)
        z = jnp.zeros((1, 3), jnp.float32)
        sep = jcc.current_separation(s, ba, bb, z, z, data["cd"][None, :])
        dist = jnp.linalg.norm(sep, axis=-1)
        dir_ = sep / jnp.maximum(dist, 1e-9)[..., None]
        corr = dir_ * (dist - self.rest)[..., None]
        s, dl = jcc.apply_positional_correction(s, ba, bb, z, z, corr, self.compliance, h)
        return s, {"cd": data["cd"], "lagrange": data["lagrange"] + dl[0]}


class _JAlign:
    def __init__(self, body_a, body_b):
        self.body_a, self.body_b = body_a, body_b

    def prepare(self, world, s, config):
        y = jnp.asarray([0.0, 1.0, 0.0], jnp.float32)
        return {"axis_a": jquat.rotate(world.bodies.quat[self.body_a], y),
                "axis_b": jquat.rotate(world.bodies.quat[self.body_b], y)}

    def solve(self, s, data, h):
        ba = jnp.asarray([self.body_a], jnp.int32)
        bb = jnp.asarray([self.body_b], jnp.int32)
        a1 = jquat.rotate(s.delta_quat[ba], data["axis_a"][None, :])
        a2 = jquat.rotate(s.delta_quat[bb], data["axis_b"][None, :])
        s, _ = jcc.apply_angular_correction(s, ba, bb, jnp.cross(a1, a2), 0.0, h)
        return s, data


def _reference(jw, steps, **kw):
    step = jax.jit(lambda w: j_step(w, JConfig(**KW), **kw))
    pos, quat = [], []
    for _ in range(steps):
        jw = step(jw)
        pos.append(jw.bodies.pos)
        quat.append(jw.bodies.quat)
    return {"pos": jnp.stack(pos), "quat": jnp.stack(quat)}


def run_both(scene, steps, j_kw, t_kw, live=False, held=None):
    """``steps`` steps of ``scene`` (a ``shared_ext`` world builder) by both
    packages with the reference's ``j_kw`` and the port's ``t_kw`` hooks or
    constraints: every body's position within ``STEP_TOL`` after each of the
    first ``held`` steps (all by default), and the rotations after the last
    of them. Returns the port's final world and the scene's ids."""
    jw, ids = scene(JBuilder)
    tw, _ = scene(TBuilder, device="cpu")
    user = repr(sorted((k, type(v).__name__, sorted(vars(v).items())) for k, v in j_kw.items()))
    ref = RECORDING((jw, steps, user), lambda: _reference(jw, steps, **j_kw), live=live)
    config = TConfig(**KW)
    held = steps if held is None else held
    for k in range(steps):
        tw = physics_step(tw, config, **t_kw)
        if k < held:
            np.testing.assert_allclose(as_numpy(tw.bodies.pos), ref.pos[k], atol=STEP_TOL,
                                       rtol=0, err_msg=f"step {k + 1}")
        if k == held - 1:
            np.testing.assert_allclose(as_numpy(tw.bodies.quat), ref.quat[k], atol=STEP_TOL,
                                       rtol=0)
    return tw, ids


# ---- hooks ---------------------------------------------------------------------------

def test_filter_pairs_disables_collisions():
    """test_filter_pairs_disables_collisions: with every pair filtered out
    the ball falls through the ground."""
    tw, ball = run_both(se.drop_through_world, 60, dict(hooks=_JDisableAll()),
                        dict(hooks=se.DisableAll()), live=True)
    assert float(tw.bodies.pos[ball][1]) < -1.0


def test_conveyor_surface_velocity():
    """test_conveyor_surface_velocity: the belt drags the box along +x."""
    tw, box = run_both(se.belt_world, 120, dict(hooks=_JConveyor()), dict(hooks=se.Conveyor()))
    assert float(tw.bodies.pos[box][0]) > -1.0
    assert float(tw.bodies.lin_vel[box][0]) > 0.5


def test_filter_keeps_the_valid_pairs_and_recounts():
    """``filter_pairs``' mask reaches the pair buffer: the dropped slots'
    keys are -1 and ``num_pairs`` counts what is left."""
    from avian_tpu_torch.pipeline import step as tstep

    class DropFirst:
        def filter_pairs(self, world, ca, cb, valid):
            return valid & (ca != 0) & (cb != 0)

    tw, _ = se.belt_world(TBuilder, device="cpu")
    p = tstep.prepare_step(tw, TConfig(**KW), hooks=DropFirst())
    assert int(p.num_pairs) == 0 and bool((p.contacts.pair_key == -1).all())
    p = tstep.prepare_step(tw, TConfig(**KW))
    assert int(p.num_pairs) == 1


# ---- custom joints -----------------------------------------------------------------

def test_center_distance_pendulum():
    """test_center_distance_pendulum, in a world with no joint slots: the
    cube keeps its distance 2 and swings down."""
    jw, (anchor, cube) = se.pendulum_world(JBuilder, rest=2.0)
    assert jw.joints.capacity == 0
    tw, (anchor, cube) = run_both(
        lambda b, **kw: se.pendulum_world(b, rest=2.0, **kw), 120,
        dict(custom_joints=_JCenterDistance(anchor, cube, 2.0)),
        dict(custom_joints=se.CenterDistance(anchor, cube, 2.0)))
    pos = as_numpy(tw.bodies.pos)
    assert np.isfinite(pos).all()
    assert abs(float(np.linalg.norm(pos[cube] - pos[anchor])) - 2.0) < 0.05
    assert pos[cube][1] < -0.5


def test_custom_alongside_builtin_joints():
    """test_custom_alongside_builtin_joints: the custom distance shares the
    built-in joint's position window and Kernel I's velocity projection. The
    two links are a double pendulum: the packages agree within 7e-6 m to
    step 76 and part by 4e-5 m at step 78, as the tip swings through its
    lowest point, so the positions are held for 75 steps and the test's own
    check after its 90."""
    _, (mid, tip) = se.chained_world(JBuilder)
    tw, _ = run_both(se.chained_world, 90, dict(custom_joints=_JCenterDistance(mid, tip, 1.0)),
                     dict(custom_joints=se.CenterDistance(mid, tip, 1.0)), held=75)
    pos = as_numpy(tw.bodies.pos)
    assert np.isfinite(pos).all()
    assert abs(float(np.linalg.norm(pos[tip] - pos[mid])) - 1.0) < 0.08


def test_angular_align_custom():
    """test_angular_align_custom, in a world with no colliders and no joint
    slots: the two bodies' y axes align."""
    _, (a1, a2) = se.aligned_world(JBuilder)
    tw, _ = run_both(se.aligned_world, 90, dict(custom_joints=_JAlign(a1, a2)),
                     dict(custom_joints=se.AlignOrientation(a1, a2)))
    y = as_numpy(tquat.rotate(tw.bodies.quat[[a1, a2]], torch.tensor([0.0, 1.0, 0.0])))
    assert float(np.dot(y[0], y[1])) > 0.999


def test_a_world_without_joint_slots_still_projects():
    """With no joint rows, a custom constraint's deltas still reach the
    velocities through Kernel I's projection (its plain version here): the
    solve's position change over ``h``, and nothing without a constraint."""
    tw, (anchor, cube) = se.pendulum_world(TBuilder, device="cpu")
    from avian_tpu_torch.pipeline import solver_body as tsb

    s = tsb.prepare(tw.bodies)
    con = se.CenterDistance(anchor, cube, 2.0)
    data = con.prepare(tw, s, TConfig(**KW))
    h = 1.0 / 240.0
    s2, _ = txpbd.solve_with_custom(s, None, h, TConfig(**KW), con, data)
    moved = as_numpy(s2.delta_pos[cube])
    assert abs(moved[0] + 0.5) < 1e-3  # pulled 0.5 m in to the rest length
    np.testing.assert_allclose(as_numpy(s2.lin_vel[cube]), moved / h, rtol=1e-5)
    s3, data3 = txpbd.solve_with_custom(s, None, h, TConfig(**KW))
    assert data3 is None and float(s3.lin_vel.abs().max()) == 0.0
