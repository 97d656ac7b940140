"""The port's 2D joints, custom joints, collision hooks and forces against
the JAX reference (``avian_tpu.dim2``) on the CPU, where Kernel AA runs as
its plain PyTorch twins: the joint rows of a seeded world with every joint
type, one substep of the joint solve for each type (a violated revolute
limit, a violated prismatic limit, an overflow colour with two joints on one
body), ``falling_hinges_2d(4, 4)``, the five 2D joint examples, the custom
pendulum of ``tests/test_dim2_api.py``, both collision hooks, the forces API
and a constant force on a sleeping body.

Tolerances: rows 1e-6 (PyTorch's CPU ``cos``/``sin`` are a few ulp off
XLA's); one substep 1e-5; whole steps 1e-4 m and rad on positions and angles
(the order of the warm start's per-body sums and those ulps, amplified by
the contacts), 1e-3 on velocities (the joints' velocity projection divides
the delta pose's change by the substep, 1/240 s or less, which scales a
position's last bits by 240 and more), and 1e-4 of a velocity's size (a
chain link spins at 70 rad/s as it straightens); the hinges' Lagrange
totals 1e-3 of
their largest (a total is the sum of a step's corrections over h^2).
Colours, masks and flags exactly.

The reference's whole-step runs are read from ``dim2_joints_reference.npz``
(``port_common.Recording``, keyed by a digest of their inputs; rerecord with
``record_references.py cases_dim2_joints.py``); its prepared joints and one
substep run live.
"""

from port_common import ieee_reference

ieee_reference()

import math  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from avian_tpu import PhysicsConfig as JConfig  # noqa: E402
from avian_tpu.dim2 import SceneBuilder2D as JBuilder2D  # noqa: E402
from avian_tpu.dim2 import custom as jcustom  # noqa: E402
from avian_tpu.dim2 import dynamics as jdyn  # noqa: E402
from avian_tpu.dim2 import forces as jforces  # noqa: E402
from avian_tpu.dim2 import xpbd as jxpbd  # noqa: E402
from avian_tpu.dim2.step import physics_step_2d as j_step  # noqa: E402
from avian_tpu_torch import PhysicsConfig as TConfig  # noqa: E402
from avian_tpu_torch.core.types import BodyType, JointType  # noqa: E402
from avian_tpu_torch.dim2 import SceneBuilder2D as TBuilder2D  # noqa: E402
from avian_tpu_torch.dim2 import custom as tcustom  # noqa: E402
from avian_tpu_torch.dim2 import forces as tforces  # noqa: E402
from avian_tpu_torch.dim2 import physics_step_2d  # noqa: E402
from avian_tpu_torch.dim2 import scenes as tscenes  # noqa: E402
from avian_tpu_torch.dim2 import xpbd as txpbd  # noqa: E402
from avian_tpu_torch.dim2.broadphase import collider_poses  # noqa: E402
from avian_tpu_torch.dim2.dynamics import prepare as t_prepare  # noqa: E402

import shared_2d as examples2d  # noqa: E402
from cases_dim2 import assert_worlds_equal, to_jax2d  # noqa: E402
from port_common import Recording, as_numpy  # noqa: E402

torch.set_num_threads(1)
ROW_TOL, SUBSTEP_TOL, STEP_TOL, VEL_TOL, VEL_RTOL = 1e-6, 1e-5, 1e-4, 1e-3, 1e-4
HINGE_STEPS, EXAMPLE_STEPS = 40, 60
KW = dict(substeps=4, max_colors=8)
RECORDING = Recording("dim2_joints")
# The bodies' columns a lockstep holds after each step, and what the forces'
# writes are held on besides.
STEP_COLS = ("pos", "angle", "lin_vel", "ang_vel")
WRITE_COLS = STEP_COLS + ("force", "torque", "const_force", "const_torque", "sleep_timer",
                          "sleeping")


def _close(port, ref, atol, what, rtol=0.0):
    np.testing.assert_allclose(as_numpy(port), np.asarray(ref), atol=atol, rtol=rtol,
                               err_msg=what)


def _both(make):
    """The world of ``make(builder, **finalize_kw)`` from both builders, held
    leaf for leaf."""
    jw, tw = make(JBuilder2D()), make(TBuilder2D(), device="cpu")
    assert_worlds_equal(jw, tw)
    return jw, tw


def _cols(world, names):
    return {name: getattr(world.bodies, name) for name in names}


def _ref_steps(jw, jcfg, steps):
    """The reference's ``steps`` steps from ``jw``: each step's ``STEP_COLS``
    stacked, and the last world."""
    out = []
    for _ in range(steps):
        jw = j_step(jw, jcfg)
        out.append(_cols(jw, STEP_COLS))
    return {k: jnp.stack([o[k] for o in out]) for k in STEP_COLS}, jw


def _hold_step(tw, ref, i):
    """Step ``i``'s positions and angles within ``STEP_TOL``, velocities
    within ``VEL_TOL`` and ``VEL_RTOL`` of their size."""
    for name, tol, rtol in (("pos", STEP_TOL, 0.0), ("angle", STEP_TOL, 0.0),
                            ("lin_vel", VEL_TOL, VEL_RTOL), ("ang_vel", VEL_TOL, VEL_RTOL)):
        _close(getattr(tw.bodies, name), ref[name][i], tol, f"step {i + 1} {name}", rtol)


def _lockstep(ref, tw, tcfg, steps, **t_kw):
    """Step the port ``steps`` times, each step held to the reference's
    recorded step ``ref`` (``_ref_steps``' stack). Returns the port's
    world."""
    for i in range(steps):
        tw = physics_step_2d(tw, tcfg, **t_kw)
        _hold_step(tw, ref, i)
    return tw


def _joint_zoo(b, **finalize_kw):
    """A seeded world with every 2D joint type near its rest pose: a fixed
    joint with a reference angle and compliance, a distance joint beyond its
    band, a revolute joint past its angle limit, a prismatic joint past its
    axis limit on a static rail, three joints on one hub (two of them share it
    in the overflow colour at 2 colours), a loop of four revolute joints and
    a distance joint with damping, an offset centre of mass and a body with
    locked rotation."""
    rng = np.random.default_rng(3)

    def body(x, y, angle=0.0, **kw):
        i = b.add_body(pos=(x + rng.uniform(-0.02, 0.02), y + rng.uniform(-0.02, 0.02)),
                       angle=angle + rng.uniform(-0.05, 0.05), lin_vel=tuple(rng.normal(size=2)),
                       ang_vel=float(rng.normal()), **kw)
        b.box(i, 0.25, 0.1)
        return i

    def near():
        return tuple(rng.uniform(-0.02, 0.02, 2))

    a, c = body(0.0, 2.0), body(0.62, 2.05)
    b.add_joint(JointType.FIXED, a, c, anchor_a=(0.3, 0.0), anchor_b=(-0.3, 0.0),
                reference_angle=0.05, compliance=(1e-4, 1e-3, 0.0, 0.0))
    a, c = body(2.0, 2.0), body(3.0, 2.0, com=(0.05, -0.03))
    b.add_joint(JointType.DISTANCE, a, c, anchor_a=(0.2, 0.0), limit_min=0.4, limit_max=0.6,
                lin_damping=0.5)
    a, c = body(4.0, 2.0), body(4.6, 2.0, angle=0.4)
    b.add_joint(JointType.REVOLUTE, a, c, anchor_a=(0.3, 0.0), anchor_b=(-0.3, 0.0),
                limit_enabled=True, limit_min=-0.2, limit_max=0.1, ang_damping=1.0)
    rail = b.add_body(body_type=BodyType.STATIC, pos=(6.0, 3.0))
    c = body(6.05, 1.9, locked_axes=4)
    b.add_joint(JointType.PRISMATIC, rail, c, axis_angle=math.pi / 2, limit_enabled=True,
                limit_min=-1.0, limit_max=0.0)
    hub = body(8.0, 2.0)
    for k, (x, y) in enumerate(((8.6, 2.0), (7.4, 2.0), (8.0, 2.6))):
        arm = body(x, y)
        b.add_joint((JointType.REVOLUTE, JointType.FIXED, JointType.DISTANCE)[k], hub, arm,
                    anchor_a=(x - 8.0, y - 2.0), anchor_b=near(), limit_min=0.5,
                    limit_max=0.7)
    loop = [body(10.0 + 0.6 * k, 2.0) for k in range(5)]
    for k in range(4):
        b.add_joint(JointType.REVOLUTE, loop[k], loop[k + 1], anchor_a=(0.3, 0.0),
                    anchor_b=(-0.3, 0.0), compliance=(1e-5, 0.0, 0.0, 0.0))
    b.add_joint(JointType.DISTANCE, loop[4], loop[0], limit_min=2.4, limit_max=2.4,
                lin_damping=2.0, ang_damping=2.0)
    return b.finalize(max_bodies=20, max_colliders=20, max_contacts=64, max_joints=16,
                      **finalize_kw)


def _references(jw, jcfg, h):
    """The reference's prepared joints, and a jitted substep of its joint
    solve from a given solver state."""
    prep = jax.jit(jxpbd.prepare_joints, static_argnums=2)

    def substep(w, js):
        jc = jxpbd.prepare_joints(w, jdyn.prepare(w.bodies), jcfg)
        js, jc, _ = jxpbd.solve_position_constraints(js, jc, w.bodies, h, jcfg)
        return js, jc

    return prep(jw, jdyn.prepare(jw.bodies), jcfg), jax.jit(substep)


@pytest.mark.parametrize("colors", [8, 2])
def test_prepare_and_one_substep_match_reference(colors):
    """Kernel AA's ``joint_rows_2d`` with Kernel G's colours against the
    reference's ``prepare_joints``; then one substep of the joint solve
    (every colour, the velocity projection, damping) from a seeded
    mid-substep state: at 2 colours the overflow colour has joints that share
    a body. Every joint's correction acted (its Lagrange total is not 0)."""
    jw, tw = _both(_joint_zoo)
    jcfg, tcfg = JConfig(max_colors=colors), TConfig(max_colors=colors)
    h = tcfg.substep_dt
    jc, j_substep = _references(jw, jcfg, h)
    s, _ = t_prepare(tw.bodies, tw.gravity, h)
    tc = txpbd.prepare_joints(tw, s, collider_poses(tw), tcfg)
    for name in ("world_r1", "world_r2", "center_difference", "base_angle", "axis_world",
                 "compliance", "limit_min", "limit_max", "lin_damping", "ang_damping",
                 "inv_mass_a", "inv_mass_b", "inv_mass_vec_a", "inv_mass_vec_b",
                 "inv_inertia_a", "inv_inertia_b"):
        _close(getattr(tc, name), getattr(jc, name), ROW_TOL, name)
    for name in ("limit_enabled", "mask", "color", "color_j"):
        np.testing.assert_array_equal(as_numpy(getattr(tc, name)),
                                      np.asarray(getattr(jc, name)), err_msg=name)

    rng = np.random.default_rng(5)
    n = tw.bodies.capacity
    s.state[:] += torch.from_numpy(rng.uniform(-0.01, 0.01, (n, 6)).astype(np.float32))
    js = jdyn.prepare(jw.bodies).replace(
        lin_vel=jnp.asarray(as_numpy(s.lin_vel)), ang_vel=jnp.asarray(as_numpy(s.ang_vel)),
        delta_pos=jnp.asarray(as_numpy(s.delta_pos)),
        delta_angle=jnp.asarray(as_numpy(s.delta_angle)))
    js, jc = j_substep(jw, js)
    s, _ = txpbd.solve_position_constraints(s, tc, h, tcfg)
    for name in ("lin_vel", "ang_vel", "delta_pos", "delta_angle"):
        _close(getattr(s, name), getattr(js, name), SUBSTEP_TOL, name)
    _close(tc.total_pos_lagrange, jc.total_pos_lagrange, SUBSTEP_TOL, "total_pos_lagrange")
    _close(tc.total_rot_lagrange, jc.total_rot_lagrange, SUBSTEP_TOL, "total_rot_lagrange")
    on = tc.mask > 0
    assert bool((tc.lam[on].abs().amax(1) > 0).all())
    if colors == 2:
        ends = torch.cat([tc.body_a, tc.body_b])[torch.cat([tc.color_j, tc.color_j]) == 1]
        assert ends.numel() > torch.unique(ends).numel()  # a body shared in the overflow colour


def test_falling_hinges_2d_matches_reference():
    """``scenes.falling_hinges_2d(4, 4)`` (built leaf for leaf as the JAX
    builder builds it) for ``HINGE_STEPS`` steps: the boxes land on the
    ground at step 35; then the Lagrange totals."""

    def make(b, **kw):
        g = b.add_body(body_type=BodyType.STATIC)
        b.half_space(g, normal=(0, 1))
        ids = tscenes._hinge_rows(b, 4, 4, 0.25)
        return b.finalize(max_bodies=17, max_colliders=17, max_contacts=136, max_joints=12, **kw)

    jw = make(JBuilder2D())
    tw, ids = tscenes.falling_hinges_2d(4, 4, device="cpu")
    assert_worlds_equal(jw, tw)
    jcfg = JConfig(**KW)

    def reference():
        steps, last = _ref_steps(jw, jcfg, HINGE_STEPS)
        return {"steps": steps, "total_lambda": last.joints.total_lambda,
                "color": last.joints.color}

    ref = RECORDING((jw, repr(jcfg), HINGE_STEPS), reference)
    tw = _lockstep(ref.steps, tw, TConfig(**KW), HINGE_STEPS)
    lam = ref.total_lambda
    _close(tw.joints.total_lambda, lam, 1e-3 * np.abs(lam).max(), "total_lambda")
    np.testing.assert_array_equal(as_numpy(tw.joints.color), ref.color)
    assert float(tw.bodies.pos[1:, 1].min()) < 0.5  # landed


# Where each example of ``shared_2d`` sits in the shared world, and
# the custom pendulum and the hooks' boxes: close to the origin, so that the
# positions keep the precision the examples have alone.
EXAMPLE_OFFSETS = {"chain_2d": (0.0, 0.0), "revolute_joint_2d": (-7.0, 0.0),
                   "distance_joint_2d": (8.0, 0.0), "fixed_joint_2d": (-11.0, 0.0),
                   "prismatic_joint_2d": (12.0, 0.0)}
PENDULUM_AT, BOXES_AT = (-16.0, 10.0), 16.0
# A run that parts from the reference as the reference parts from itself: a
# group of bodies is held to STEP_TOL while the reference's own run from a
# start nudged by one ulp stays within OWN_TOL of it, and after that to twice
# that run's distance plus STEP_TOL (ROADMAP 3a).
OWN_TOL, PART_FACTOR = 1e-5, 2.0


class JCenterDistance2D:
    """``tests/test_dim2_api.py:275``'s user constraint: a centre distance
    held at its rest length."""

    def __init__(self, body_a, body_b, rest):
        self.body_a, self.body_b, self.rest = body_a, body_b, rest

    def prepare(self, world, s, config):
        return {"cd": jcustom.center_difference(world, self.body_a, self.body_b)}

    def solve(self, s, data, h):
        ba = jnp.asarray([self.body_a], jnp.int32)
        bb = jnp.asarray([self.body_b], jnp.int32)
        z = jnp.zeros((1, 2), jnp.float32)
        sep = jcustom.current_separation(s, ba, bb, z, z, data["cd"][None, :])
        dist = jnp.linalg.norm(sep, axis=-1)
        dir_ = sep / jnp.maximum(dist, 1e-9)[..., None]
        corr = dir_ * (dist - self.rest)[..., None]
        s, _ = jcustom.apply_positional_correction(s, ba, bb, z, z, corr, 0.0, h)
        return s, data


class TCenterDistance2D(JCenterDistance2D):
    """The same constraint in PyTorch on the port's solver state."""

    def prepare(self, world, s, config):
        return {"cd": tcustom.center_difference(world, self.body_a, self.body_b)}

    def solve(self, s, data, h):
        ba, bb = torch.tensor([self.body_a]), torch.tensor([self.body_b])
        z = torch.zeros((1, 2))
        sep = tcustom.current_separation(s, ba, bb, z, z, data["cd"][None, :])
        dist = torch.linalg.vector_norm(sep, dim=-1)
        dir_ = sep / torch.clamp(dist, min=1e-9)[..., None]
        corr = dir_ * (dist - self.rest)[..., None]
        s, _ = tcustom.apply_positional_correction(s, ba, bb, z, z, corr, 0.0, h)
        return s, data


class JHooks:
    """Both collision hooks: ``filter_pairs`` turns the ghost box's pairs
    off; ``modify_contacts`` takes the friction off the slider box's
    contacts and adds bounce."""

    def __init__(self, ghost, slider):
        self.ghost, self.slider = ghost, slider

    def filter_pairs(self, world, ca, cb, valid):
        body = world.colliders.body_idx
        return valid & (body[ca] != self.ghost) & (body[cb] != self.ghost)

    def modify_contacts(self, world, contacts):
        on = (contacts.body_a == self.slider) | (contacts.body_b == self.slider)
        return contacts.replace(friction=jnp.where(on, 0.0, contacts.friction),
                                static_friction=jnp.where(on, 0.0, contacts.static_friction),
                                restitution=jnp.where(on, contacts.restitution + 0.5,
                                                      contacts.restitution))


class THooks(JHooks):
    """The same hooks in PyTorch on the port's tensors."""

    def filter_pairs(self, world, ca, cb, valid):
        body = world.colliders.body_idx
        return valid & (body[ca.long()] != self.ghost) & (body[cb.long()] != self.ghost)

    def modify_contacts(self, world, contacts):
        on = (contacts.body_a == self.slider) | (contacts.body_b == self.slider)
        return contacts.replace(friction=torch.where(on, 0.0, contacts.friction),
                                static_friction=torch.where(on, 0.0, contacts.static_friction),
                                restitution=torch.where(on, contacts.restitution + 0.5,
                                                        contacts.restitution))


def _extensions(b, **kw):
    """One world for the lockstep with hooks and a custom joint: the five
    joint examples side by side, the custom pendulum and, on a ground
    half-space, a ghost box and a slider box moving at 3 m/s. Returns the
    world and its groups of bodies {name: ids}."""
    g = b.add_body(body_type=BodyType.STATIC)
    b.half_space(g, normal=(0, 1), friction=0.6)
    groups = {name: examples2d.add(name, b, *at) for name, at in EXAMPLE_OFFSETS.items()}
    anchor = b.add_body(body_type=BodyType.STATIC, pos=PENDULUM_AT)
    b.box(anchor, 0.25, 0.25)
    bob = b.add_body(pos=(PENDULUM_AT[0] + 2.0, PENDULUM_AT[1]))
    b.box(bob, 0.25, 0.25)
    groups["pendulum"] = [anchor, bob]
    groups["boxes"] = []
    for x in (BOXES_AT, BOXES_AT + 3.0):
        groups["boxes"].append(b.add_body(pos=(x, 0.6), lin_vel=(3.0, 0.0)))
        b.box(groups["boxes"][-1], 0.5, 0.5, friction=0.6)
    return b.finalize(max_bodies=22, max_colliders=24, max_contacts=64, max_joints=12,
                      **kw), groups


def _nudged(jw, bodies):
    """The JAX world with the x position of each of ``bodies`` one ulp up."""
    pos = np.asarray(jw.bodies.pos).copy()
    pos[bodies, 0] = np.nextafter(pos[bodies, 0], np.float32(np.inf))
    return jw.replace(bodies=jw.bodies.replace(pos=jnp.asarray(pos)))


def test_examples_custom_joint_and_hooks_match_reference():
    """One world stepped ``EXAMPLE_STEPS`` times in both packages with both
    hooks and the custom pendulum: the five joint examples' worlds (their own
    checks, after their own step counts, run on the card in
    ``chip_smoke.py``'s phase ``dim2 examples``), ``tests/test_dim2_api.py
    :275``'s pendulum held at its rest length, the ghost box falling through
    the ground and the slider sliding on. Each group of bodies is held to
    ``STEP_TOL`` while the reference holds itself (the chain and the revolute
    pendulum amplify a 1-ulp nudge of their start to 1e-4 m within ten
    steps, ROADMAP 3a), then to ``PART_FACTOR`` x the reference's own
    distance."""
    jw, groups = _extensions(JBuilder2D())
    tw, _ = _extensions(TBuilder2D(), device="cpu")
    assert_worlds_equal(jw, tw)
    jn = _nudged(jw, [ids[-1] for name, ids in groups.items() if name in EXAMPLE_OFFSETS])
    bob, (ghost, slider) = groups["pendulum"][1], groups["boxes"]
    hooks = JHooks(ghost, slider), THooks(ghost, slider)
    custom = JCenterDistance2D(bob - 1, bob, 2.0), TCenterDistance2D(bob - 1, bob, 2.0)
    jcfg, tcfg = JConfig(max_colors=8), TConfig(max_colors=8)

    def reference():
        runs = {"ref": [], "nudged": []}
        for w, run in ((jw, runs["ref"]), (jn, runs["nudged"])):
            for _ in range(EXAMPLE_STEPS):
                w = j_step(w, jcfg, hooks=hooks[0], custom_joints=custom[0])
                run.append(_cols(w, STEP_COLS))
        return {name: {k: jnp.stack([o[k] for o in run]) for k in STEP_COLS}
                for name, run in runs.items()}

    user = repr((vars(hooks[0]), vars(custom[0]), EXAMPLE_STEPS))
    ref = RECORDING((jw, jn, repr(jcfg), user), reference)
    parted = {}
    for i in range(EXAMPLE_STEPS):
        tw = physics_step_2d(tw, tcfg, hooks=hooks[1], custom_joints=custom[1])
        for name, ids in groups.items():
            for col in ("pos", "angle"):
                want = ref.ref[col][i][ids]
                port = as_numpy(getattr(tw.bodies, col))[ids]
                own = float(np.abs(ref.nudged[col][i][ids] - want).max())
                if own > OWN_TOL:
                    parted.setdefault(name, i + 1)
                tol = PART_FACTOR * own + STEP_TOL if name in parted else STEP_TOL
                _close(port, want, tol, f"step {i + 1} {name} {col}")
            if name not in parted:
                for col in ("lin_vel", "ang_vel"):
                    _close(as_numpy(getattr(tw.bodies, col))[ids], ref.ref[col][i][ids],
                           VEL_TOL, f"step {i + 1} {name} {col}", VEL_RTOL)
    assert "pendulum" not in parted and "boxes" not in parted
    pos = as_numpy(tw.bodies.pos)
    assert abs(float(np.linalg.norm(pos[bob] - pos[bob - 1])) - 2.0) < 0.05
    assert pos[bob][1] < PENDULUM_AT[1] - 0.5  # swung down
    assert pos[ghost][1] < -4.0 and pos[slider][0] > BOXES_AT + 3.0 + 2.0  # fell for 1 s


def _forces_world(b, **kw):
    """A free ball without gravity (``tests/test_dim2_api.py``'s
    ``free_ball``) and a 1 m box resting on a ground half-space."""
    ball = b.add_body(pos=(0.0, 10.0), gravity_scale=0.0)
    b.circle(ball, 0.5)
    g = b.add_body(body_type=BodyType.STATIC)
    b.half_space(g, normal=(0, 1))
    box = b.add_body(pos=(5.0, 0.5))
    b.box(box, 0.5, 0.5)
    return b.finalize(max_bodies=3, max_colliders=3, max_contacts=8, **kw)


def _forces_run(forces, step, w0, cfg, ball, box, mass, inertia):
    """The forces test's writes and steps in one package (its ``forces``
    module and ``step``) from ``w0``: ``[(what, kind, world)]`` after each
    write and step, ``kind`` "write" (held on ``WRITE_COLS``), "step" (held
    as a lockstep holds it) or "free" (not held)."""
    out = []

    def at(what, kind, w):
        out.append((what, kind, w))
        return w

    def steps(what, w, n, kind="step"):
        for k in range(n):
            w = at(f"{what} step {k + 1}", kind, step(w, cfg))
        return w

    # apply_force accelerates; the accumulator is cleared after a step.
    steps("force", at("force", "write", forces.apply_force(w0, ball, (mass * 3.0, 0.0))), 2)
    # apply_torque, then a constant torque.
    w = steps("torque", forces.apply_torque(w0, ball, inertia * 2.0), 1)
    steps("constant torque",
          at("constant torque", "free", forces.set_constant_torque(w, ball, inertia * 2.0)), 2)
    # Impulses, and an impulse at a point (above the centre: clockwise).
    at("impulses", "write", forces.apply_angular_impulse(
        forces.apply_linear_impulse(w0, ball, (2.0, 0.0)), ball, 3.0))
    at("impulse at point", "write",
       forces.apply_impulse_at_point(w0, ball, (1.0, 0.0), (0.0, 10.5)))
    # The duplicate index accumulates, as .at[].add does.
    w = at("forces at point", "write", forces.set_constant_force(
        forces.apply_force_at_point(w0, np.asarray([ball, ball]), (1.0, 2.0), (0.3, 10.0)), ball,
        (0.5, 0.0)))
    steps("forces at point", w, 2)
    # At rest from the start: asleep after 0.5 s; then a constant push.
    w = steps("rest", w0, 32)
    w = at("push", "free", forces.set_constant_force(w, box, (200.0, 0.0)))
    steps("push", w, 30, kind="free")
    return out


def test_forces_and_a_constant_force_on_a_sleeper_match_reference():
    """``tests/test_dim2_api.py:34-88``'s four tests, each write and its steps
    in both packages, with their own checks; then the box rests until it
    sleeps and a constant 200 N along x is set on it for 30 steps: the
    reference keeps it asleep and it does not move (ROADMAP 3b); the port
    wakes it at the next step and it slides."""
    cfg = dict(substeps=4, max_colors=4)
    jcfg, tcfg = JConfig(**cfg), TConfig(**cfg)
    jw0, tw0 = _both(_forces_world)
    ball, box = 0, 2
    mass = 1.0 / float(jw0.bodies.inv_mass[ball])
    inertia = 1.0 / float(jw0.bodies.inv_inertia[ball])
    args = (ball, box, mass, inertia)

    def reference():
        return {what: _cols(w, WRITE_COLS)
                for what, _, w in _forces_run(jforces, j_step, jw0, jcfg, *args)}

    ref = RECORDING((jw0, repr(jcfg), args), reference)
    run = _forces_run(tforces, physics_step_2d, tw0, tcfg, *args)
    for what, kind, tw in run:
        want = ref[what]
        if kind == "write":
            for name in WRITE_COLS[:-1]:
                _close(getattr(tw.bodies, name), want[name], 1e-6, f"{what} {name}")
            np.testing.assert_array_equal(as_numpy(tw.bodies.sleeping), want.sleeping)
        elif kind == "step":
            for name, tol, rtol in (("pos", STEP_TOL, 0.0), ("angle", STEP_TOL, 0.0),
                                    ("lin_vel", VEL_TOL, VEL_RTOL),
                                    ("ang_vel", VEL_TOL, VEL_RTOL)):
                _close(getattr(tw.bodies, name), want[name], tol, f"{what} {name}", rtol)
    port = {what: tw.bodies for what, _, tw in run}

    assert float(port["force step 2"].lin_vel[ball, 0]) == pytest.approx(3.0 / 60.0, rel=1e-4)
    assert float(port["torque step 1"].ang_vel[ball]) == pytest.approx(2.0 / 60.0, rel=1e-4)
    w0 = float(port["constant torque"].ang_vel[ball])
    assert float(port["constant torque step 2"].ang_vel[ball]) == pytest.approx(
        w0 + 2.0 * 2.0 / 60.0, rel=1e-3)
    assert float(port["impulses"].lin_vel[ball, 0]) == pytest.approx(2.0 / mass, rel=1e-5)
    assert float(port["impulses"].ang_vel[ball]) == pytest.approx(3.0 / inertia, rel=1e-5)
    assert float(port["impulse at point"].ang_vel[ball]) < 0.0 < float(
        port["impulse at point"].lin_vel[ball, 0])

    assert bool(ref["rest step 32"].sleeping[box]) and bool(port["rest step 32"].sleeping[box])
    x0 = float(port["push"].pos[box, 0])
    assert float(ref["push step 30"].pos[box, 0]) - x0 == 0.0
    assert bool(ref["push step 30"].sleeping[box])
    assert float(port["push step 30"].pos[box, 0]) - x0 > 0.5
    assert not bool(port["push step 30"].sleeping[box])


def test_to_jax2d_round_trip_carries_the_joint_columns():
    """Every column the joint solver and the sweep read and write survives
    ``to_numpy``/``from_numpy`` both ways, after a step that set them."""
    jw, tw = _both(_joint_zoo)
    tw = physics_step_2d(tw, TConfig(**KW))
    back = to_jax2d(tw)
    for name in ("total_lambda", "color", "compliance", "collision_disabled", "limit_enabled",
                 "axis_angle", "reference_angle", "anchor_a", "anchor_b"):
        np.testing.assert_array_equal(np.asarray(getattr(back.joints, name)),
                                      as_numpy(getattr(tw.joints, name)), err_msg=name)
    for name in ("swept_ccd", "swept_ccd_nonlinear", "const_force", "const_torque"):
        np.testing.assert_array_equal(np.asarray(getattr(back.bodies, name)),
                                      as_numpy(getattr(tw.bodies, name)), err_msg=name)
    assert float(tw.joints.total_lambda.abs().max()) > 0.0
