"""The hinged-box path and the joint solver against the JAX reference:
``falling_hinges`` leaf for leaf, ``prepare_joints`` (integers exact, floats
1e-6), one call of ``solve_position_constraints`` on a world with all five
joint types, limits, twist, compliance and damping and joints sharing bodies
in the overflow color (1e-5), the broadphase with joint-disabled pairs
(exact), island labels on a scrambled 64-box hinged chain that 10 rounds do
not cover (exact), one full step of a settled 10 x 4 hinged scene (1e-4), and
the port's 10 x 4 run against ``tests/golden/falling_hinges.npz`` (1e-3 m)
over the frames before the two part.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_cases/cases_joints.py STEPS

prints, for each of the first STEPS steps of the golden scene, how far the
port and the reference started 1 ulp off are from the golden (which the
reference reproduces to the bit), and how far one port step from the
reference's state lands from the reference's next state: the parting is the
reference's own sensitivity to a last-bit difference, not a difference of
the dynamics.

The settled hinged scene's reference steps are read from
``joints_reference.npz`` (``port_common.Recording``, keyed by a digest of
its inputs; rerecord with ``record_references.py cases_joints.py``).
"""

import dataclasses
import os
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avian_tpu import scenes as jscenes
from avian_tpu.core.builder import SceneBuilder as JBuilder
from avian_tpu.core.config import PhysicsConfig as JConfig
from avian_tpu.core.types import BodyType, JointType
from avian_tpu.pipeline import broadphase as jbp
from avian_tpu.pipeline import sleeping as jsleep
from avian_tpu.pipeline import solver_body as jsb
from avian_tpu.pipeline import xpbd as jxpbd
from avian_tpu.pipeline.step import physics_step as j_step
from avian_tpu_torch import physics_step, scenes
from avian_tpu_torch.core.builder import SceneBuilder as TBuilder
from avian_tpu_torch.core.config import PhysicsConfig as TConfig
from avian_tpu_torch.pipeline import broadphase as tbp
from avian_tpu_torch.pipeline import sleeping as tsleep
from avian_tpu_torch.pipeline import solver_body as tsb
from avian_tpu_torch.pipeline import xpbd as txpbd

from port_common import (PAIRS, Recording, as_numpy, assert_columns, assert_worlds_equal,
                         to_torch)

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "golden", "falling_hinges.npz")
GOLDEN_DT, GOLDEN_COLORS, GOLDEN_STRIDE, GOLDEN_TOL = 1.0 / 64.0, 8, 10, 1e-3
# The port's run and the golden part in the frame after this step (ROADMAP
# 3a): the boxes land at step 37, and the impacts amplify last-bit
# differences about twofold a step, as they amplify a 1-ulp nudge of the
# reference's own start.
GOLDEN_HELD_STEPS = 40
PREPARE_TOL, SOLVE_TOL, STEP_TOL = 1e-6, 1e-5, 1e-4
SOLVE_COLORS = 3  # two proper colors and the overflow color


def _golden_configs():
    return (JConfig(dt=GOLDEN_DT, max_colors=GOLDEN_COLORS),
            TConfig(dt=GOLDEN_DT, max_colors=GOLDEN_COLORS))


_J_STEP = jax.jit(partial(j_step, return_diagnostics=True), static_argnums=1)
RECORDING = Recording("joints")


def test_falling_hinges_matches_reference_leaf_for_leaf():
    ref, ref_ids = jscenes.falling_hinges(10, 4)
    port, ids = scenes.falling_hinges(10, 4, device="cpu")
    assert_worlds_equal(ref, port)
    assert ids == ref_ids and port.joints.capacity == 30
    assert bool(port.joints.collision_disabled.all())
    wide, _ = scenes.falling_hinges(10, 4, max_contacts=999, device="cpu")
    assert wide.contacts.capacity == 999 and torch.equal(wide.bodies.pos, port.bodies.pos)
    assert_worlds_equal(ref, scenes.hinge_blocks(1, 10, 4, device="cpu")[0])


def test_hinge_blocks_are_falling_hinges_side_by_side():
    """The full-width scene: copies of the reference's scene, a box width
    apart, built here with the reference's builder."""
    b = JBuilder()
    g = b.add_body(body_type=BodyType.STATIC)
    b.half_space(g, normal=(0, 1, 0))
    half, size = 0.25, 0.5
    pitch = 4 * size * 1.05 + size
    for k in range(3):
        for r in range(5):
            prev = None
            for c in range(4):
                body = b.add_body_2d(pos=((k - 1) * pitch + c * size * 1.05 - 2 * size,
                                          2.0 + r * size * 1.2))
                b.box(body, half, half, half, friction=0.6)
                if prev is not None:
                    b.add_joint(JointType.REVOLUTE, prev, body, anchor_a=(half, half, 0.0),
                                anchor_b=(-half, half, 0.0))
                prev = body
    ref = b.finalize(max_bodies=61, max_colliders=61, max_contacts=488, max_joints=45)
    port, ids = scenes.hinge_blocks(3, 5, 4, device="cpu")
    assert_worlds_equal(ref, port)
    assert ids == list(range(1, 61))


def _five_types(builder, **finalize_kw):
    """A hub box with joints of the five types (limits, twist, compliance,
    damping), a hinge to the static ground and a spherical joint between two
    spokes; ``revolute_joint`` builds one of the hinges."""
    g = builder.add_body(body_type=BodyType.STATIC)
    builder.half_space(g, normal=(0, 1, 0))
    hub = builder.add_body(pos=(0.0, 3.0, 0.0))
    builder.box(hub, 0.3, 0.3, 0.3)
    s = []
    for k in range(6):
        a = 2.0 * np.pi * k / 6
        body = builder.add_body(pos=(1.2 * np.cos(a), 3.0 + 0.2 * k, 1.2 * np.sin(a)))
        builder.box(body, 0.2, 0.25, 0.15)
        s.append(body)
    builder.add_joint(JointType.FIXED, hub, s[0], anchor_a=(0.6, 0, 0), anchor_b=(-0.3, 0, 0),
                      compliance=(1e-4, 1e-5, 0, 0), ang_damping=2.0, lin_damping=1.0)
    builder.add_joint(JointType.DISTANCE, hub, s[1], anchor_a=(0.2, 0.1, 0.3),
                      limit_min=0.5, limit_max=0.8, lin_damping=0.5)
    builder.add_joint(JointType.REVOLUTE, hub, s[2], anchor_a=(-0.4, 0.2, 0.5),
                      anchor_b=(0.1, -0.1, 0), basis_a=(0.0, 0.2, 0.0, 1.0),
                      limit_min=-0.3, limit_max=0.25, limit_enabled=True)
    builder.add_joint(JointType.PRISMATIC, hub, s[3], anchor_a=(-0.6, 0, 0),
                      basis_a=(0.3, 0.0, 0.1, 1.0), basis_b=(0.3, 0.0, 0.1, 1.0),
                      limit_min=-0.1, limit_max=0.1, limit_enabled=True)
    builder.add_joint(JointType.SPHERICAL, hub, s[4], anchor_a=(0.0, -0.5, -0.6),
                      limit_min=-0.4, limit_max=0.4, limit_enabled=True,
                      twist_min=-0.2, twist_max=0.2, twist_enabled=True,
                      compliance=(0.0, 1e-5, 1e-5, 1e-5), ang_damping=1.0)
    builder.revolute_joint(g, s[5], axis=(1.0, 0.0, 0.0), anchor_a=(0.0, 2.0, 1.5),
                           collision_disabled=False)
    builder.add_joint(JointType.SPHERICAL, s[4], s[5], anchor_a=(0.1, 0.2, 0.0),
                      limit_min=-0.1, limit_max=0.1, limit_enabled=True,
                      twist_min=-0.05, twist_max=0.05, twist_enabled=True)
    return builder.finalize(max_contacts=64, **finalize_kw)


def _jumbled_five_types(seed=3):
    """The five-type world in both packages, its bodies turned and moved
    from a seed so that alignments and limits are violated."""
    ref = _five_types(JBuilder())
    assert_worlds_equal(ref, _five_types(TBuilder(), device="cpu"))
    rng = np.random.default_rng(seed)
    n = ref.bodies.capacity
    q = np.asarray(ref.bodies.quat).copy()
    turn = rng.normal(size=(n, 4)).astype(np.float32) * np.float32(0.4)
    turn[:, 3] = 1.0
    q[1:] = (turn / np.linalg.norm(turn, axis=1, keepdims=True))[1:]
    pos = np.asarray(ref.bodies.pos).copy()
    pos[1:] += rng.uniform(-0.2, 0.2, size=(n - 1, 3)).astype(np.float32)
    ref = ref.replace(bodies=ref.bodies.replace(pos=jnp.asarray(pos), quat=jnp.asarray(q)))
    return ref, to_torch(ref), rng


@partial(jax.jit, static_argnums=1)
def _ref_prepare(world, config):
    s = jsb.prepare(world.bodies)
    return s, jxpbd.prepare_joints(world, s, config)


def _assert_scaled(ref, port, tol):
    """Every column of ``ref``: integers exactly, floats within ``tol`` times
    the column's largest magnitude (at least 1): the inverse inertias here
    are near 77, where one unit in the last place is 7.6e-6."""
    for f in dataclasses.fields(ref):
        r = np.asarray(getattr(ref, f.name))
        if np.issubdtype(r.dtype, np.floating):
            np.testing.assert_allclose(as_numpy(getattr(port, f.name)), r, rtol=0,
                                       atol=tol * max(1.0, float(np.abs(r).max(initial=0.0))),
                                       err_msg=f.name)
        else:
            assert_columns(ref, port, only=[f.name])


def test_prepare_joints_matches_reference():
    jw, tw, _ = _jumbled_five_types()
    jcfg, tcfg = JConfig(max_colors=SOLVE_COLORS), TConfig(max_colors=SOLVE_COLORS)
    _, ref = _ref_prepare(jw, jcfg)
    port = txpbd.prepare_joints(tw, tsb.prepare(tw.bodies), tcfg)
    _assert_scaled(ref, port, PREPARE_TOL)
    color = as_numpy(port.color)
    assert (color == SOLVE_COLORS - 1).sum() >= 2  # the hub's joints overflow


def _random_state(js, rng):
    """The reference's solver state with seeded velocities and delta poses."""
    n = js.lin_vel.shape[0]
    dq = rng.normal(size=(n, 4)).astype(np.float32) * np.float32(0.1)
    dq[:, 3] = 1.0
    moving = np.asarray(js.solve_mask)[:, None] > 0
    return js.replace(
        lin_vel=jnp.asarray(np.where(moving, rng.uniform(-2, 2, (n, 3)), 0).astype(np.float32)),
        ang_vel=jnp.asarray(np.where(moving, rng.uniform(-3, 3, (n, 3)), 0).astype(np.float32)),
        delta_pos=jnp.asarray(np.where(moving, rng.uniform(-0.05, 0.05, (n, 3)), 0)
                              .astype(np.float32)),
        delta_quat=jnp.asarray(np.where(moving, dq / np.linalg.norm(dq, axis=1, keepdims=True),
                                        np.asarray([0, 0, 0, 1], np.float32))),
    )


@partial(jax.jit, static_argnums=(3, 4))
def _ref_solve(s, jc, bodies, h, config):
    s, jc, _ = jxpbd.solve_position_constraints(s, jc, bodies, h, config)
    return s, jc


def test_solve_position_constraints_all_types_match_reference():
    """One substep of the joint solve: every color (two of them sharing the
    hub in the overflow color, which the reference sums before one
    rotation), the velocity projection and joint damping."""
    jw, tw, rng = _jumbled_five_types()
    jcfg, tcfg = JConfig(max_colors=SOLVE_COLORS), TConfig(max_colors=SOLVE_COLORS)
    js, jc = _ref_prepare(jw, jcfg)
    js = _random_state(js, rng)
    ts = tsb.prepare(tw.bodies)
    ts = ts.replace(state=torch.from_numpy(np.concatenate(
        [np.asarray(js.lin_vel), np.asarray(js.ang_vel), np.asarray(js.delta_pos),
         np.asarray(js.delta_quat)], 1)))
    tc = txpbd.prepare_joints(tw, ts, tcfg)
    h = jcfg.substep_dt
    js2, jc2 = _ref_solve(js, jc, jw.bodies, h, jcfg)
    ts2 = txpbd.solve_position_constraints(ts, tc, h, tcfg)
    # Velocities are delta poses over h = 1/360 s (up to 120 m/s here), so
    # every column is held to SOLVE_TOL times its largest magnitude.
    for name in ("lin_vel", "ang_vel", "delta_pos", "delta_quat"):
        r = np.asarray(getattr(js2, name))
        np.testing.assert_allclose(as_numpy(getattr(ts2, name)), r, rtol=0,
                                   atol=SOLVE_TOL * max(1.0, float(np.abs(r).max())), err_msg=name)
        assert not np.array_equal(r, np.asarray(getattr(js, name)))
    _assert_scaled(jc2, tc, SOLVE_TOL)
    for name in ("total_pos_lagrange", "total_rot_lagrange"):
        assert float(np.abs(np.asarray(getattr(jc2, name))).max()) > 1e-3
    forces = txpbd.store_joint_forces(tw.joints, tc, tcfg)
    np.testing.assert_array_equal(as_numpy(forces.color), np.asarray(jc.color_j))


def _jointed_row(builder, n=12, **finalize_kw):
    """Overlapping boxes in two rows, each joined to its neighbour in the row;
    every third joint lets its pair collide."""
    g = builder.add_body(body_type=BodyType.STATIC)
    builder.half_space(g, normal=(0, 1, 0))
    prev = [None, None]
    for k in range(2 * n):
        row = k % 2
        body = builder.add_body(pos=(0.8 * (k // 2), 0.5 + 0.9 * row, 0.1 * row))
        builder.box(body, 0.5, 0.5, 0.5)
        if prev[row] is not None:
            builder.add_joint(JointType.SPHERICAL, prev[row], body, anchor_a=(0.4, 0, 0),
                              anchor_b=(-0.4, 0, 0), collision_disabled=(k // 2) % 3 != 0)
        prev[row] = body
    return builder.finalize(**finalize_kw)


@partial(jax.jit, static_argnums=1)
def _ref_broad_phase(world, config):
    return jbp.broad_phase(jbp.update_aabbs(world, config), config)


@pytest.mark.parametrize("capacity", [None, 24], ids=["roomy", "capacity24"])
def test_broad_phase_disables_jointed_pairs_as_the_reference(capacity):
    kw = {} if capacity is None else dict(max_contacts=capacity)
    jw = _jointed_row(JBuilder(), **kw)
    tw = _jointed_row(TBuilder(), device="cpu", **kw)
    assert_worlds_equal(jw, tw)
    jcfg, tcfg = JConfig(shape_pairs=PAIRS), TConfig(shape_pairs=PAIRS)
    ref = _ref_broad_phase(jw, jcfg)
    port = tbp.broad_phase(tbp.update_aabbs(tw, tcfg), tcfg)
    assert_columns(ref, port)
    # With the joints switched off there are more pairs: the probe acted.
    free = tw.replace(joints=tw.joints.replace(active=torch.zeros_like(tw.joints.active)))
    unjointed = tbp.broad_phase(tbp.update_aabbs(free, tcfg), tcfg)
    if capacity is None:
        assert int(unjointed.num_pairs) > int(ref.num_pairs) > 0
    else:
        assert int(ref.dropped) > 0


def _scrambled_chain(builder, n=64, seed=5, **finalize_kw):
    """``n`` boxes hinged into one chain in a seeded order of their indices,
    and a hub with 30 spokes, more than the island table's 24 slots."""
    g = builder.add_body(body_type=BodyType.STATIC)
    builder.half_space(g, normal=(0, 1, 0))
    ids = []
    for k in range(n + 31):
        body = builder.add_body(pos=(1.5 * k, 2.0, 0.0))
        builder.box(body, 0.25, 0.25, 0.25)
        ids.append(body)
    order = np.random.default_rng(seed).permutation(n)
    for a, b in zip(order[:-1], order[1:]):
        builder.revolute_joint(ids[a], ids[b], anchor_a=(0.75, 0, 0), anchor_b=(-0.75, 0, 0))
    hub = ids[n]
    for spoke in ids[n + 1:]:
        builder.add_joint(JointType.FIXED, hub, spoke)
    return builder.finalize(**finalize_kw)


def test_islands_on_a_chain_ten_rounds_do_not_cover_match_reference():
    jw = _scrambled_chain(JBuilder())
    tw = _scrambled_chain(TBuilder(), device="cpu")
    assert_worlds_equal(jw, tw)
    label, overflow = jax.jit(jsleep.compute_islands)(jw.bodies, jw.contacts, jw.joints)
    t_label, t_overflow = tsleep.compute_islands(tw.bodies, tw.contacts, tw.joints)
    np.testing.assert_array_equal(as_numpy(t_label), np.asarray(label))
    chain = np.asarray(label)[1:65]
    assert len(set(chain.tolist())) > 1          # not converged after 10 rounds
    # The hub's 30 incidences overflow its 24 slots. The port flags it; the
    # reference's unsorted mask misses the flag (ROADMAP 3b).
    want = np.zeros(jw.bodies.capacity, bool)
    want[65] = True
    np.testing.assert_array_equal(as_numpy(t_overflow), want)
    assert not np.asarray(overflow)[~want].any()


def test_one_step_of_a_settled_hinged_scene_matches_reference():
    """At 2 colors and 2 substeps, which compile faster than the golden's
    8 and 6, and put every other hinge of a row and most contacts in the
    overflow color."""
    jcfg = JConfig(dt=GOLDEN_DT, max_colors=2, substeps=2, shape_pairs=PAIRS)
    tcfg = TConfig(dt=GOLDEN_DT, max_colors=2, substeps=2, shape_pairs=PAIRS)
    start, _ = jscenes.falling_hinges(10, 4)

    def reference():
        w = start
        for _ in range(45):  # landed: contacts warm, joints colored
            w, d = _J_STEP(w, jcfg)
        w2, d2 = _J_STEP(w, jcfg)
        return {"landed": jax.tree.leaves(w), "landed_diag": dict(d), "next": {
            "bodies": {n: getattr(w2.bodies, n) for n in (
                "pos", "quat", "lin_vel", "ang_vel", "sleep_timer", "sleeping", "island")},
            "contacts": {n: getattr(w2.contacts, n) for n in (
                "pair_key", "collider_a", "collider_b", "touching", "color")},
            "joints": {n: getattr(w2.joints, n) for n in ("color", "total_lambda")}},
            "diag": dict(d2)}

    ref = RECORDING((start, repr(jcfg)), reference)
    jw = jax.tree.unflatten(jax.tree.structure(start), [jnp.asarray(x) for x in ref.landed])
    jd = ref.landed_diag
    assert int(jd["num_touching"]) > 30 and int(jd["num_overflow"]) > 0
    jw2, jd = ref.next, ref.diag
    pw, pd = physics_step(to_torch(jw), tcfg, return_diagnostics=True)
    assert (as_numpy(pw.joints.color) == 1).sum() >= 10
    # Angular velocities are delta rotations over h = 1/128 s: one unit in
    # the last place of a delta rotation is 1.5e-5 rad/s, so they are held
    # to STEP_TOL times the largest angular speed.
    for name in ("pos", "quat", "lin_vel", "ang_vel", "sleep_timer"):
        r = np.asarray(getattr(jw2.bodies, name))
        scale = max(1.0, float(np.abs(r).max())) if name == "ang_vel" else 1.0
        np.testing.assert_allclose(as_numpy(getattr(pw.bodies, name)), r,
                                   atol=STEP_TOL * scale, rtol=0, err_msg=name)
    for name in ("sleeping", "island"):
        np.testing.assert_array_equal(as_numpy(getattr(pw.bodies, name)),
                                      np.asarray(getattr(jw2.bodies, name)), err_msg=name)
    for name in ("pair_key", "collider_a", "collider_b", "touching", "color"):
        p = as_numpy(getattr(pw.contacts, name))
        np.testing.assert_array_equal(p, np.asarray(getattr(jw2.contacts, name)).astype(p.dtype),
                                      err_msg=name)
    np.testing.assert_array_equal(as_numpy(pw.joints.color), np.asarray(jw2.joints.color))
    lam = np.asarray(jw2.joints.total_lambda)
    np.testing.assert_allclose(as_numpy(pw.joints.total_lambda), lam,
                               atol=STEP_TOL * float(np.abs(lam).max()), rtol=0)
    for key in ("num_pairs", "dropped_pairs", "overflow_dropped", "num_touching",
                "num_overflow"):
        assert int(pd[key]) == int(jd[key]), key


def test_golden_trajectory_until_the_runs_part():
    """The port's 10 x 4 hinged run, frame by frame against the golden the
    reference reproduces to the bit, over the frames before they part."""
    golden = np.load(GOLDEN)["pos"]
    _, tcfg = _golden_configs()
    world, _ = scenes.falling_hinges(10, 4, device="cpu")
    worst = 0.0
    for step in range(1, GOLDEN_HELD_STEPS + 1):
        world = physics_step(world, tcfg)
        if step % GOLDEN_STRIDE == 0:
            drift = float(np.abs(world.bodies.pos.numpy() - golden[step // GOLDEN_STRIDE - 1]).max())
            assert drift <= GOLDEN_TOL, (step, drift)
            worst = max(worst, drift)
    assert bool(torch.isfinite(world.bodies.pos).all())
    assert float(world.bodies.pos[1:, 1].min()) < 0.5   # the boxes have landed


def parting(steps):
    """Per step: (port's drift from the golden, the 1-ulp-nudged reference's
    drift from the golden, one port step from the reference's state against
    the reference's next state); drifts at the golden's frames only."""
    golden = np.load(GOLDEN)["pos"]
    jcfg, tcfg = _golden_configs()
    jw, _ = jscenes.falling_hinges(10, 4)
    pos = np.asarray(jw.bodies.pos).copy()
    pos[1, 0] = np.nextafter(pos[1, 0], np.float32(1.0))
    nudged = jw.replace(bodies=jw.bodies.replace(pos=jnp.asarray(pos)))
    tw = to_torch(jw)
    rows = []
    for step in range(1, steps + 1):
        jw2, _ = _J_STEP(jw, jcfg)
        nudged, _ = _J_STEP(nudged, jcfg)
        one = physics_step(to_torch(jw), tcfg)
        tw = physics_step(tw, tcfg)
        ref = np.asarray(jw2.bodies.pos)
        frame = step % GOLDEN_STRIDE == 0
        g = golden[step // GOLDEN_STRIDE - 1] if frame else ref
        rows.append((step, float(np.abs(tw.bodies.pos.numpy() - g).max()),
                     float(np.abs(np.asarray(nudged.bodies.pos) - g).max()),
                     float(np.abs(one.bodies.pos.numpy() - ref).max()), frame))
        jw = jw2
    return rows


if __name__ == "__main__":
    torch.set_num_threads(1)
    for step, port, nudge, one, frame in parting(int(sys.argv[1])):
        print(step, ("golden frame: " if frame else "against the reference: ")
              + "port %.3g, reference nudged 1 ulp %.3g; one port step from the reference's "
              "state %.3g" % (port, nudge, one))
