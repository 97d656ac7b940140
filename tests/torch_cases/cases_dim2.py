"""The port's native 2D engine (``avian_tpu_torch.dim2``) against the JAX
reference (``avian_tpu.dim2``), on the CPU, where every kernel runs as its
plain PyTorch twin: `SceneBuilder2D` leaf for leaf, Kernel V on seeded random
pairs of every kind, and Kernels U, W, X, Y and Z on one step of a base-20
pyramid. The whole slice is in ``cases_dim2_step.py``.

Tolerances: the reference is compiled one IEEE operation at a time
(``port_common.ieee_reference``); what is left is PyTorch's CPU ``sqrt``,
``cos`` and ``sin``, which are not correctly rounded (a few ulp), and the
order of the solver's sums per body. Manifolds: 2e-5 m; contact rows: 1e-5;
packed rows: 1e-4 relative to each column's scale; one substep's state:
1e-5. Counts, feature ids, pairs, keys, flags and colours are exact.
"""

from port_common import ieee_reference

ieee_reference()

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from avian_tpu import PhysicsConfig as JConfig  # noqa: E402
from avian_tpu.core.types import BodyType, JointType  # noqa: E402
from avian_tpu.dim2 import SceneBuilder2D as JBuilder2D  # noqa: E402
from avian_tpu.dim2 import broadphase as jbp  # noqa: E402
from avian_tpu.dim2 import contacts as jnc  # noqa: E402
from avian_tpu.dim2 import dynamics as jdyn  # noqa: E402
from avian_tpu.dim2 import scenes as jscenes  # noqa: E402
from avian_tpu.dim2 import solver as jsol  # noqa: E402
from avian_tpu.dim2 import state as jstate  # noqa: E402
from avian_tpu.dim2.narrowphase import compute_manifold_2d  # noqa: E402
from avian_tpu_torch import PhysicsConfig as TConfig  # noqa: E402
from avian_tpu_torch.dim2 import SceneBuilder2D as TBuilder2D  # noqa: E402
from avian_tpu_torch.dim2 import World2D, physics_step_2d  # noqa: E402
from avian_tpu_torch.dim2 import broadphase as tbp  # noqa: E402
from avian_tpu_torch.dim2 import contacts as tnc  # noqa: E402
from avian_tpu_torch.dim2 import dynamics as tdyn  # noqa: E402
from avian_tpu_torch.dim2 import scenes as tscenes  # noqa: E402
from avian_tpu_torch.dim2 import solver as tsol  # noqa: E402
from avian_tpu_torch.kernels import manifold_2d as kv  # noqa: E402
from avian_tpu_torch.kernels import solve_2d as ky  # noqa: E402

import per_side_rows  # noqa: E402
from port_common import as_numpy  # noqa: E402
from random_pairs_2d import random_pairs  # noqa: E402

torch.set_num_threads(1)
KW = dict(substeps=4, max_colors=8)
JCFG, TCFG = JConfig(**KW), TConfig(**KW)


def to_torch2d(jax_world) -> World2D:
    return World2D.from_numpy(jax.tree.map(np.asarray, jax_world), device="cpu")


def to_jax2d(port_world: World2D):
    tn = port_world.to_numpy()
    groups = dict(bodies=jstate.Bodies2D, colliders=jstate.Colliders2D,
                  contacts=jstate.Contacts2D, joints=jstate.Joints2D)
    return jstate.World2D(
        **{g: cls(**{k: jnp.asarray(v) for k, v in tn[g].items()}) for g, cls in groups.items()},
        gravity=jnp.asarray(tn["gravity"]), time=jnp.asarray(tn["time"]),
        diverged=jnp.asarray(tn["diverged"]),
    )


def assert_worlds_equal(ref, port: World2D):
    ref_np = jax.tree.map(np.asarray, ref)
    port_np = port.to_numpy()
    for group in ("bodies", "colliders", "contacts", "joints"):
        ref_group = getattr(ref_np, group)
        names = [f.name for f in dataclasses.fields(ref_group)]
        assert sorted(port_np[group]) == sorted(names), group
        for name in names:
            r, p = getattr(ref_group, name), port_np[group][name]
            assert p.dtype == r.dtype and p.shape == r.shape, (group, name, p.dtype, r.dtype)
            np.testing.assert_array_equal(p, r, err_msg=f"{group}.{name}")
    for leaf in ("gravity", "time", "diverged"):
        r = getattr(ref_np, leaf)
        assert port_np[leaf].dtype == r.dtype and port_np[leaf].shape == r.shape
        np.testing.assert_array_equal(port_np[leaf], r)


def every_shape(builder):
    """One body of every 2D shape constructor, with materials, layers,
    overrides and a joint, on a ground half-space."""
    b = builder
    g = b.add_body(body_type=BodyType.STATIC)
    b.half_space(g, normal=(0.1, 1.0), friction=0.6, restitution=0.2)
    b.segment(g, (-9.0, 0.0), (-7.0, 0.5))
    b.polyline(g, [(7.0, 0.0), (8.0, 0.3), (9.0, 1.0)])
    shapes = [
        lambda body: b.circle(body, 0.5, density=2.0),
        lambda body: b.rectangle(body, 1.0, 0.6, friction=0.3, friction_combine=2),
        lambda body: b.box(body, 0.3, 0.2, local_pos=(0.1, 0.0), local_angle=0.3),
        lambda body: b.round_rectangle(body, 0.8, 0.6, 0.1),
        lambda body: b.capsule(body, 0.3, 0.8, restitution=0.5, restitution_combine=4),
        lambda body: b.capsule_endpoints(body, 0.2, (-0.3, 0.0), (0.4, 0.1)),
        lambda body: b.triangle(body, (-0.5, 0.0), (0.0, 0.8), (0.5, 0.0)),
        lambda body: b.regular_polygon(body, 0.5, 6),
        lambda body: b.convex_hull(body, [(-0.5, -0.4), (0.5, -0.4), (0.6, 0.2), (0.0, 0.5),
                                          (-0.6, 0.2), (0.0, 0.0)]),
        lambda body: b.convex_polyline(body, [(0.0, 0.0), (0.5, 0.0), (0.5, 0.5)]),
        lambda body: b.ellipse(body, 0.6, 0.4, layer_members=0b10, layer_filter=0xFFFF),
    ]
    ids = []
    for i, make in enumerate(shapes):
        body = b.add_body(pos=(-6.0 + 1.3 * i, 1.5 + 0.1 * i), angle=0.05 * i,
                          lin_vel=(0.0, -0.5), ang_vel=0.1 * (i % 3))
        make(body)
        ids.append(body)
    heavy = b.add_body(pos=(0.0, 4.0), mass=3.0, inertia=0.5, com=(0.1, 0.0),
                       lin_damping=0.1, ang_damping=0.2, max_lin_speed=20.0,
                       locked_axes=4, dominance=2, gravity_scale=0.5)
    b.box(heavy, 0.4, 0.4, is_sensor=False)
    kin = b.add_body(pos=(3.0, 3.0), body_type=BodyType.KINEMATIC, lin_vel=(0.2, 0.0))
    b.circle(kin, 0.3)
    b.add_joint(JointType.REVOLUTE, ids[0], ids[1], anchor_a=(0.5, 0.0), anchor_b=(-0.5, 0.0))
    return ids


def every_shape_worlds(joints=True):
    jb, tb = JBuilder2D(), TBuilder2D()
    every_shape(jb)
    every_shape(tb)
    if not joints:
        jb._joints.clear()
        tb._joints.clear()
    kw = dict(max_bodies=20, max_colliders=24, max_contacts=160)
    return jb.finalize(**kw), tb.finalize(**kw, device="cpu")


def test_builder_every_shape_equals_reference():
    jw, tw = every_shape_worlds()
    assert_worlds_equal(jw, tw)
    jw2, tw2 = JBuilder2D(), TBuilder2D()
    assert_worlds_equal(jw2.finalize(), tw2.finalize(device="cpu"))  # empty world


@pytest.mark.parametrize("which", ["box_pyramid_2d", "many_pyramids_2d"])
def test_scenes_equal_reference(which):
    if which == "box_pyramid_2d":
        jw, jids = jscenes.box_pyramid_2d(10)
        tw, tids = tscenes.box_pyramid_2d(10, device="cpu")
    else:
        jw, jids = jscenes.many_pyramids_2d(3, 4)
        tw, tids = tscenes.many_pyramids_2d(3, 4, device="cpu")
    assert jids == tids
    assert_worlds_equal(jw, tw)
    n = len(tids) + 1
    assert tscenes.box_pyramid_2d(10, max_contacts=24 * 56, device="cpu")[0].contacts.capacity \
        == 24 * 56 and tw.contacts.capacity == max(8 * n, 64)


def test_manifold_2d_matches_reference_on_random_pairs():
    """1,024 seeded pairs, every kind against every kind (8 x 8, 16 each),
    plus 1,024 drawn freely: rounded shapes, offset circles, degenerate
    segments, near-parallel faces."""
    kinds = np.stack(np.meshgrid(np.arange(8), np.arange(8), indexing="ij"), -1).reshape(-1, 2)
    kinds = np.repeat(kinds, 16, axis=0)
    for k, kind_arg, seed in ((kinds.shape[0], kinds, 1), (1024, None, 2)):
        ca, cb, t = random_pairs(k, seed, kinds=kind_arg, device="cpu")
        cs = torch.stack([torch.cos(t["angle"]), torch.sin(t["angle"])], -1)
        port = kv.manifold_2d(ca, cb, t["pos"], cs, t["verts"], t["count"], t["radius"],
                              t["plane"])
        a, b = ca.numpy(), cb.numpy()
        j = {key: jnp.asarray(as_numpy(val)) for key, val in t.items()}
        ref = jax.jit(jax.vmap(compute_manifold_2d))(
            j["pos"][a], j["angle"][a], j["verts"][a], j["count"][a], j["radius"][a],
            j["plane"][a], j["pos"][b], j["angle"][b], j["verts"][b], j["count"][b],
            j["radius"][b], j["plane"][b],
        )
        count = np.asarray(ref.count)
        np.testing.assert_array_equal(as_numpy(port.count), count, err_msg="count")
        lanes = np.arange(2)[None, :] < count[:, None]
        np.testing.assert_array_equal(np.where(lanes, as_numpy(port.feature_id), 0),
                                      np.where(lanes, np.asarray(ref.feature_id), 0))
        np.testing.assert_allclose(as_numpy(port.normal), np.asarray(ref.normal), atol=2e-5,
                                   rtol=0)
        for name in ("point_a", "point_b", "separation"):
            p, r = as_numpy(getattr(port, name)), np.asarray(getattr(ref, name))
            np.testing.assert_allclose(p[lanes], r[lanes], atol=2e-5, rtol=0, err_msg=name)
        assert (count == 0).sum() > 0 and (count == 1).sum() > 100 and (count == 2).sum() > 100


@pytest.fixture(scope="module")
def pyramid20():
    """The port's base-20 pyramid at 24 contact slots a box, stepped 3 times
    on the CPU, and the same world as a JAX world."""
    n = 20 * 21 // 2 + 1
    world, _ = tscenes.box_pyramid_2d(20, max_contacts=24 * n, device="cpu")
    for _ in range(3):
        world = physics_step_2d(world, TCFG)
    return world, to_jax2d(world)


def _close(port, ref, atol, what):
    np.testing.assert_allclose(as_numpy(port), np.asarray(ref), atol=atol, rtol=0, err_msg=what)


def test_grid_pairs_contact_rows_and_packed_rows_match_reference(pyramid20):
    """Kernels U, W and X (with V, F's join and G) on one step of the base-20
    pyramid."""
    tw, jw = pyramid20
    poses = tbp.collider_poses(tw)
    tw2 = tbp.update_aabbs(tw, TCFG, poses)
    jw2 = jax.jit(jbp.update_aabbs, static_argnums=1)(jw, JCFG)
    _close(tw2.colliders.aabb_min, jw2.colliders.aabb_min, 1e-5, "aabb_min")
    _close(tw2.colliders.aabb_max, jw2.colliders.aabb_max, 1e-5, "aabb_max")
    tw2 = to_torch2d(jw2)  # the pairs are held on the reference's AABBs

    bp = tbp.broad_phase(tw2, TCFG)
    jbp_out = jax.jit(jbp.broad_phase, static_argnums=1)(jw2, JCFG)
    for name in ("collider_a", "collider_b", "valid", "num_pairs", "dropped"):
        np.testing.assert_array_equal(as_numpy(getattr(bp, name)),
                                      np.asarray(getattr(jbp_out, name)), err_msg=name)
    np.testing.assert_array_equal(as_numpy(bp.pair_key), np.asarray(jbp_out.pair_key))
    assert int(bp.num_pairs) > 600 and int(bp.dropped) == 0

    contacts = tnc.narrow_phase(tw2, bp, TCFG, tbp.collider_poses(tw2))
    jc = jax.jit(jnc.narrow_phase, static_argnums=2)(jw2, jbp_out, JCFG)
    for f in dataclasses.fields(jc):
        r, p = np.asarray(getattr(jc, f.name)), as_numpy(getattr(contacts, f.name))
        if r.dtype.kind == "f":
            np.testing.assert_allclose(p, r, atol=1e-5, rtol=0, err_msg=f.name)
        else:
            np.testing.assert_array_equal(p, r.astype(p.dtype), err_msg=f.name)

    # Packed rows on the same contacts and solver bodies.
    jc = jax.tree.map(jnp.asarray, jc)
    s, _ = tdyn.prepare(tw2.bodies, tw2.gravity, TCFG.substep_dt)
    con = tsol.prepare_constraints(tw2, contacts, s, TCFG)
    jcon = jax.jit(jsol.prepare_constraints, static_argnums=3)(
        jw2, jc, jdyn.prepare(jw2.bodies), JCFG)
    for name in ("buckets", "bucket_valid", "bucket_a", "bucket_b", "color_c"):
        np.testing.assert_array_equal(as_numpy(getattr(con, name)),
                                      np.asarray(getattr(jcon, name)), err_msg=name)
    for name in ("overflow_dropped", "num_overflow"):
        assert int(getattr(con, name)) == int(getattr(jcon, name)), name
    valid = as_numpy(con.bucket_valid)
    scale = np.abs(np.asarray(jcon.data)[valid]).max(axis=0) + 1.0
    np.testing.assert_allclose(as_numpy(con.data)[valid] / scale,
                               np.asarray(jcon.data)[valid] / scale, atol=1e-4, rtol=0)
    _close(con.imp, jcon.imp, 1e-6, "imp")
    _close(con.relax, jcon.relax, 0.0, "relax")
    assert int(con.bucket_valid[-1].sum()) > 0  # the overflow colour is in use


def test_one_substep_matches_reference(pyramid20):
    """Kernels Z and Y: integrate, warm start, biased solve, integrate
    positions, relaxed solve and restitution on the same packed rows."""
    tw, jw = pyramid20
    jw2 = jax.jit(jbp.update_aabbs, static_argnums=1)(jw, JCFG)
    tw2 = to_torch2d(jw2)
    bp = tbp.broad_phase(tw2, TCFG)
    contacts = tnc.narrow_phase(tw2, bp, TCFG, tbp.collider_poses(tw2))
    jc = to_jax2d(tw2.replace(contacts=contacts)).contacts
    h = TCFG.substep_dt

    s, table = tdyn.prepare(tw2.bodies, tw2.gravity, h)
    con = tsol.prepare_constraints(tw2, contacts, s, TCFG)

    def reference(w, c):
        js = jdyn.prepare(w.bodies)
        inc = jdyn.pre_process_velocity_increments(w.bodies, w.gravity, h)
        jcon = jsol.prepare_constraints(w, c, js, JCFG)
        js = jdyn.clamp_velocities(jdyn.integrate_velocities(js, inc, w.bodies), w.bodies)
        out = [js]
        js = jsol.warm_start(js, jcon, JCFG)
        js, jcon = jsol.solve_pass(js, jcon, h, True, JCFG)
        js = jdyn.integrate_positions(js, h)
        js, jcon = jsol.solve_pass(js, jcon, h, False, JCFG)
        js, jcon = jsol.solve_restitution(js, jcon, JCFG)
        return out + [js, jcon.imp]

    ref = jax.jit(reference)(jw2, jc)
    s = tdyn.integrate_velocities(s, table, h)
    _close(s.lin_vel, ref[0].lin_vel, 0.0, "integrated lin_vel")
    _close(s.ang_vel, ref[0].ang_vel, 0.0, "integrated ang_vel")
    s = tsol.warm_start(s, con, TCFG)
    s, con = tsol.solve_pass(s, con, True, TCFG)
    s = tdyn.integrate_positions(s, table, h)
    s, con = tsol.solve_pass(s, con, False, TCFG)
    s, con = tsol.solve_restitution(s, con, TCFG)
    for name in ("lin_vel", "ang_vel", "delta_pos", "delta_angle"):
        _close(getattr(s, name), getattr(ref[1], name), 1e-5, name)
    _close(con.imp, ref[2], 1e-5, "imp")


def test_prepare_writeback_and_sleep_update_match_reference(pyramid20):
    """Kernel Z's prologue, K's 2D writeback and J's 2D sleep update against
    the reference's ``prepare``, ``pre_process_velocity_increments``,
    ``writeback`` and ``_update_sleeping``, on the base-20 pyramid with
    seeded forces, torques, axis locks, sleepers, kinematic bodies and
    moved poses. Prologue exact; writeback 1e-6 (``cos``/``sin``); sleep
    flags, islands and zeroed velocities exact, timers exact."""
    from avian_tpu.dim2 import step as jstep
    from avian_tpu_torch.dim2.step import update_sleeping

    tw, _ = pyramid20
    rng = np.random.default_rng(11)
    b = tw.bodies
    n = b.capacity
    f = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32))  # noqa: E731
    kinematic = torch.from_numpy(rng.random(n) < 0.1) & (b.body_type != BodyType.STATIC)
    b = b.replace(
        force=f(n, 2), torque=f(n), const_force=f(n, 2), const_torque=f(n),
        locked_axes=torch.from_numpy(rng.integers(0, 8, n).astype(np.int32)),
        sleeping=b.sleeping | torch.from_numpy(rng.random(n) < 0.2),
        body_type=torch.where(kinematic, int(BodyType.KINEMATIC), b.body_type),
        lin_damping=torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32)),
        sleep_timer=torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32)),
    )
    tw = tw.replace(bodies=b)
    jw = to_jax2d(tw)
    h = TCFG.substep_dt

    s, table = tdyn.prepare(b, tw.gravity, h)
    js = jdyn.prepare(jw.bodies)
    inc = jdyn.pre_process_velocity_increments(jw.bodies, jw.gravity, h)
    for name in ("lin_vel", "ang_vel", "delta_pos", "delta_angle", "inv_mass", "inv_inertia",
                 "solve_mask"):
        _close(getattr(s, name), getattr(js, name), 0.0, name)
    _close(table[:, 0:2], inc.lin_inc, 0.0, "lin_inc")
    _close(table[:, 2], inc.ang_inc, 0.0, "ang_inc")
    _close(table[:, 3], inc.lin_damping_rhs, 0.0, "lin_damping_rhs")
    _close(table[:, 4], inc.ang_damping_rhs, 0.0, "ang_damping_rhs")

    moved = s.replace(state=s.state + torch.from_numpy(
        rng.uniform(-0.05, 0.05, (n, 6)).astype(np.float32)))
    jmoved = js.replace(lin_vel=jnp.asarray(as_numpy(moved.lin_vel)),
                        ang_vel=jnp.asarray(as_numpy(moved.ang_vel)),
                        delta_pos=jnp.asarray(as_numpy(moved.delta_pos)),
                        delta_angle=jnp.asarray(as_numpy(moved.delta_angle)))
    wb = tdyn.writeback(b, moved)
    jwb = jax.jit(jdyn.writeback)(jw.bodies, jmoved)
    for name in ("pos", "angle", "lin_vel", "ang_vel"):
        _close(getattr(wb, name), getattr(jwb, name), 1e-6, name)
    assert not bool(wb.force.any()) and not bool(wb.torque.any())

    # Slow bodies, so that some islands fall asleep and others stay awake.
    tb = wb.replace(lin_vel=wb.lin_vel * 1e-3, ang_vel=wb.ang_vel * 1e-3)
    jb = to_jax2d(tw.replace(bodies=tb)).bodies
    for time_to_sleep in (0.5, 0.0):
        kw = dict(KW, time_to_sleep=time_to_sleep)
        got = update_sleeping(tb, tw.contacts, tw.joints, TConfig(**kw))
        want = jax.jit(jstep._update_sleeping, static_argnums=3)(jb, jw.contacts, jw.joints,
                                                                 JConfig(**kw))
        for name in ("sleeping", "sleep_timer", "island", "lin_vel", "ang_vel"):
            _close(getattr(got, name), getattr(want, name), 0.0, name)
        asleep = int(got.sleeping.sum())
        assert asleep == 0 if time_to_sleep else 0 < asleep < n  # wakes, then sleeps


def test_row_update_equals_its_per_side_spelling():
    """Kernel Y's plain row update, both ends as one [2, R] tensor, equals
    the same update written one end at a time (``per_side_rows.py``) bit for
    bit, on 800 seeded rows in every mode."""
    g = torch.Generator().manual_seed(1)
    for trial in range(4):
        d, irows, sa, sb, rlx = per_side_rows.random_rows("Y", 200, g)
        p = ky.SolveParams2D(h=1 / 240, max_overlap_speed=4.0, stiction_t2=0.5 * trial,
                             warm_coefficient=1.0, restitution_threshold=0.5)
        for mode in (ky.WARM, ky.BIAS, ky.RELAX, ky.RESTITUTION):
            d_va, d_wa, d_vb, d_wb, want = per_side_rows._row_update_2d(
                mode, d, irows, sa, sb, rlx, p)
            delta, new = ky._row_update(mode, d, irows, sa, sb, rlx, p)
            per_side_rows.assert_same_bits(
                delta, torch.stack([torch.cat([d_va, d_wa[:, None]], -1),
                                    torch.cat([d_vb, d_wb[:, None]], -1)]),
                (trial, mode, "deltas"))
            per_side_rows.assert_same_bits(new, want, (trial, mode, "impulses"))
