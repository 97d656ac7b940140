"""The time-of-impact path of the step against the JAX reference:
``quat.to_scaled_axis``; ``solve_swept_ccd`` on one solver state (the
delta pose of one step at each body's velocities) in four worlds, the
scaled delta positions within ``CCD_TOL`` and the swept colliders exactly;
whole steps with ``swept_ccd`` of ``tests/test_scenes.py``'s two swept
worlds, ``examples/ccd.py``'s scene in both modes and ``ccd_stress(32, 80)``
within ``STEP_TOL``, each with its source's check; and a constant force
written to a sleeping body, which the port wakes. The swept-CCD terrain is
``cases_ccd_terrain.py``'s.

On the CPU the port's swept CCD runs Kernel R's plain version. The
reference is compiled one IEEE operation at a time
(``port_common.ieee_reference``), with the shape pairs each world needs. Its
sweeps and steps are read from ``ccd_reference.npz`` (``port_common.
Recording``, keyed by a digest of the reference's inputs; rerecord with
``record_references.py cases_ccd.py cases_ccd_terrain.py``); the sweeps of
the two repaired faults run it live."""

from port_common import ieee_reference

ieee_reference()


import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from avian_tpu import BodyType, SceneBuilder as JBuilder  # noqa: E402
from avian_tpu import scenes as jscenes  # noqa: E402
from avian_tpu.core.config import PhysicsConfig as JConfig  # noqa: E402
from avian_tpu.math import quat as jquat  # noqa: E402
from avian_tpu.pipeline import broadphase as jbp  # noqa: E402
from avian_tpu.pipeline import ccd as jccd  # noqa: E402
from avian_tpu.pipeline import solver_body as jsb  # noqa: E402
from avian_tpu.pipeline.step import physics_step as j_step  # noqa: E402
from avian_tpu_torch import physics_step, scenes  # noqa: E402
from avian_tpu_torch.core.config import PhysicsConfig as TConfig  # noqa: E402
from avian_tpu_torch.math import quat as tquat  # noqa: E402
from avian_tpu_torch.pipeline import broadphase as tbp  # noqa: E402
from avian_tpu_torch.pipeline import ccd as tccd  # noqa: E402
from avian_tpu_torch.pipeline import solver_body as tsb  # noqa: E402
from avian_tpu_torch.pipeline.step import physics_step as t_step  # noqa: E402

from port_common import Recording, as_numpy, quats, to_torch  # noqa: E402

# Scaled delta positions: the linear sweeps agree to the bit; the nonlinear
# ones round the rotation's sin/cos and atan2 in each package's own way.
CCD_TOL = 1e-6
STEP_TOL = 1e-4
# tests/conftest.py's TEST_SHAPE_PAIRS: what the small worlds produce.
SMALL_PAIRS = ((0, 0), (0, 1), (0, 2), (0, 3), (1, 1), (1, 3), (2, 2), (2, 3))
_J_CCD = jax.jit(jccd.solve_swept_ccd, static_argnums=2)
_J_AABBS = jax.jit(jbp.update_aabbs, static_argnums=1)
_J_STEP = jax.jit(j_step, static_argnums=1)
RECORDING = Recording("ccd")


def test_to_scaled_axis_matches_reference():
    rng = np.random.default_rng(0)
    q = quats(rng, 256, scale=1.5)
    q[:8] = [0, 0, 0, 1]                       # identity
    q[8:16, :3] *= 1e-7                        # tiny angles (Taylor branch)
    q[16:24] *= -1.0                           # the long arc
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    want = np.asarray(jax.jit(jquat.to_scaled_axis)(jnp.asarray(q)))
    got = as_numpy(tquat.to_scaled_axis(torch.from_numpy(q)))
    # atan2 rounds differently in the two packages on some inputs.
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[:16], want[:16])


# ---- worlds -------------------------------------------------------------------

def _wall_bullet():
    """tests/test_scenes.py::test_swept_ccd_rewinds_fast_body's world."""
    b = JBuilder()
    wall = b.add_body(body_type=BodyType.STATIC, pos=(5.0, 0.0, 0.0))
    b.box(wall, 0.05, 10.0, 10.0)
    bullet = b.add_body(pos=(0.0, 0.0, 0.0), lin_vel=(300.0, 0.0, 0.0), swept_ccd=True,
                        gravity_scale=0.0)
    b.sphere(bullet, 0.1, speculative_margin=0.05)
    return b.finalize(max_bodies=4, max_colliders=4, max_contacts=16), bullet


def _two_bullets():
    """tests/test_scenes.py::test_swept_ccd_vs_swept_ccd's world."""
    b = JBuilder()
    left = b.add_body(pos=(-4.0, 0.0, 0.0), lin_vel=(150.0, 0.0, 0.0), swept_ccd=True,
                      gravity_scale=0.0)
    b.sphere(left, 0.1, speculative_margin=0.05)
    right = b.add_body(pos=(4.0, 0.0, 0.0), lin_vel=(-150.0, 0.0, 0.0), swept_ccd=True,
                       gravity_scale=0.0)
    b.sphere(right, 0.1, speculative_margin=0.05)
    return b.finalize(max_bodies=4, max_colliders=4, max_contacts=16), (left, right)


def _spinning():
    """A thin box and a capsule, both swept nonlinearly and spinning, fired
    at a wall; a sphere swept linearly beside them."""
    b = JBuilder()
    wall = b.add_body(body_type=BodyType.STATIC, pos=(5.0, 0.0, 0.0))
    b.box(wall, 0.05, 10.0, 10.0)
    plate = b.add_body(pos=(0.0, 1.0, 0.0), lin_vel=(250.0, 0.0, 0.0), ang_vel=(0.0, 0.0, 30.0),
                       swept_ccd=True, swept_ccd_nonlinear=True, gravity_scale=0.0)
    b.box(plate, 0.4, 0.02, 0.3, speculative_margin=0.05)
    rod = b.add_body(pos=(0.5, -1.0, 0.0), quat=(0.0, 0.0, 0.3826834, 0.9238795),
                     lin_vel=(280.0, 0.0, 0.0), ang_vel=(0.0, 40.0, 10.0), swept_ccd=True,
                     swept_ccd_nonlinear=True, gravity_scale=0.0)
    b.capsule(rod, 0.05, 0.4, speculative_margin=0.05)
    ball = b.add_body(pos=(1.0, 3.0, 0.0), lin_vel=(200.0, 0.0, 0.0), swept_ccd=True,
                      gravity_scale=0.0)
    b.sphere(ball, 0.1, speculative_margin=0.05)
    return b.finalize(max_bodies=4, max_colliders=4, max_contacts=16), None


def _forty():
    """40 swept spheres in a row, each faster than the last, at a wall;
    only the 32 lowest collider indices are swept."""
    b = JBuilder()
    wall = b.add_body(body_type=BodyType.STATIC, pos=(5.0, 0.0, 0.0))
    b.box(wall, 0.05, 10.0, 10.0)
    for k in range(40):
        body = b.add_body(pos=(2.0, 0.25 * (k % 20) - 2.5, 0.3 * (k // 20)),
                          lin_vel=(200.0 + 3.0 * k, 0.0, 0.0), swept_ccd=True, gravity_scale=0.0)
        b.sphere(body, 0.1, speculative_margin=0.05)
    return b.finalize(max_bodies=41, max_colliders=41, max_contacts=128), None


# ---- solve_swept_ccd on one solver state ----------------------------------------

def _delta_poses(jw, seed, dt):
    """Each awake body's delta pose of one step at its velocities (its delta
    quaternion from the angular velocity), with a seeded jitter of up to 1 cm
    on the delta position."""
    rng = np.random.default_rng(seed)
    b = jax.tree.map(np.asarray, jw.bodies)
    n = b.pos.shape[0]
    dpos = (b.lin_vel * dt + rng.uniform(-0.01, 0.01, (n, 3))).astype(np.float32)
    dquat = np.asarray(jquat.from_scaled_axis(jnp.asarray(b.ang_vel * dt, jnp.float32)))
    return dpos, dquat


def _port_state(jw, dpos, dquat):
    s_port = tsb.prepare(to_torch(jw).bodies)
    s_port.state[:, tsb.DPOS:tsb.DPOS + 3] = torch.from_numpy(dpos)
    s_port.state[:, tsb.DQUAT:tsb.DQUAT + 4] = torch.from_numpy(dquat.copy())
    return s_port


def _reference_sweep(jw, jcfg, dpos, dquat, k_cap):
    """The reference's ``solve_swept_ccd`` on the delta poses: the scaled
    delta positions, and its swept colliders (``top_k`` on -index over the
    flagged) with their flags."""
    s_ref = jsb.prepare(jw.bodies).replace(delta_pos=jnp.asarray(dpos),
                                           delta_quat=jnp.asarray(dquat))
    jw2 = _J_AABBS(jw, jcfg)
    col, b = jw2.colliders, jw2.bodies
    sweep = s_ref.delta_pos[col.body_idx]
    flagged = (b.swept_ccd[col.body_idx] & b.active[col.body_idx] & col.active
               & (jnp.sum(sweep * sweep, -1) > 1e-12))
    m = col.capacity
    score = jnp.where(flagged, -jnp.arange(m, dtype=jnp.float32), -jnp.inf)
    idx = jax.lax.top_k(score, min(k_cap, m))[1]
    return {"delta_pos": _J_CCD(jw2, s_ref, jcfg).delta_pos, "idx": idx, "ok": flagged[idx]}


# Each world: its builder and the time its solver state sweeps (long
# enough for the bullets to reach their targets).
WORLDS = {
    "wall_bullet": (_wall_bullet, 1.0 / 60.0),
    "two_bullets": (_two_bullets, 3.0 / 60.0),
    "spinning": (_spinning, 2.0 / 60.0),
    "forty": (_forty, 1.0 / 60.0),
}


def check_swept_ccd(jw, pairs, k_cap, dt, seed, recording=RECORDING):
    """``solve_swept_ccd`` on ``_delta_poses(jw, seed, dt)`` by both
    packages: the swept colliders exactly and the scaled delta positions
    within ``CCD_TOL``. Returns which bodies the reference rewound. The
    world's static ``shape_pairs`` is set to ``pairs``, so that worlds of one
    capacity share the reference's compile."""
    jw = jw.replace(shape_pairs=pairs)
    kw = dict(max_colors=4, swept_ccd=True, shape_pairs=pairs, max_swept_colliders=k_cap)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    dpos, dquat = _delta_poses(jw, seed, dt)
    s_port = _port_state(jw, dpos, dquat)
    ref = recording((jw, repr(jcfg), dpos, dquat, k_cap),
                    lambda: _reference_sweep(jw, jcfg, dpos, dquat, k_cap))
    want, idx, ok = ref.delta_pos, ref.idx, ref.ok
    tw2, pos, quat = tbp.update_aabbs_and_poses(to_torch(jw), tcfg)
    grid = tccd.swept_grid(tw2, s_port, pos, quat, tcfg)
    got = as_numpy(tccd.solve_swept_ccd(tw2, s_port, pos, quat, tcfg)[0].delta_pos)
    assert grid.k_ok == int(ok.sum()) and ok[:grid.k_ok].all()
    np.testing.assert_array_equal(as_numpy(grid.swept)[:grid.k_ok], idx[ok])
    rewound = np.abs(dpos - want).max(1) > 0
    assert rewound.any(), "no body was rewound"
    np.testing.assert_allclose(got, want, atol=CCD_TOL, rtol=0)
    return rewound, int(ok.sum())


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_solve_swept_ccd_matches_reference(name):
    make, dt = WORLDS[name]
    rewound, swept = check_swept_ccd(make()[0], SMALL_PAIRS, 32, dt, seed=len(name))
    if name == "forty":
        # Bodies 33-40 (colliders 33-40) are flagged but not swept.
        assert swept == 32 and not rewound[33:].any() and rewound[1:33].all()


# ---- whole steps -----------------------------------------------------------------

def _step_configs(swept):
    kw = dict(max_colors=4, swept_ccd=swept, shape_pairs=SMALL_PAIRS)
    return JConfig(**kw), TConfig(**kw)


def _reference_steps(jw, jcfg, n_steps):
    pos, lin_vel = [], []
    for _ in range(n_steps):
        jw = _J_STEP(jw, jcfg)
        pos.append(jw.bodies.pos)
        lin_vel.append(jw.bodies.lin_vel)
    return {"pos": jnp.stack(pos), "lin_vel": jnp.stack(lin_vel)}


def _steps_match(jw, n_steps, swept):
    """``n_steps`` steps of ``jw`` by both packages, every body within
    ``STEP_TOL`` after each; the port's final world."""
    jw = jw.replace(shape_pairs=SMALL_PAIRS)
    jcfg, tcfg = _step_configs(swept)
    ref = RECORDING((jw, repr(jcfg), n_steps), lambda: _reference_steps(jw, jcfg, n_steps))
    tw = to_torch(jw)
    for k in range(n_steps):
        tw = t_step(tw, tcfg)
        for name in ("pos", "lin_vel"):
            np.testing.assert_allclose(as_numpy(getattr(tw.bodies, name)), ref[name][k],
                                       atol=STEP_TOL, rtol=0, err_msg=f"step {k + 1} {name}")
    return tw


def _example_ccd(swept):
    """examples/ccd.py's scene."""
    b = JBuilder()
    wall = b.add_body(body_type=BodyType.STATIC, pos=(5.0, 0.0, 0.0))
    b.box(wall, 0.05, 3.0, 3.0)
    bullet = b.add_body(pos=(0.0, 0.0, 0.0), lin_vel=(80.0, 0.0, 0.0), gravity_scale=0.0,
                        swept_ccd=swept)
    b.sphere(bullet, 0.1)
    return b.finalize(max_bodies=4, max_colliders=4, max_contacts=16), bullet


def test_swept_bullet_steps_match_reference():
    """test_scenes.py::test_swept_ccd_rewinds_fast_body: 10 steps, x < 5."""
    jw, bullet = _wall_bullet()
    tw = _steps_match(jw, 10, True)
    assert float(tw.bodies.pos[bullet][0]) < 5.0


def test_swept_pair_steps_match_reference():
    """test_scenes.py::test_swept_ccd_vs_swept_ccd: 12 steps, no crossing."""
    jw, (left, right) = _two_bullets()
    tw = _steps_match(jw, 12, True)
    xl, xr = float(tw.bodies.pos[left][0]), float(tw.bodies.pos[right][0])
    assert xl <= xr + 0.2 and np.isfinite([xl, xr]).all()


@pytest.mark.parametrize("swept", [False, True])
def test_example_ccd_steps_match_reference(swept):
    """examples/ccd.py: 30 steps in its mode, x < 5."""
    jw, bullet = _example_ccd(swept)
    tw = _steps_match(jw, 30, swept)
    assert float(tw.bodies.pos[bullet][0]) < 5.0


def test_ccd_stress_steps_match_reference():
    """ccd_stress(32, 80) (BASELINE config 4, speculative contacts only):
    the port's scene is the reference's, and 30 steps match. Its 272 contact
    slots hold fewer pairs than the 32 bullets' speculative AABBs meet (the
    first step drops 208), so the wall's pairs are dropped and the bullets
    pass the wall in both packages (ROADMAP 3b); the 8 bullets of
    tests/test_scenes.py stop there."""
    from port_common import assert_worlds_equal

    jw, ids = jscenes.ccd_stress(32, 80.0)
    port, port_ids = scenes.ccd_stress(32, 80.0, device="cpu")
    assert_worlds_equal(jw, port)
    assert port_ids == ids
    tw = _steps_match(jw, 30, False)
    assert np.all(np.isfinite(as_numpy(tw.bodies.pos)))


# ---- a force on a sleeping body ---------------------------------------------------

def test_constant_force_wakes_a_sleeping_body():
    """A 1 m box asleep on a half-space after 30 steps; a constant force of
    200 N along x
    then wakes it and it slides. The reference skips every step while all
    bodies sleep (its early-out does not look at forces), so the box stays
    asleep and its x moves by 0.0 (ROADMAP 3b); ``avian_tpu/api/forces.py``
    states the intended behaviour, that a written force wakes the body."""
    from avian_tpu_torch import SceneBuilder

    b = SceneBuilder()
    g = b.add_body(body_type=BodyType.STATIC)
    b.half_space(g, normal=(0, 1, 0))
    box = b.add_body(pos=(0.0, 0.5, 0.0))
    b.box(box, 0.5, 0.5, 0.5)
    world = b.finalize(max_bodies=2, max_colliders=2, max_contacts=16, device="cpu")
    config = TConfig(max_colors=4)
    for _ in range(30):
        world = physics_step(world, config)
    assert bool(world.bodies.sleeping[box])
    x0 = float(world.bodies.pos[box, 0])
    cf = world.bodies.const_force.clone()
    cf[box] = torch.tensor([200.0, 0.0, 0.0])
    world = world.replace(bodies=world.bodies.replace(const_force=cf))
    for _ in range(30):
        world = physics_step(world, config)
    assert not bool(world.bodies.sleeping[box])
    assert float(world.bodies.pos[box, 0]) - x0 > 0.5


# ---- the two repairs of the reference's sweep (ROADMAP 3b) -------------------------

def _ball_at_wall(x):
    """A ball (radius 0.1, swept nonlinearly) at ``x`` before a wall 0.1 m
    thick whose face is at x = 4.95."""
    b = JBuilder()
    wall = b.add_body(body_type=BodyType.STATIC, pos=(5.0, 0.0, 0.0))
    b.box(wall, 0.05, 10.0, 10.0)
    ball = b.add_body(pos=(x, 0.0, 0.0), swept_ccd=True, swept_ccd_nonlinear=True,
                      gravity_scale=0.0)
    b.sphere(ball, 0.1, speculative_margin=0.05)
    return b.finalize(max_bodies=4, max_colliders=4, max_contacts=16)


def _both_sweeps(jw, dpos, dangle):
    """``solve_swept_ccd`` of both packages on ``jw`` with the ball's delta
    position ``dpos`` and a delta rotation of ``dangle`` rad about z."""
    jw = jw.replace(shape_pairs=SMALL_PAIRS)
    kw = dict(max_colors=4, swept_ccd=True, shape_pairs=SMALL_PAIRS)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    s_ref = jsb.prepare(jw.bodies)
    s_port = tsb.prepare(to_torch(jw).bodies)
    dq = np.asarray(jquat.from_scaled_axis(jnp.asarray([0.0, 0.0, dangle], jnp.float32)))
    d = np.zeros((jw.bodies.capacity, 3), np.float32)
    q = np.tile(np.asarray([0.0, 0.0, 0.0, 1.0], np.float32), (jw.bodies.capacity, 1))
    d[1], q[1] = dpos, dq
    s_ref = s_ref.replace(delta_pos=jnp.asarray(d), delta_quat=jnp.asarray(q))
    s_port.state[:, tsb.DPOS:tsb.DPOS + 3] = torch.from_numpy(d)
    s_port.state[:, tsb.DQUAT:tsb.DQUAT + 4] = torch.from_numpy(q)
    want = np.asarray(_J_CCD(_J_AABBS(jw, jcfg), s_ref, jcfg).delta_pos)[1]
    tw2, pos, quat = tbp.update_aabbs_and_poses(to_torch(jw), tcfg)
    got = as_numpy(tccd.solve_swept_ccd(tw2, s_port, pos, quat, tcfg)[0].delta_pos)[1]
    return got, want


def test_a_body_carried_through_what_it_touches_is_stopped():
    """The ball touches the wall's face at the start of the step and its
    sweep carries it 0.2 m on, through the face. The reference drops the
    touching pair and moves it the whole 0.2 m (a fault); the port's sweep
    stops it once it has sunk half the ball's radius (0.05 m) deep."""
    got, want = _both_sweeps(_ball_at_wall(4.85), (0.2, 0.0, 0.0), 0.0)
    np.testing.assert_allclose(want, [0.2, 0.0, 0.0], atol=1e-7)  # the reference's fault
    assert 0.045 < got[0] < 0.055 and got[1] == got[2] == 0.0, got


def test_a_sweep_whose_rounds_run_out_still_stops_the_body():
    """The ball, 0.25 m from the wall, moves 0.5 m toward it while it turns
    by 3 rad: the angular bound keeps each round's step short, and after its
    8 rounds the advancement has not met the wall. The reference then moves
    it the whole 0.5 m, its centre past the wall's face (a fault); the port
    stops it at the last time the advancement reached, short of the wall."""
    got, want = _both_sweeps(_ball_at_wall(4.6), (0.5, 0.0, 0.0), 3.0)
    np.testing.assert_allclose(want, [0.5, 0.0, 0.0], atol=1e-7)  # the reference's fault
    assert 0.2 < got[0] < 0.25 and got[1] == got[2] == 0.0, got
