"""The port's 2D swept CCD against the JAX reference (``avian_tpu.dim2``) on
the CPU, where Kernel AB runs as its plain PyTorch twin: ``tests/
test_dim2_api.py``'s bullet and wall (:192) and bullets fired at each other
(:212) and a spinning capsule swept nonlinearly into a wall, every step's
delta positions before and after the sweep, times of impact and poses; the
two faults of the reference's sweep that the port repairs, each shown in a
scene where the reference's body goes through a wall and the port's does not
(ROADMAP 3b); and ``pyramid_ccd_2d(6, 4)``, where the reference's capsule
ends inside a box.

Tolerances: the rewound delta positions, the times of impact and the poses
1e-5 (the sweeps are linear or turn with ``cos``/``sin`` that PyTorch's CPU
rounds a few ulp off XLA's); the pyramid's poses 1e-4 m (its contacts sum
impulses per body in another order). The reference is compiled one IEEE
operation at a time (``port_common.ieee_reference``).
"""

from port_common import ieee_reference

ieee_reference()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from avian_tpu import PhysicsConfig as JConfig  # noqa: E402
from avian_tpu.dim2 import SceneBuilder2D as JBuilder2D  # noqa: E402
from avian_tpu.dim2 import broadphase as jbp  # noqa: E402
from avian_tpu.dim2 import ccd as jccd  # noqa: E402
from avian_tpu.dim2 import contacts as jnc  # noqa: E402
from avian_tpu.dim2 import dynamics as jdyn  # noqa: E402
from avian_tpu.dim2 import solver as jsol  # noqa: E402
from avian_tpu.dim2 import xpbd as jxpbd  # noqa: E402
from avian_tpu.dim2.step import physics_step_2d as j_step  # noqa: E402
from avian_tpu_torch import PhysicsConfig as TConfig  # noqa: E402
from avian_tpu_torch.core.types import BodyType  # noqa: E402
from avian_tpu_torch.dim2 import SceneBuilder2D as TBuilder2D  # noqa: E402
from avian_tpu_torch.dim2 import broadphase as tbp  # noqa: E402
from avian_tpu_torch.dim2 import ccd as tccd  # noqa: E402
from avian_tpu_torch.dim2 import physics_step_2d  # noqa: E402
from avian_tpu_torch.dim2 import scenes as tscenes  # noqa: E402
from avian_tpu_torch.dim2 import step as tstep  # noqa: E402
from avian_tpu_torch.kernels import manifold_2d as kv  # noqa: E402
from avian_tpu_torch.kernels import swept_toi_2d as kab  # noqa: E402

from cases_dim2 import assert_worlds_equal, to_jax2d, to_torch2d  # noqa: E402
from shared_2d import inside_polygons  # noqa: E402
from port_common import as_numpy  # noqa: E402

torch.set_num_threads(1)
CCD_TOL, PYRAMID_TOL = 1e-5, 1e-4
CFG = dict(max_colors=4, swept_ccd=True)
JCFG, TCFG = JConfig(**CFG), TConfig(**CFG)


def _close(port, ref, atol, what):
    np.testing.assert_allclose(as_numpy(port), np.asarray(ref), atol=atol, rtol=0, err_msg=what)


@jax.jit
def _j_presweep(w):
    """The reference's step up to its sweep (``dim2/step.py:35-90``, no hooks
    or custom joints): the delta positions after the substeps, and after the
    sweep."""
    h = JCFG.substep_dt
    w = jbp.update_aabbs(w, JCFG)
    contacts = jnc.narrow_phase(w, jbp.broad_phase(w, JCFG), JCFG)
    s = jdyn.prepare(w.bodies)
    inc = jdyn.pre_process_velocity_increments(w.bodies, w.gravity, h)
    con = jsol.prepare_constraints(w, contacts, s, JCFG)
    jcon = jxpbd.prepare_joints(w, s, JCFG)

    def substep(carry, _):
        s, con, jcon = carry
        s = jdyn.clamp_velocities(jdyn.integrate_velocities(s, inc, w.bodies), w.bodies)
        s = jsol.warm_start(s, con, JCFG)
        s, con = jsol.solve_pass(s, con, h, True, JCFG)
        s = jdyn.integrate_positions(s, h)
        s, con = jsol.solve_pass(s, con, h, False, JCFG)
        s, jcon, _ = jxpbd.solve_position_constraints(s, jcon, w.bodies, h, JCFG)
        return (s, con, jcon), None

    (s, _, _), _ = jax.lax.scan(substep, (s, con, jcon), None, length=JCFG.substeps)
    return s.delta_pos, jccd.solve_swept_ccd_2d(w, s, JCFG).delta_pos


def _t_presweep(w):
    """The port's step up to its sweep: (delta positions after the substeps,
    after the sweep, each body's TOI)."""
    p = tstep.substepped(w, TCFG)
    before = p.s.delta_pos.clone()
    tab, swept = tccd.swept_tables(p.world, p.s, p.poses, TCFG)
    body_toi = kab.swept_toi_2d(swept, tab, w.bodies.capacity)[1]
    return before, tccd.solve_swept_ccd_2d(p.world, p.s, p.poses, TCFG).delta_pos, body_toi


def _bullets(b, **kw):
    """``tests/test_dim2_api.py:192``'s bullet and thin wall, its :212 bullets
    fired at each other (30 m up), a capsule spinning at 40 rad/s swept
    nonlinearly at 100 m/s into a thin wall 3 m away (60 m up); then the two
    faults of the reference's sweep, each before a thin wall from x 0.95 to
    1.05: a capsule 0.5 m short of it at 60 m/s spinning at 200 rad/s (100 m
    up: the advancement's 8 rounds run out, and the reference returns 1) and
    one already touching it, tilted, at 300 m/s spinning at 40 rad/s (120 m
    up: the reference drops a pair that touches at t = 0)."""
    wall = b.add_body(body_type=BodyType.STATIC, pos=(5.0, 0.0))
    b.box(wall, 0.05, 10.0)
    bullet = b.add_body(pos=(0.0, 0.0), lin_vel=(300.0, 0.0), swept_ccd=True, gravity_scale=0.0)
    b.circle(bullet, 0.1, speculative_margin=0.05)
    for x, v in ((-4.0, 150.0), (4.0, -150.0)):
        body = b.add_body(pos=(x, 30.0), lin_vel=(v, 0.0), swept_ccd=True, gravity_scale=0.0)
        b.circle(body, 0.1, speculative_margin=0.05)
    for y, x, wall_x, angle, v, w in ((60.0, 0.0, 3.0, 0.0, 100.0, 40.0),
                                      (100.0, 0.35, 1.0, 0.0, 60.0, 200.0),
                                      (120.0, 0.75, 1.0, 1.2, 300.0, 40.0)):
        wall = b.add_body(body_type=BodyType.STATIC, pos=(wall_x, y))
        b.box(wall, 0.05, 2.0)
        cap = b.add_body(pos=(x, y), angle=angle, lin_vel=(v, 0.0), ang_vel=w,
                         gravity_scale=0.0, swept_ccd=True, swept_ccd_nonlinear=True)
        b.capsule(cap, 0.05, 0.4, speculative_margin=0.05)
    return b.finalize(max_bodies=10, max_colliders=10, max_contacts=40, **kw)


BULLETS = [0, 1, 2, 3]     # the bullets and their wall
HELD = BULLETS + [4, 5]    # and the capsule and its wall
FAULTS = [7, 9]            # the two capsules of the reference's faults
# The capsule is cut and left touching its wall in step 2; from step 3 the
# touching pair's sweep is the first repair's (ROADMAP 3b), so it is held for
# two steps.
CAPSULE_HELD_STEPS = 2


def test_bullets_spinning_capsules_and_the_repairs():
    """Every step: the delta positions after the substeps, and after the
    sweep, and each swept body's TOI (where the reference cuts, ``scale /
    1.0001``) within ``CCD_TOL``, then the step's poses, for the bullets and
    the capsule (the capsule until it touches its wall, ``CAPSULE_HELD_STEPS``);
    each source's own check (the bullet stops at the wall, the
    two bullets do not cross, the capsule stays short of its wall). The two
    faults: in the first step the reference's sweep leaves both capsules'
    delta positions whole and the port cuts both; the first starts apart
    from its wall and the second touches it (their separations at t = 0);
    within 6 steps the reference's capsules are through their walls and the
    port's are not."""
    jw, tw = _bullets(JBuilder2D()), _bullets(TBuilder2D(), device="cpu")
    assert_worlds_equal(jw, tw)
    poses = tbp.collider_poses(tw)
    col = tw.colliders
    man = kv.manifold_2d_twin(torch.tensor(FAULTS), torch.tensor(FAULTS) - 1, poses.pos, poses.cs,
                              col.poly_verts, col.vert_count, col.radius, col.is_plane)
    sep0 = man.separation.amin(1)
    assert float(sep0[0]) > 0.1 and float(sep0[1]) <= 1e-4
    cut_steps = 0
    for i in range(12):
        held = HELD if i < CAPSULE_HELD_STEPS else BULLETS
        d_in, d_out = (np.asarray(x) for x in _j_presweep(jw))
        port_in, port_out, body_toi = _t_presweep(tw)
        _close(port_in[held], d_in[held], CCD_TOL, f"step {i + 1} delta pos")
        _close(port_out[held], d_out[held], CCD_TOL, f"step {i + 1} rewound delta pos")
        swept = np.asarray([k for k in (1, 2, 3, 5) if k in held])
        cut = np.abs(d_out[swept, 0]) < np.abs(d_in[swept, 0])
        ref_toi = np.where(cut, d_out[swept, 0] / np.where(cut, d_in[swept, 0], 1.0)
                           / tccd.TOI_EPS, 1.0)
        _close(torch.where(torch.from_numpy(cut), body_toi[swept], 1.0), ref_toi, CCD_TOL,
               f"step {i + 1} TOI")
        cut_steps += int(cut.any())
        if i == 0:
            np.testing.assert_array_equal(d_out[FAULTS], d_in[FAULTS])
            assert bool((body_toi[FAULTS] < 1.0).all())
        jw, tw = j_step(jw, JCFG), physics_step_2d(tw, TCFG)
        for name in ("pos", "angle", "lin_vel", "ang_vel"):
            _close(getattr(tw.bodies, name)[held], np.asarray(getattr(jw.bodies, name))[held],
                   CCD_TOL, f"step {i + 1} {name}")
        if i == 5:
            ref_x = np.asarray(jw.bodies.pos)[FAULTS, 0]
            port_x = as_numpy(tw.bodies.pos)[FAULTS, 0]
            assert (ref_x > 1.05).all(), ref_x   # through the wall
            assert (port_x < 1.0).all(), port_x  # the centre short of the wall's middle
    pos = as_numpy(tw.bodies.pos)
    assert cut_steps >= 2
    assert pos[1, 0] < 5.0 and pos[2, 0] <= pos[3, 0] + 0.2 and pos[5, 0] < 3.0


def test_pyramid_ccd_2d_matches_reference():
    """``scenes.pyramid_ccd_2d(6, 4)``: the bullets reach the apex in the
    third step, which every body takes within ``PYRAMID_TOL`` of the
    reference. The third step's sweep leaves the first capsule touching the
    apex; in the fourth the reference drops that pair and the capsule's
    centre ends inside a box, and the port's does not (ROADMAP 3b). Through
    6 steps no bullet of the port is inside a box or below the ground."""
    tw, ids, shots = tscenes.pyramid_ccd_2d(6, 4, device="cpu")
    jw = to_jax2d(tw)
    assert int(tw.bodies.swept_ccd_nonlinear.sum()) == 2 and len(shots) == 4
    for i in range(6):
        jw, tw = j_step(jw, JCFG), physics_step_2d(tw, TCFG)
        if i < 3:
            for name in ("pos", "angle"):
                _close(getattr(tw.bodies, name), getattr(jw.bodies, name), PYRAMID_TOL,
                       f"step {i + 1} {name}")
        if i == 3:
            ref = torch.from_numpy(np.asarray(jw.bodies.pos))
            assert bool(inside_polygons(ref[shots], to_torch2d(jw)).any())
        bullets = tw.bodies.pos[shots]
        assert not bool(inside_polygons(bullets, tw).any()) and bool((bullets[:, 1] > 0).all())
    assert float(tw.bodies.pos[shots, 1].max()) < 18.0 - 2 * 5.0  # they flew down
