"""Constraint preparation, coloring, the solver passes (Kernel D's twin on
CPU), restitution, impulse storage and sleeping islands against the JAX
reference, on a settled pile with the reference's own contacts as input.
Colors, buckets and island labels exactly; the rest within 1e-5 abs after
one substep.

Every case runs at ``max_colors=3``: the pile's 64 cubes then fill two
proper colors and the overflow color, so one compile of the reference
covers both kinds of color."""

from functools import partial

import jax
import numpy as np
import pytest
import torch

from avian_tpu.pipeline import broadphase as jbp
from avian_tpu.pipeline import contacts as jcontacts
from avian_tpu.pipeline import integrator as jint
from avian_tpu.pipeline import sleeping as jsleep
from avian_tpu.pipeline import solver as jsol
from avian_tpu.pipeline import solver_body as jsb
from avian_tpu_torch.core.state import Contacts as TContacts
from avian_tpu_torch.kernels import solve_color as kd
from avian_tpu_torch.pipeline import coloring as tcol
from avian_tpu_torch.pipeline import integrator as tint
from avian_tpu_torch.pipeline import sleeping as tsleep
from avian_tpu_torch.pipeline import solver as tsol
from avian_tpu_torch.pipeline import solver_body as tsb

from port_common import pile_configs, settled_pile, to_jax, to_torch

TOL = 1e-5
MAX_COLORS = 3


@partial(jax.jit, static_argnums=1)
def _ref_step_parts(world, config):
    """The reference's step up to the end of the first substep and the
    restitution pass, with every intermediate the test compares."""
    h = config.substep_dt
    w2 = jbp.update_aabbs(world, config)
    bp = jbp.broad_phase(w2, config)
    contacts = jcontacts.narrow_phase(w2, bp, config)
    s = jsb.prepare(w2.bodies)
    inc = jint.pre_process_velocity_increments(w2.bodies, w2.gravity, h)
    con = jsol.prepare_constraints(w2, contacts, s, config)
    out = {"w2": w2, "contacts": contacts, "con": con, "s0": s}
    s = jint.clamp_velocities(jint.integrate_velocities(s, inc, w2.bodies, h), w2.bodies)
    out["s_vel"] = s
    s = jsol.warm_start(s, con, config)
    out["s_warm"] = s
    s, con = jsol.solve_pass(s, con, h, True, config)
    out["s_bias"], out["imp_bias"] = s, con.imp
    s = jint.integrate_positions(s, h)
    s, con = jsol.solve_pass(s, con, h, False, config)
    out["s_relax"], out["imp_relax"] = s, con.imp
    s, con = jsol.solve_restitution(s, con, config)
    out["s_rest"], out["imp_rest"] = s, con.imp
    out["stored"] = jsol.store_impulses(contacts, con)
    return out


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(port, ref, name):
    np.testing.assert_allclose(_np(port), _np(ref), atol=TOL, rtol=0, err_msg=name)


def _close_data(port, ref, valid):
    """Packed constraint rows: per-row columns on valid rows, per-point
    columns on the points that are solved (point mask > 0). Anchors of
    points past ``num_points`` are leftovers of the manifold and carry no
    meaning; their products may differ in rounding."""
    port, ref, valid = _np(port), _np(ref), _np(valid)
    on = ref[..., kd.PM:kd.PM + 4] > 0
    for lo, hi in ((0, kd.AA), (kd.SV, kd.D)):
        _close(port[valid][:, lo:hi], ref[valid][:, lo:hi], f"data {lo}:{hi}")
    for base, width in ((kd.AA, 3), (kd.AB, 3), (kd.SEP, 1), (kd.NM, 1),
                        (kd.TK, 3), (kd.NS, 1), (kd.PM, 1)):
        for i in range(4):
            cols = slice(base + width * i, base + width * (i + 1))
            _close(port[..., cols][on[..., i]], ref[..., cols][on[..., i]],
                   f"data {base} point {i}")


def _velocities(ts, js, tag):
    _close(ts.lin_vel, js.lin_vel, f"{tag} lin_vel")
    _close(ts.ang_vel, js.ang_vel, f"{tag} ang_vel")


@pytest.fixture(scope="module")
def pile():
    return settled_pile()


def test_prepare_and_one_substep_match(pile):
    tw, template = pile
    jcfg, tcfg = pile_configs(max_colors=MAX_COLORS)
    ref = _ref_step_parts(to_jax(tw, template), jcfg)
    w2 = to_torch(ref["w2"])
    contacts = TContacts.from_numpy(
        jax.tree.map(np.asarray, ref["contacts"]), n_colliders=w2.colliders.capacity
    )
    s = tsb.prepare(w2.bodies)
    h = tcfg.substep_dt
    table = tint.integration_table(
        w2.bodies, tint.pre_process_velocity_increments(w2.bodies, w2.gravity, h)
    )
    con = tsol.prepare_constraints(w2, contacts, s, tcfg)

    rc = ref["con"]
    np.testing.assert_array_equal(_np(con.color_c), _np(rc.color_c))
    np.testing.assert_array_equal(_np(con.buckets), _np(rc.buckets))
    np.testing.assert_array_equal(_np(con.bucket_valid), _np(rc.bucket_valid))
    np.testing.assert_array_equal(_np(con.bucket_a), _np(rc.bucket_a))
    np.testing.assert_array_equal(_np(con.bucket_b), _np(rc.bucket_b))
    assert int(con.overflow_dropped) == int(rc.overflow_dropped)
    assert int(con.num_overflow) == int(rc.num_overflow)
    _close(con.relax, rc.relax, "relax")
    _close_data(con.data, rc.data, rc.bucket_valid)
    _close(con.imp, rc.imp, "imp")
    assert int(rc.num_overflow) > 0 and float(_np(rc.relax).min()) < 1.0
    assert int(rc.bucket_valid[:-1].sum()) > 0  # proper colors are used too

    s = tint.integrate_velocities(s, table, h)
    _velocities(s, ref["s_vel"], "integrate")
    s = tsol.warm_start(s, con, tcfg)
    _velocities(s, ref["s_warm"], "warm")
    s, con = tsol.solve_pass(s, con, True, tcfg)
    _velocities(s, ref["s_bias"], "bias")
    _close(con.imp, ref["imp_bias"], "imp bias")
    s = tint.integrate_positions(s, table, h)
    s, con = tsol.solve_pass(s, con, False, tcfg)
    _velocities(s, ref["s_relax"], "relax")
    _close(s.delta_pos, ref["s_relax"].delta_pos, "delta_pos")
    _close(s.delta_quat, ref["s_relax"].delta_quat, "delta_quat")
    _close(con.imp, ref["imp_relax"], "imp relax")
    s, con = tsol.solve_restitution(s, con, tcfg)
    _velocities(s, ref["s_rest"], "restitution")
    _close(con.imp, ref["imp_rest"], "imp restitution")
    stored = tsol.store_impulses(contacts, con)
    for name in ("normal_impulse", "tangent_impulse", "max_normal_impulse"):
        _close(getattr(stored, name), getattr(ref["stored"], name), name)
    np.testing.assert_array_equal(_np(stored.color), _np(ref["stored"].color))


def test_restitution_pass_bounces(pile):
    """With restitution on every contact and fast approach, the pass adds
    impulse exactly where the reference does."""
    tw, template = pile
    b = tw.bodies
    tw = tw.replace(
        bodies=b.replace(lin_vel=b.lin_vel + torch.tensor([0.0, -3.0, 0.0]) * (b.body_type == 1)[:, None]),
        colliders=tw.colliders.replace(restitution=torch.full_like(tw.colliders.restitution, 0.7)),
    )
    jcfg, tcfg = pile_configs(max_colors=MAX_COLORS)
    ref = _ref_step_parts(to_jax(tw, template), jcfg)
    w2 = to_torch(ref["w2"])
    contacts = TContacts.from_numpy(
        jax.tree.map(np.asarray, ref["contacts"]), n_colliders=w2.colliders.capacity
    )
    s = tsb.prepare(w2.bodies)
    con = tsol.prepare_constraints(w2, contacts, s, tcfg)
    # Start restitution from the reference's post-substep state.
    rs = ref["s_relax"]
    s = s.replace(state=torch.from_numpy(np.concatenate(
        [_np(rs.lin_vel), _np(rs.ang_vel), _np(rs.delta_pos), _np(rs.delta_quat)], 1)))
    con.imp.copy_(torch.from_numpy(np.array(ref["imp_relax"])))
    s, con = tsol.solve_restitution(s, con, tcfg)
    _velocities(s, ref["s_rest"], "restitution")
    _close(con.imp, ref["imp_rest"], "imp restitution")
    assert not np.allclose(_np(ref["imp_rest"]), _np(ref["imp_relax"]))


def test_coloring_is_proper_and_matches_on_random_graph():
    rng = np.random.default_rng(3)
    e, n = 300, 60
    a = rng.integers(0, n, size=e).astype(np.int32)
    b = (a + rng.integers(1, n, size=e)).astype(np.int32) % n
    dyn_a = rng.uniform(size=e) < 0.9
    dyn_b = rng.uniform(size=e) < 0.9
    mask = rng.uniform(size=e) < 0.95
    prev = rng.integers(-1, 8, size=e).astype(np.int32)
    from avian_tpu.pipeline.coloring import color_constraints as jcolor

    ref, ref_ovf = jax.jit(jcolor, static_argnums=(5, 6))(a, b, dyn_a, dyn_b, mask, n, 8,
                                                         prev_color=prev)
    t = lambda x: torch.from_numpy(np.asarray(x))  # noqa: E731
    col, ovf = tcol.color_constraints(t(a), t(b), t(dyn_a), t(dyn_b), t(mask), n, 8,
                                      prev_color=t(prev))
    np.testing.assert_array_equal(col.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(ref_ovf))
    # Proper: within a non-overflow color no dynamic body appears twice.
    col = col.numpy()
    for c in range(7):
        sel = mask & (col == c)
        ends = np.concatenate([a[sel & dyn_a], b[sel & dyn_b]])
        assert len(ends) == len(set(ends.tolist()))


def test_islands_and_sleeping_match(pile):
    tw, template = pile
    jcfg, tcfg = pile_configs(max_colors=MAX_COLORS)
    ref = _ref_step_parts(to_jax(tw, template), jcfg)
    jb, jc, jj = ref["w2"].bodies, ref["stored"], ref["w2"].joints
    tb = to_torch(ref["w2"]).bodies
    tc = TContacts.from_numpy(jax.tree.map(np.asarray, jc), n_colliders=65)
    from avian_tpu_torch.core.state import Joints

    tj = Joints.from_numpy(jax.tree.map(np.asarray, jj))
    label, ovf = jax.jit(jsleep.compute_islands)(jb, jc, jj)
    tlabel, tovf = tsleep.compute_islands(tb, tc, tj)
    np.testing.assert_array_equal(tlabel.numpy(), np.asarray(label))
    np.testing.assert_array_equal(tovf.numpy(), np.asarray(ovf))
    assert len(set(np.asarray(label)[1:].tolist())) < 64  # contacts joined bodies
    # Half the bodies slow and due to sleep: timers, readiness, sleep flags.
    slow = torch.arange(tb.capacity) % 2 == 0
    tb = tb.replace(
        lin_vel=torch.where(slow[:, None], tb.lin_vel * 0.0, tb.lin_vel),
        ang_vel=torch.where(slow[:, None], tb.ang_vel * 0.0, tb.ang_vel),
        sleep_timer=torch.where(slow, 1.0, 0.0),
    )
    jb2 = jb.replace(lin_vel=jax.numpy.asarray(tb.lin_vel.numpy()),
                     ang_vel=jax.numpy.asarray(tb.ang_vel.numpy()),
                     sleep_timer=jax.numpy.asarray(tb.sleep_timer.numpy()))
    rb = jax.jit(jsleep.update_sleeping, static_argnums=3)(jb2, jc, jj, jcfg)
    pb = tsleep.update_sleeping(tb, tc, tj, tcfg)
    for name in ("sleeping", "sleep_timer", "island", "lin_vel", "ang_vel"):
        np.testing.assert_array_equal(_np(getattr(pb, name)), _np(getattr(rb, name)),
                                      err_msg=name)


def test_solve_color_refuses_other_devices():
    """No silent fallback: a tensor neither on the CPU nor on a CUDA card
    is refused."""
    meta = torch.zeros(4, 13, device="meta")
    with pytest.raises(RuntimeError):
        kd.solve_color(kd.BIAS, 0, meta, *([None] * 8), kd.SolveParams(1.0, 1.0, 1.0, 1.0, 1.0))
