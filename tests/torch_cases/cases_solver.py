"""Constraint preparation, the solver passes (Kernel D's twin on CPU),
restitution, impulse storage and sleeping islands against the JAX reference
(the coloring's own cases are in ``cases_coloring.py``), on a settled pile
with the reference's own contacts as input. Colors, buckets and island labels exactly; the rest within 1e-5 abs after
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
from avian_tpu_torch.pipeline import integrator as tint
from avian_tpu_torch.pipeline import sleeping as tsleep
from avian_tpu_torch.pipeline import solver as tsol
from avian_tpu_torch.pipeline import solver_body as tsb

import per_side_rows
from port_common import (assert_packed_rows_close, pile_configs, settled_pile, to_jax,
                         to_torch)

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
        jax.tree.map(np.asarray, ref["contacts"]), n_colliders=w2.colliders.capacity,
        device="cpu",
    )
    h = tcfg.substep_dt
    s, table = tsb.prepare_with_table(w2.bodies, w2.gravity, h)
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
    assert_packed_rows_close(con.data, rc.data, rc.bucket_valid, TOL)
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
        jax.tree.map(np.asarray, ref["contacts"]), n_colliders=w2.colliders.capacity,
        device="cpu",
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


def test_islands_and_sleeping_match(pile):
    tw, template = pile
    jcfg, tcfg = pile_configs(max_colors=MAX_COLORS)
    ref = _ref_step_parts(to_jax(tw, template), jcfg)
    jb, jc, jj = ref["w2"].bodies, ref["stored"], ref["w2"].joints
    tb = to_torch(ref["w2"]).bodies
    tc = TContacts.from_numpy(jax.tree.map(np.asarray, jc), n_colliders=65, device="cpu")
    from avian_tpu_torch.core.state import Joints

    tj = Joints.from_numpy(jax.tree.map(np.asarray, jj), device="cpu")
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


def test_row_update_equals_its_per_side_spelling():
    """Kernel D's plain row update, both ends as one [2, R] tensor, equals
    the same update written one end at a time (``per_side_rows.py``) bit for
    bit, on 800 seeded rows in every mode."""
    g = torch.Generator().manual_seed(0)
    for trial in range(4):
        d, irows, sa, sb, rlx = per_side_rows.random_rows("D", 200, g)
        p = kd.SolveParams(h=1 / 240, max_overlap_speed=4.0, stiction_t2=0.5 * trial,
                           warm_coefficient=1.0, restitution_threshold=0.5)
        for mode in (kd.WARM, kd.BIAS, kd.RELAX, kd.RESTITUTION):
            d_va, d_wa, d_vb, d_wb, want = per_side_rows._row_update_3d(
                mode, d, irows, sa, sb, rlx, p)
            delta, new = kd._row_update(mode, d, irows, sa, sb, rlx, p)
            per_side_rows.assert_same_bits(
                delta, torch.stack([torch.cat([d_va, d_wa], -1), torch.cat([d_vb, d_wb], -1)]),
                (trial, mode, "deltas"))
            per_side_rows.assert_same_bits(new, want, (trial, mode, "impulses"))
