"""Solver bodies and integration (Kernel C's twin on CPU) against the JAX
reference on randomized bodies: locks, sleeping, kinematic bodies,
gyroscopic torque, speed clamps, damping, forces. Tolerance 1e-5 abs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avian_tpu import scenes as jscenes
from avian_tpu.pipeline import integrator as jint
from avian_tpu.pipeline import solver_body as jsb
from avian_tpu_torch.kernels import integrate_bodies as kc
from avian_tpu_torch.pipeline import integrator as tint
from avian_tpu_torch.pipeline import solver_body as tsb

from port_common import to_torch

TOL = 1e-5
H = 1.0 / 240.0


def _random_bodies(seed):
    world, _ = jscenes.cube_pile(27, max_contacts=64)
    rng = np.random.default_rng(seed)
    b = world.bodies
    n = b.capacity

    def f(*shape, lo=-1.0, hi=1.0):
        return jnp.asarray(rng.uniform(lo, hi, size=shape).astype(np.float32))

    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    body_type = np.asarray(b.body_type).copy()
    body_type[1:4] = 2  # kinematic
    bodies = b.replace(
        pos=f(n, 3, lo=-3, hi=3), quat=jnp.asarray(q),
        lin_vel=f(n, 3, lo=-3, hi=3), ang_vel=f(n, 3, lo=-6, hi=6),
        body_type=jnp.asarray(body_type),
        locked_axes=jnp.asarray(rng.choice([0, 0, 0, 1, 8, 7, 56], size=n).astype(np.int32)),
        sleeping=jnp.asarray(rng.uniform(size=n) < 0.2),
        gyroscopic=jnp.asarray(rng.uniform(size=n) < 0.5),
        max_lin_speed=jnp.asarray(np.where(rng.uniform(size=n) < 0.3, 1.5, np.inf).astype(np.float32)),
        max_ang_speed=jnp.asarray(np.where(rng.uniform(size=n) < 0.3, 2.0, np.inf).astype(np.float32)),
        lin_damping=f(n, lo=0, hi=0.5), ang_damping=f(n, lo=0, hi=0.5),
        force=f(n, 3), torque=f(n, 3), const_force=f(n, 3),
        const_local_torque=f(n, 3), const_lin_acc=f(n, 3), const_local_ang_acc=f(n, 3),
        com=f(n, 3, lo=-0.1, hi=0.1),
        inv_inertia=jnp.asarray(np.concatenate(
            [rng.uniform(0.5, 2.0, size=(n, 3)), rng.uniform(-0.1, 0.1, size=(n, 3))], 1
        ).astype(np.float32)),
    )
    return world.replace(bodies=bodies), rng


def _port_state(js, tb):
    """The port's packed solver state from a reference SolverState."""
    state = torch.from_numpy(np.concatenate(
        [np.asarray(js.lin_vel), np.asarray(js.ang_vel),
         np.asarray(js.delta_pos), np.asarray(js.delta_quat)], 1))
    s = tsb.prepare(tb)
    return s.replace(state=state)


def _assert_state(js, ts):
    for name in ("lin_vel", "ang_vel", "delta_pos", "delta_quat"):
        np.testing.assert_allclose(
            getattr(ts, name).numpy(), np.asarray(getattr(js, name)), atol=TOL, rtol=0,
            err_msg=name,
        )


@pytest.mark.parametrize("seed", [0, 1])
def test_prepare_and_increments_match(seed):
    jw, _ = _random_bodies(seed)
    tw = to_torch(jw)
    js = jsb.prepare(jw.bodies)
    ts = tsb.prepare(tw.bodies)
    _assert_state(js, ts)
    for name in ("inv_mass", "inv_inertia", "solve_mask"):
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   atol=TOL, rtol=0, err_msg=name)
    ji = jint.pre_process_velocity_increments(jw.bodies, jw.gravity, H)
    ti = tint.pre_process_velocity_increments(tw.bodies, tw.gravity, H)
    for name in ("lin_inc", "ang_inc", "lin_damping_rhs", "ang_damping_rhs"):
        np.testing.assert_allclose(getattr(ti, name).numpy(), np.asarray(getattr(ji, name)),
                                   atol=TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_substep_integration_matches(seed):
    """integrate_velocities + clamp_velocities, then integrate_positions,
    from a state with non-identity delta rotations."""
    jw, rng = _random_bodies(seed)
    tw = to_torch(jw)
    js = jsb.prepare(jw.bodies)
    n = jw.bodies.capacity
    dq = rng.normal(size=(n, 4)).astype(np.float32) * np.float32(0.05)
    dq[:, 3] = 1.0
    dq /= np.linalg.norm(dq, axis=1, keepdims=True)
    js = js.replace(delta_quat=jnp.asarray(dq),
                    delta_pos=jnp.asarray(rng.uniform(-0.01, 0.01, (n, 3)).astype(np.float32)))
    ts = _port_state(js, tw.bodies)
    ji = jint.pre_process_velocity_increments(jw.bodies, jw.gravity, H)
    table = tint.integration_table(
        tw.bodies, tint.pre_process_velocity_increments(tw.bodies, tw.gravity, H)
    )
    js = jint.clamp_velocities(jint.integrate_velocities(js, ji, jw.bodies, H), jw.bodies)
    ts = tint.integrate_velocities(ts, table, H)
    _assert_state(js, ts)
    js = jint.integrate_positions(js, H)
    ts = tint.integrate_positions(ts, table, H)
    _assert_state(js, ts)
    jb = jsb.writeback(jw.bodies, js)
    tb = tsb.writeback(tw.bodies, ts)
    for name in ("pos", "quat", "lin_vel", "ang_vel"):
        np.testing.assert_allclose(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)),
                                   atol=TOL, rtol=0, err_msg=name)


def test_gyroscopic_step_changes_spin_axis():
    """A spinning asymmetric body's gyroscopic step keeps |L| and moves w."""
    w = torch.tensor([[1.0, 2.0, 0.5]])
    q = torch.tensor([[0.0, 0.0, 0.0, 1.0]])
    inv6 = torch.tensor([[1.0, 0.5, 0.25, 0.0, 0.0, 0.0]])
    out = kc.solve_gyroscopic_torque(w, q, inv6, 0.01)
    assert not torch.allclose(out, w)
    inertia = torch.tensor([1.0, 2.0, 4.0])
    assert torch.allclose((inertia * out).norm(), (inertia * w).norm(), rtol=1e-6)


def test_integrate_bodies_refuses_unknown_mode():
    with pytest.raises(ValueError):
        kc.integrate_bodies(torch.zeros(2, 13), torch.zeros(2, 22), H, 7)
