"""One 2D physics step (port of ``avian_tpu/dim2/step.py``).

Staged as the reference: poses and AABBs -> broadphase (Kernel U) ->
``hooks.filter_pairs`` -> narrowphase (Kernels V, F's key join, W) ->
``hooks.modify_contacts`` -> prepare (solver bodies and Kernel Z's table by
Z's prologue, contact constraints: Kernels G and X, joint rows: Kernels AA
and G, a custom joint's ``prepare``) -> substeps [integrate velocities (Z)
-> warm start (Y) -> biased solve (Y) -> integrate positions (Z) -> relaxed
solve (Y) -> joint colours (AA), a custom joint's ``solve``, velocity
projection and joint damping (AA)] -> swept CCD (Kernel AB) -> restitution
(Y) -> store impulses and joint forces -> writeback and force clear (Kernel
K's 2D pass) -> sleeping (island labels and the sleep update by Kernel J,
the update with the scalar angular speed) -> NaN quarantine. As in the
reference, there is no all-asleep early-out in 2D.

``hooks`` and ``custom_joints`` are the user's objects, called as the
reference calls them, on the port's tensors. When no joint is active the
joint stages are skipped (``dim2/xpbd.py`` says why that changes no bit but
the sign of a zero). A sleeping dynamic body with a force, torque, constant
force or constant torque is woken before the step (``wake_pushed``), where
the reference keeps it asleep and loses the push (ROADMAP 3b).
"""

from typing import NamedTuple

import torch

from avian_tpu_torch.core import types
from avian_tpu_torch.core.config import PhysicsConfig
from avian_tpu_torch.dim2 import broadphase as bp_m
from avian_tpu_torch.dim2 import ccd as ccd_m
from avian_tpu_torch.dim2 import contacts as np_m
from avian_tpu_torch.dim2 import dynamics as dyn_m
from avian_tpu_torch.dim2 import solver as sol_m
from avian_tpu_torch.dim2 import xpbd as xpbd_m
from avian_tpu_torch.dim2.state import World2D
from avian_tpu_torch.kernels import islands as kj
from avian_tpu_torch.pipeline.sleeping import compute_islands


def pushed_sleepers(bodies) -> torch.Tensor:
    """bool[N]: sleeping dynamic bodies with a force, torque, constant force
    or constant torque written to them. The reference integrates no sleeping
    body, and nothing wakes them, so the push is lost; the intended
    behaviour (a write wakes the body) is that they wake (ROADMAP 3b)."""
    b = bodies
    dyn = b.active & (b.body_type == types.BodyType.DYNAMIC)
    pushed = ((b.force != 0.0).any(-1) | (b.torque != 0.0) | (b.const_force != 0.0).any(-1)
              | (b.const_torque != 0.0))
    return dyn & b.sleeping & pushed


def wake_pushed(world: World2D) -> World2D:
    """Wake ``pushed_sleepers``: sleeping false, sleep timer reset."""
    b = world.bodies
    pushed = pushed_sleepers(b)
    return world.replace(bodies=b.replace(
        sleeping=b.sleeping & ~pushed, sleep_timer=torch.where(pushed, 0.0, b.sleep_timer)))


def update_sleeping(bodies, contacts, joints, config: PhysicsConfig):
    """Sleep timers, the island all-ready reduction, waking and velocity
    zeroing (reference ``_update_sleeping`` :160): island labels by Kernel J,
    the update by its 2D pass."""
    island, overflow = compute_islands(bodies, contacts, joints)
    if not config.sleeping_enabled:
        return bodies.replace(island=island)
    lin_t = config.sleep_linear_threshold * config.length_unit
    ang_t = config.sleep_angular_threshold
    params = kj.SleepParams(lin_t * lin_t, ang_t * ang_t, config.dt, config.time_to_sleep)
    sleep, timer, lin_vel, ang_vel = kj.sleep_update_2d(bodies, island, overflow, params)
    return bodies.replace(sleeping=sleep, sleep_timer=timer, island=island, lin_vel=lin_vel,
                          ang_vel=ang_vel)


def _filtered(bp: bp_m.BroadPhaseResult2D, valid) -> bp_m.BroadPhaseResult2D:
    """The pairs with ``hooks.filter_pairs``'s mask (reference :41-51): an
    invalid slot's key becomes -1 and the pairs are counted again."""
    return bp_m.BroadPhaseResult2D(
        collider_a=bp.collider_a, collider_b=bp.collider_b,
        pair_key=torch.where(valid, bp.pair_key, -1), valid=valid,
        num_pairs=valid.sum().to(torch.int32), dropped=bp.dropped,
    )


class Substepped(NamedTuple):
    """A step up to the swept CCD: the world with this step's AABBs, its
    poses, pairs and contacts, the solver state after the substeps, and the
    contact and joint constraints (``jcon`` is None when no joint is
    active) and a custom joint's data."""

    world: World2D
    poses: bp_m.Poses2D
    bp: bp_m.BroadPhaseResult2D
    contacts: object
    s: dyn_m.SolverState2D
    con: sol_m.ContactConstraints2D
    jcon: object
    cdata: object


def substepped(world: World2D, config: PhysicsConfig, hooks=None,
               custom_joints=None) -> Substepped:
    """Collision detection, the prepare and the substep loop of one step
    (reference :35-85)."""
    h = config.substep_dt
    poses = bp_m.collider_poses(world)
    world = bp_m.update_aabbs(world, config, poses)
    bp = bp_m.broad_phase(world, config)
    if hooks is not None and hasattr(hooks, "filter_pairs"):
        bp = _filtered(bp, hooks.filter_pairs(world, bp.collider_a, bp.collider_b, bp.valid))
    contacts = np_m.narrow_phase(world, bp, config, poses)
    if hooks is not None and hasattr(hooks, "modify_contacts"):
        contacts = hooks.modify_contacts(world, contacts)

    s, table = dyn_m.prepare(world.bodies, world.gravity, h)
    con = sol_m.prepare_constraints(world, contacts, s, config)
    joints = world.joints
    has_joints = joints.capacity > 0 and bool(joints.active.any())
    jcon = xpbd_m.prepare_joints(world, s, poses, config) if has_joints else None
    cdata = custom_joints.prepare(world, s, config) if custom_joints is not None else None
    for _ in range(config.substeps):
        s = dyn_m.integrate_velocities(s, table, h)
        s = sol_m.warm_start(s, con, config)
        s, con = sol_m.solve_pass(s, con, True, config)
        s = dyn_m.integrate_positions(s, table, h)
        s, con = sol_m.solve_pass(s, con, False, config)
        if has_joints or custom_joints is not None:
            s, cdata = xpbd_m.solve_position_constraints(s, jcon, h, config, custom_joints,
                                                         cdata)
    return Substepped(world, poses, bp, contacts, s, con, jcon, cdata)


def _core(world: World2D, config: PhysicsConfig, hooks, custom_joints):
    world, poses, bp, contacts, s, con, jcon, _ = substepped(world, config, hooks,
                                                             custom_joints)
    if config.swept_ccd:
        s = ccd_m.solve_swept_ccd_2d(world, s, poses, config)
    s, con = sol_m.solve_restitution(s, con, config)
    contacts = sol_m.store_impulses(contacts, con)
    joints = world.joints
    if jcon is not None:
        joints = xpbd_m.store_joint_forces(joints, jcon, config)
    elif joints.capacity > 0:
        # What the reference stores when no joint is solved.
        joints = joints.replace(total_lambda=torch.zeros_like(joints.total_lambda),
                                color=torch.full_like(joints.color, -1))
    bodies = dyn_m.writeback(world.bodies, s)
    bodies = update_sleeping(bodies, contacts, joints, config)
    new_world = world.replace(bodies=bodies, contacts=contacts, joints=joints,
                              time=world.time + config.dt)
    return new_world, bp, con


def physics_step_2d(world: World2D, config: PhysicsConfig, return_diagnostics=False,
                    hooks=None, custom_joints=None):
    """Advance the 2D world by ``config.dt`` seconds. ``hooks`` (an object
    with ``filter_pairs(world, collider_a, collider_b, valid) -> valid`` and
    or ``modify_contacts(world, contacts) -> contacts``) and
    ``custom_joints`` (``dim2/custom.py``) are called as the reference calls
    them."""
    start = wake_pushed(world) if config.sleeping_enabled else world
    new_world, bp, con = _core(start, config, hooks, custom_joints)
    dev = world.device
    nonfinite = torch.zeros((), dtype=torch.int32, device=dev)
    if config.nan_guard:
        b = new_world.bodies
        bad = ~(torch.isfinite(b.pos).all(-1) & torch.isfinite(b.angle)
                & torch.isfinite(b.lin_vel).all(-1) & torch.isfinite(b.ang_vel)) & b.active
        nonfinite = bad.sum().to(torch.int32)
        if int(nonfinite) != 0:
            # Quarantine: freeze the world as it was, flagged diverged.
            new_world = world.replace(
                time=world.time + config.dt,
                diverged=torch.ones((), dtype=torch.bool, device=dev),
            )
    if not return_diagnostics:
        return new_world
    b, c = new_world.bodies, new_world.contacts
    lanes = torch.arange(c.penetration.shape[1], device=dev)[None, :]
    return new_world, {
        "num_pairs": bp.num_pairs,
        "dropped_pairs": bp.dropped,
        "overflow_dropped": con.overflow_dropped,
        "num_overflow": con.num_overflow,
        "num_touching": c.touching.sum().to(torch.int32),
        "num_sleeping": b.sleeping.sum().to(torch.int32),
        "nonfinite_bodies": nonfinite,
        "diverged": new_world.diverged,
        "max_penetration": torch.where(
            c.touching[:, None] & (lanes < c.num_points[:, None]), c.penetration, 0.0
        ).max(),
    }


def rollout_2d(world: World2D, config: PhysicsConfig, num_steps: int) -> World2D:
    """Run ``num_steps`` steps."""
    for _ in range(num_steps):
        world = physics_step_2d(world, config)
    return world
