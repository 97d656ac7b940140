"""One 2D physics step (port of ``avian_tpu/dim2/step.py``).

Staged as the reference: poses and AABBs -> broadphase (Kernel U) ->
narrowphase (Kernels V, F's key join, W) -> prepare (solver bodies and
Kernel Z's table by Z's prologue, contact constraints: Kernels G and X) ->
substeps [integrate velocities (Z) -> warm start (Y) -> biased solve (Y) ->
integrate positions (Z) -> relaxed solve (Y)] -> restitution (Y) -> store
impulses -> writeback and force clear (Kernel K's 2D pass) -> sleeping
(island labels and the sleep update by Kernel J, the update with the scalar
angular speed) -> NaN quarantine. As in the reference, there is no all-asleep early-out in 2D.

The step raises ``NotImplementedError`` for what the port's 2D engine does
not run yet: a world with an active joint, ``config.swept_ccd``, ``hooks``
and ``custom_joints``.
"""

import torch

from avian_tpu_torch.core.config import PhysicsConfig
from avian_tpu_torch.dim2 import broadphase as bp_m
from avian_tpu_torch.dim2 import contacts as np_m
from avian_tpu_torch.dim2 import dynamics as dyn_m
from avian_tpu_torch.dim2 import solver as sol_m
from avian_tpu_torch.dim2.state import World2D
from avian_tpu_torch.kernels import islands as kj
from avian_tpu_torch.pipeline.sleeping import compute_islands


def _check_supported(world: World2D, config: PhysicsConfig, hooks, custom_joints):
    if hooks is not None:
        raise NotImplementedError("2D collision hooks are not ported yet")
    if custom_joints is not None:
        raise NotImplementedError("2D custom joints are not ported yet")
    if config.swept_ccd:
        raise NotImplementedError("2D swept CCD is not ported yet")
    if world.joints.capacity > 0 and bool(world.joints.active.any()):
        raise NotImplementedError("2D joints are not ported yet")


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


def _core(world: World2D, config: PhysicsConfig):
    h = config.substep_dt
    poses = bp_m.collider_poses(world)
    world = bp_m.update_aabbs(world, config, poses)
    bp = bp_m.broad_phase(world, config)
    contacts = np_m.narrow_phase(world, bp, config, poses)

    s, table = dyn_m.prepare(world.bodies, world.gravity, h)
    con = sol_m.prepare_constraints(world, contacts, s, config)
    for _ in range(config.substeps):
        s = dyn_m.integrate_velocities(s, table, h)
        s = sol_m.warm_start(s, con, config)
        s, con = sol_m.solve_pass(s, con, True, config)
        s = dyn_m.integrate_positions(s, table, h)
        s, con = sol_m.solve_pass(s, con, False, config)
    s, con = sol_m.solve_restitution(s, con, config)
    contacts = sol_m.store_impulses(contacts, con)
    bodies = dyn_m.writeback(world.bodies, s)
    bodies = update_sleeping(bodies, contacts, world.joints, config)
    new_world = world.replace(bodies=bodies, contacts=contacts, time=world.time + config.dt)
    return new_world, bp, con


def physics_step_2d(world: World2D, config: PhysicsConfig, return_diagnostics=False,
                    hooks=None, custom_joints=None):
    """Advance the 2D world by ``config.dt`` seconds."""
    _check_supported(world, config, hooks, custom_joints)
    new_world, bp, con = _core(world, config)
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
