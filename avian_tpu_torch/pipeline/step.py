"""One physics step (port of ``avian_tpu/pipeline/step.py``).

Staged like the reference: update_aabbs -> broadphase -> narrowphase ->
prepare (solver bodies, velocity increments, contact constraints with
coloring, joints) -> substeps [integrate velocities -> warm start -> biased
solve -> integrate positions -> relax solve -> XPBD joints -> joint
damping] -> restitution -> store impulses and joint forces -> writeback and
force clear -> sleeping -> NaN quarantine.

The slices cover worlds of spheres, capsules, boxes, cylinders, cones,
segments, half-spaces and pool-backed convex shapes (convex hulls, round
cuboids, and the triangles of trimeshes and heightfields), with joints of
all five types, and the opt-in swept CCD pass (``config.swept_ccd``,
``pipeline/ccd.py``) after the substeps. The step raises
``NotImplementedError`` for ``hooks``, ``custom_joints`` or
``custom_shapes``, and
the narrowphase raises for any other shape code (TRIANGLE, TRIMESH and
HEIGHTFIELD written into a world directly); nothing is skipped silently.
"""

from dataclasses import dataclass

import torch

from avian_tpu_torch.core import types
from avian_tpu_torch.core.config import PhysicsConfig
from avian_tpu_torch.core.state import Contacts, World
from avian_tpu_torch.pipeline import broadphase as bp_m
from avian_tpu_torch.pipeline import ccd as ccd_m
from avian_tpu_torch.pipeline import contacts as np_m
from avian_tpu_torch.pipeline import integrator as int_m
from avian_tpu_torch.pipeline import sleeping as sleep_m
from avian_tpu_torch.pipeline import solver as sol_m
from avian_tpu_torch.pipeline import solver_body as sb_m
from avian_tpu_torch.pipeline import xpbd as xpbd_m


@dataclass(frozen=True)
class Prepared:
    """What the substep loop needs, built once per step."""

    world: World                       # world with this step's AABBs
    contacts: Contacts
    s: sb_m.SolverState
    table: torch.Tensor                # Kernel C's per-body constants
    con: sol_m.ContactConstraints
    jcon: xpbd_m.JointConstraints | None  # None for a world without joint slots
    num_pairs: torch.Tensor
    dropped: torch.Tensor
    manifold_pairs: dict               # canonical shape pair -> pairs launched on
    poses: tuple                       # collider (pos f32[M,3], quat f32[M,4]) at step start


def _check_supported(world, config, hooks, custom_joints, custom_shapes):
    if hooks is not None:
        raise NotImplementedError("collision hooks are not ported yet")
    if custom_joints is not None:
        raise NotImplementedError("custom joints are not ported yet")
    if custom_shapes:
        raise NotImplementedError("custom shapes are not ported yet")


def prepare_step(world: World, config: PhysicsConfig) -> Prepared:
    """Collision detection and the per-step preparation of the solver."""
    h = config.substep_dt
    world2, pos, quat = bp_m.update_aabbs_and_poses(world, config)
    bp = bp_m.broad_phase(world2, config)
    contacts, sizes = np_m.narrow_phase(world2, bp, config, poses=(pos, quat))
    s, table = sb_m.prepare_with_table(world2.bodies, world2.gravity, h)
    con = sol_m.prepare_constraints(world2, contacts, s, config)
    jcon = (xpbd_m.prepare_joints(world2, s, config)
            if world2.joints.capacity > 0 else None)
    return Prepared(world2, contacts, s, table, con, jcon, bp.num_pairs, bp.dropped, sizes,
                    (pos, quat))


def run_substeps(p: Prepared, config: PhysicsConfig):
    """The substep loop on a prepared step: ``(solver state, constraints)``."""
    h = config.substep_dt
    s, con = p.s, p.con
    for _ in range(config.substeps):
        s = int_m.integrate_velocities(s, p.table, h)
        s = sol_m.warm_start(s, con, config)
        s, con = sol_m.solve_pass(s, con, True, config)
        s = int_m.integrate_positions(s, p.table, h)
        s, con = sol_m.solve_pass(s, con, False, config)
        if p.jcon is not None:
            s = xpbd_m.solve_position_constraints(s, p.jcon, h, config)
    return s, con


def _core(world: World, config: PhysicsConfig):
    p = prepare_step(world, config)
    s, con = run_substeps(p, config)
    swept, n_swept = {}, 0
    if config.swept_ccd:
        s, grid = ccd_m.solve_swept_ccd(p.world, s, *p.poses, config)
        swept = {pair: flat.shape[0] for pair, flat in grid.buckets}
        n_swept = grid.k_ok
    s, con = sol_m.solve_restitution(s, con, config)
    contacts = sol_m.store_impulses(p.contacts, con)
    joints = p.world.joints
    if p.jcon is not None:
        joints = xpbd_m.store_joint_forces(joints, p.jcon, config)
    bodies = sb_m.writeback(p.world.bodies, s)  # also clears force and torque
    bodies = sleep_m.update_sleeping(bodies, contacts, joints, config)
    new_world = p.world.replace(
        bodies=bodies, contacts=contacts, joints=joints, time=p.world.time + config.dt
    )
    num_points = torch.where(contacts.touching, contacts.num_points, 0).sum()
    stats = {
        "num_pairs": p.num_pairs,
        "dropped_pairs": p.dropped,
        "overflow_dropped": con.overflow_dropped,
        "num_overflow": con.num_overflow,
        "num_contact_points": num_points,
        "manifold_pairs": p.manifold_pairs,
        "swept_pairs": swept,
        "swept_colliders": n_swept,
    }
    return new_world, stats


def pushed_sleepers(bodies) -> torch.Tensor:
    """bool[N]: sleeping dynamic bodies with a force, torque, constant force
    or constant torque written to them. The reference skips the step when
    every body sleeps and keeps them asleep, so the push is lost; the
    intended behaviour (``avian_tpu/api/forces.py:8-10``: a write wakes the
    body) is that they wake (ROADMAP 3b)."""
    b = bodies
    dyn = b.active & (b.body_type == types.BodyType.DYNAMIC)
    pushed = ((b.force != 0.0).any(-1) | (b.torque != 0.0).any(-1)
              | (b.const_force != 0.0).any(-1) | (b.const_torque != 0.0).any(-1))
    return dyn & b.sleeping & pushed


def wake_pushed(world: World) -> World:
    """Wake ``pushed_sleepers``: sleeping false, sleep timer reset."""
    b = world.bodies
    pushed = pushed_sleepers(b)
    return world.replace(bodies=b.replace(
        sleeping=b.sleeping & ~pushed, sleep_timer=torch.where(pushed, 0.0, b.sleep_timer)))


def needs_step(world: World) -> torch.Tensor:
    """bool[]: some body can move this step (the all-asleep early-out's
    predicate, reference step.py:195-216). Besides the reference's awake
    dynamic bodies, moving kinematic bodies and teleported sleepers, a
    velocity written to a sleeping dynamic body also counts, and so does a
    sleeping dynamic body with a force or torque (``pushed_sleepers``): the
    reference skips that step and loses the write."""
    b = world.bodies
    dyn = b.active & (b.body_type == types.BodyType.DYNAMIC)
    moving = (b.lin_vel != 0.0).any(-1) | (b.ang_vel != 0.0).any(-1)
    kin_moving = b.active & (b.body_type == types.BodyType.KINEMATIC) & moving
    teleported = b.sleeping & (
        (torch.abs(b.pos - b.sleep_pos) > 1e-6).any(-1)
        | (torch.abs(b.quat - b.sleep_quat) > 1e-6).any(-1)
    )
    return (
        (dyn & ~b.sleeping) | (dyn & b.sleeping & moving) | kin_moving | teleported
        | pushed_sleepers(b)
    ).any()


def physics_step(world: World, config: PhysicsConfig, return_diagnostics=False,
                 hooks=None, custom_joints=None, custom_shapes=()):
    """Advance the world by ``config.dt`` seconds."""
    _check_supported(world, config, hooks, custom_joints, custom_shapes)
    # The early-out is a host-side branch on one device-to-host read; the
    # rest of the step reads counts to the host as well (compaction and
    # pair buckets), so this costs no extra synchronisation in kind.
    if config.sleeping_enabled and config.sleep_early_out and not bool(needs_step(world)):
        z3 = torch.zeros_like(world.bodies.force)
        new_world = world.replace(
            bodies=world.bodies.replace(force=z3, torque=z3),
            time=world.time + config.dt,
        )
        zero = torch.zeros((), dtype=torch.int32, device=world.device)
        stats = {
            "num_pairs": zero, "dropped_pairs": zero, "overflow_dropped": zero,
            "num_overflow": zero, "num_contact_points": zero,
            "manifold_pairs": {}, "swept_pairs": {}, "swept_colliders": 0,
        }
        stepped = False
    else:
        new_world, stats = _core(wake_pushed(world) if config.sleeping_enabled else world,
                                 config)
        stepped = True

    nonfinite = torch.zeros((), dtype=torch.int32, device=world.device)
    if config.nan_guard:
        b = new_world.bodies
        bad = ~(
            torch.isfinite(b.pos).all(-1) & torch.isfinite(b.quat).all(-1)
            & torch.isfinite(b.lin_vel).all(-1) & torch.isfinite(b.ang_vel).all(-1)
        ) & b.active
        nonfinite = bad.sum().to(torch.int32)
        if int(nonfinite) != 0:
            # Quarantine: freeze the world as it was, flagged diverged.
            new_world = world.replace(
                time=world.time + config.dt,
                diverged=torch.ones((), dtype=torch.bool, device=world.device),
            )

    if not return_diagnostics:
        return new_world
    b = new_world.bodies
    c = new_world.contacts
    lanes = torch.arange(c.penetration.shape[1], device=world.device)[None, :]
    diagnostics = {
        "num_pairs": stats["num_pairs"],
        "dropped_pairs": stats["dropped_pairs"],
        "overflow_dropped": stats["overflow_dropped"],
        "num_overflow": stats["num_overflow"],
        "num_touching": c.touching.sum().to(torch.int32),
        "num_contact_points": stats["num_contact_points"],
        "num_sleeping": b.sleeping.sum().to(torch.int32),
        "nonfinite_bodies": nonfinite,
        "diverged": new_world.diverged,
        "max_penetration": torch.where(
            c.touching[:, None] & (lanes < c.num_points[:, None]), c.penetration, 0.0
        ).max(),
        # Port-only: whether the full step ran (False = all-asleep
        # early-out), the pairs each narrowphase launch and each swept-CCD
        # launch covered, by canonical shape pair, and the colliders swept.
        "stepped": stepped,
        "manifold_pairs": stats["manifold_pairs"],
        "swept_pairs": stats["swept_pairs"],
        "swept_colliders": stats["swept_colliders"],
    }
    return new_world, diagnostics


def rollout(world: World, config: PhysicsConfig, num_steps: int) -> World:
    """Run ``num_steps`` steps."""
    for _ in range(num_steps):
        world = physics_step(world, config)
    return world
