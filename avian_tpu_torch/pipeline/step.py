"""One physics step (port of ``avian_tpu/pipeline/step.py``).

Staged like the reference: update_aabbs -> broadphase -> narrowphase ->
prepare (solver bodies, velocity increments, contact constraints with
coloring) -> substeps [integrate velocities -> warm start -> biased solve
-> integrate positions -> relax solve] -> restitution -> store impulses
-> writeback -> force clear -> sleeping -> NaN quarantine.

The slice covers box/box and box/plane worlds without joints. The step
raises ``NotImplementedError`` for an active joint, ``config.swept_ccd``,
``hooks``, ``custom_joints`` or ``custom_shapes``, and the narrowphase
raises for any other shape pair; nothing is skipped silently.
"""

from dataclasses import dataclass

import torch

from avian_tpu_torch.core import types
from avian_tpu_torch.core.config import PhysicsConfig
from avian_tpu_torch.core.state import Contacts, World
from avian_tpu_torch.pipeline import broadphase as bp_m
from avian_tpu_torch.pipeline import contacts as np_m
from avian_tpu_torch.pipeline import integrator as int_m
from avian_tpu_torch.pipeline import sleeping as sleep_m
from avian_tpu_torch.pipeline import solver as sol_m
from avian_tpu_torch.pipeline import solver_body as sb_m


@dataclass(frozen=True)
class Prepared:
    """What the substep loop needs, built once per step."""

    world: World                       # world with this step's AABBs
    contacts: Contacts
    s: sb_m.SolverState
    table: torch.Tensor                # Kernel C's per-body constants
    con: sol_m.ContactConstraints
    num_pairs: torch.Tensor
    dropped: torch.Tensor
    manifold_pairs: dict               # Kernel A kind -> pairs launched on


def _check_supported(world, config, hooks, custom_joints, custom_shapes):
    if hooks is not None:
        raise NotImplementedError("collision hooks are not ported yet")
    if custom_joints is not None:
        raise NotImplementedError("custom joints are not ported yet")
    if custom_shapes:
        raise NotImplementedError("custom shapes are not ported yet")
    if config.swept_ccd:
        raise NotImplementedError("swept CCD is not ported yet")
    if world.joints.capacity > 0 and bool(world.joints.active.any()):
        raise NotImplementedError("joints are not ported yet")


def prepare_step(world: World, config: PhysicsConfig) -> Prepared:
    """Collision detection and the per-step preparation of the solver."""
    h = config.substep_dt
    world2 = bp_m.update_aabbs(world, config)
    bp = bp_m.broad_phase(world2, config)
    contacts, sizes = np_m.narrow_phase(world2, bp, config)
    s = sb_m.prepare(world2.bodies)
    inc = int_m.pre_process_velocity_increments(world2.bodies, world2.gravity, h)
    table = int_m.integration_table(world2.bodies, inc)
    con = sol_m.prepare_constraints(world2, contacts, s, config)
    return Prepared(world2, contacts, s, table, con, bp.num_pairs, bp.dropped, sizes)


def _core(world: World, config: PhysicsConfig):
    h = config.substep_dt
    p = prepare_step(world, config)
    s, con = p.s, p.con
    for _ in range(config.substeps):
        s = int_m.integrate_velocities(s, p.table, h)
        s = sol_m.warm_start(s, con, config)
        s, con = sol_m.solve_pass(s, con, True, config)
        s = int_m.integrate_positions(s, p.table, h)
        s, con = sol_m.solve_pass(s, con, False, config)
    s, con = sol_m.solve_restitution(s, con, config)
    contacts = sol_m.store_impulses(p.contacts, con)
    bodies = sb_m.writeback(p.world.bodies, s)
    z3 = torch.zeros_like(bodies.force)
    bodies = bodies.replace(force=z3, torque=z3)
    bodies = sleep_m.update_sleeping(bodies, contacts, p.world.joints, config)
    new_world = p.world.replace(
        bodies=bodies, contacts=contacts, time=p.world.time + config.dt
    )
    num_points = torch.where(contacts.touching, contacts.num_points, 0).sum()
    stats = {
        "num_pairs": p.num_pairs,
        "dropped_pairs": p.dropped,
        "overflow_dropped": con.overflow_dropped,
        "num_overflow": con.num_overflow,
        "num_contact_points": num_points,
        "manifold_pairs": p.manifold_pairs,
    }
    return new_world, stats


def needs_step(world: World) -> torch.Tensor:
    """bool[]: some body can move this step (the all-asleep early-out's
    predicate, reference step.py:195-216). Besides the reference's awake
    dynamic bodies, moving kinematic bodies and teleported sleepers, a
    velocity written to a sleeping dynamic body also counts: the reference
    skips that step and loses the write."""
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
            "manifold_pairs": {},
        }
        stepped = False
    else:
        new_world, stats = _core(world, config)
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
        # early-out) and the pairs each Kernel A launch covered.
        "stepped": stepped,
        "manifold_pairs": stats["manifold_pairs"],
    }
    return new_world, diagnostics


def rollout(world: World, config: PhysicsConfig, num_steps: int) -> World:
    """Run ``num_steps`` steps."""
    for _ in range(num_steps):
        world = physics_step(world, config)
    return world
