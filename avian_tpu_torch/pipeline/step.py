"""One physics step (port of ``avian_tpu/pipeline/step.py``).

Staged like the reference: update_aabbs -> broadphase -> narrowphase ->
prepare (solver bodies, velocity increments, contact constraints with
coloring, joints) -> substeps [integrate velocities -> warm start -> biased
solve -> integrate positions -> relax solve -> XPBD joints -> joint
damping] -> restitution -> store impulses and joint forces -> writeback and
force clear -> sleeping -> NaN quarantine.

The slices cover worlds of spheres, capsules, boxes, cylinders, cones,
segments, half-spaces, pool-backed convex shapes (convex hulls, round
cuboids, and the triangles of trimeshes and heightfields) and user shapes
(``api/custom_shapes.py``), with joints of all five types, user constraints
(``custom_joints``, ``api/custom.py``), collision hooks (``filter_pairs``
after the broadphase, ``modify_contacts`` after the narrowphase), and the
opt-in swept CCD pass (``config.swept_ccd``, ``pipeline/ccd.py``) after the
substeps. The narrowphase raises for any other shape code (TRIANGLE,
TRIMESH and HEIGHTFIELD written into a world directly); nothing is skipped
silently.
"""

from dataclasses import dataclass, fields

import torch

from avian_tpu_torch.api.custom_shapes import resolve as resolve_shapes
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
    custom_joints: object = None       # the user constraint, if any
    cdata: object = None               # its data from ``prepare``


def _filtered(bp: bp_m.BroadPhaseResult, valid) -> bp_m.BroadPhaseResult:
    """The pairs with ``hooks.filter_pairs``'s mask (reference :92-103): an
    invalid slot's key becomes -1 and the pairs are counted again."""
    return bp_m.BroadPhaseResult(
        collider_a=bp.collider_a, collider_b=bp.collider_b,
        pair_key=torch.where(valid, bp.pair_key, -1), valid=valid,
        num_pairs=valid.sum().to(torch.int32), dropped=bp.dropped,
    )


def prepare_step(world: World, config: PhysicsConfig, hooks=None, custom_joints=None,
                 custom_shapes=()) -> Prepared:
    """Collision detection and the per-step preparation of the solver, with
    the hooks, the user constraint's ``prepare`` and the custom shapes of
    ``physics_step``."""
    h = config.substep_dt
    world2, pos, quat = bp_m.update_aabbs_and_poses(world, config, custom_shapes)
    bp = bp_m.broad_phase(world2, config)
    if hooks is not None and hasattr(hooks, "filter_pairs"):
        bp = _filtered(bp, hooks.filter_pairs(world2, bp.collider_a, bp.collider_b, bp.valid))
    contacts, sizes = np_m.narrow_phase(world2, bp, config, (pos, quat), custom_shapes)
    if hooks is not None and hasattr(hooks, "modify_contacts"):
        contacts = hooks.modify_contacts(world2, contacts)
    s, table = sb_m.prepare_with_table(world2.bodies, world2.gravity, h)
    con = sol_m.prepare_constraints(world2, contacts, s, config)
    jcon = (xpbd_m.prepare_joints(world2, s, config)
            if world2.joints.capacity > 0 else None)
    cdata = custom_joints.prepare(world2, s, config) if custom_joints is not None else None
    return Prepared(world2, contacts, s, table, con, jcon, bp.num_pairs, bp.dropped, sizes,
                    (pos, quat), custom_joints, cdata)


def run_substeps(p: Prepared, config: PhysicsConfig):
    """The substep loop on a prepared step: ``(solver state, constraints)``."""
    h = config.substep_dt
    s, con, cdata = p.s, p.con, p.cdata
    for _ in range(config.substeps):
        s = int_m.integrate_velocities(s, p.table, h)
        s = sol_m.warm_start(s, con, config)
        s, con = sol_m.solve_pass(s, con, True, config)
        s = int_m.integrate_positions(s, p.table, h)
        s, con = sol_m.solve_pass(s, con, False, config)
        if p.jcon is not None or p.custom_joints is not None:
            s, cdata = xpbd_m.solve_with_custom(s, p.jcon, h, config, p.custom_joints, cdata)
    return s, con


def _core(world: World, config: PhysicsConfig, hooks, custom_joints, custom_shapes):
    """The full step after the early-out and before the quarantine:
    ``(new world, stats)``, the counts among the stats per scene (i32[B],
    B = ``World.scene_count``)."""
    p = prepare_step(world, config, hooks, custom_joints, custom_shapes)
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
    scenes = world.scene_count
    points = torch.where(contacts.touching, contacts.num_points, 0)
    overflow_dropped, num_overflow = sol_m.overflow_by_scene(con, scenes)
    stats = {
        "num_pairs": p.num_pairs.reshape(scenes),
        "dropped_pairs": p.dropped.reshape(scenes),
        "overflow_dropped": overflow_dropped,
        "num_overflow": num_overflow,
        "num_contact_points": _by_scene(points, scenes).sum(dim=1),
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


def can_move(b) -> torch.Tensor:
    """bool[N]: the bodies that can move this step; the all-asleep
    early-out is taken when none can (reference step.py:195-216). Besides
    the reference's awake dynamic bodies, moving kinematic bodies and
    teleported sleepers, a velocity written to a sleeping dynamic body also
    counts, and so does a sleeping dynamic body with a force or torque
    (``pushed_sleepers``): the reference skips that step and loses the
    write."""
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
    )


def _by_scene(x, scenes: int):
    """``x`` [B·K, ...] as [B, K·...]: one row of each scene's entries."""
    return x.reshape(scenes, x.numel() // scenes)


def _pick(keep, new, old):
    """Per scene, ``new`` where ``keep`` bool[B] else ``old``: columns of B
    scenes [B·K, ...], or the world's own leaves (0-d for a world, [B])."""
    if new is old:
        return new
    b = keep.shape[0]
    shaped = new.reshape(b, new.shape[0] // b if new.dim() else 1, *new.shape[1:])
    k = keep.reshape(b, *([1] * (shaped.dim() - 1)))
    return torch.where(k, shaped, old.reshape(shaped.shape)).reshape(new.shape)


def _pick_world(keep, new: World, old: World) -> World:
    def group(name):
        g_new, g_old = getattr(new, name), getattr(old, name)
        return g_new.replace(**{f.name: _pick(keep, getattr(g_new, f.name), getattr(g_old, f.name))
                                for f in fields(g_new)})

    return new.replace(
        bodies=group("bodies"), colliders=group("colliders"), contacts=group("contacts"),
        joints=group("joints"), time=_pick(keep, new.time, old.time),
        diverged=_pick(keep, new.diverged, old.diverged),
    )


def step_scenes(world: World, config: PhysicsConfig, return_diagnostics=False, hooks=None,
                custom_joints=None, custom_shapes=()):
    """One step of the B = ``World.scene_count`` scenes of ``world`` (B = 1
    for a world; the flat world of ``parallel.make_batched_step``): the new
    world, or ``(world, diagnostics)`` with each diagnostic shaped as
    ``world.time``. The early-out and the NaN quarantine are per scene, as
    ``jax.vmap`` of the reference gives them: a scene with no body that can
    move gets the early-out's result (forces cleared, ``time + dt``, nothing
    else touched) while others step, and a scene with a non-finite body is
    frozen as it was, flagged ``diverged``. One host read decides the
    shortcut of a world whose every scene sleeps; the quarantine reads
    nothing."""
    b = world.scene_count
    n = world.bodies.capacity // b
    dev = world.device
    early = config.sleeping_enabled and config.sleep_early_out
    stepped = (can_move(world.bodies).reshape(b, n).any(dim=1) if early
               else torch.ones((b,), dtype=torch.bool, device=dev))
    ran = not early or bool(stepped.any())
    if ran:
        core, stats = _core(wake_pushed(world) if config.sleeping_enabled else world,
                            config, hooks, custom_joints, custom_shapes)

    old = world.bodies
    zero = torch.zeros((b,), dtype=torch.int32, device=dev)
    nonfinite = zero
    if config.nan_guard:
        src = core.bodies if ran else old
        moved = [_pick(stepped, getattr(src, k), getattr(old, k))
                 for k in ("pos", "quat", "lin_vel", "ang_vel")]
        finite = torch.stack([torch.isfinite(x).all(-1) for x in moved]).all(0)
        nonfinite = (~finite & old.active).reshape(b, n).sum(dim=1).to(torch.int32)
    bad = nonfinite > 0
    # The early-out's result, or the quarantine's: forces cleared where the
    # scene skipped, kept where it froze; time advances either way.
    z3 = torch.zeros_like(old.force)
    rest = world.replace(
        bodies=old.replace(force=_pick(bad, old.force, z3), torque=_pick(bad, old.torque, z3)),
        time=world.time + config.dt, diverged=world.diverged | bad.reshape(world.diverged.shape),
    )
    out = _pick_world(stepped & ~bad, core, rest) if ran else rest
    if not return_diagnostics:
        return out

    def ran_step(key):
        return torch.where(stepped, stats[key], 0).to(torch.int32) if ran else zero

    c = out.contacts
    lanes = torch.arange(c.penetration.shape[1], device=dev)[None, :]
    penetration = torch.where(c.touching[:, None] & (lanes < c.num_points[:, None]),
                              c.penetration, 0.0)
    diagnostics = {
        "num_pairs": ran_step("num_pairs"),
        "dropped_pairs": ran_step("dropped_pairs"),
        "overflow_dropped": ran_step("overflow_dropped"),
        "num_overflow": ran_step("num_overflow"),
        "num_touching": _by_scene(c.touching, b).sum(dim=1).to(torch.int32),
        "num_contact_points": ran_step("num_contact_points"),
        "num_sleeping": _by_scene(out.bodies.sleeping, b).sum(dim=1).to(torch.int32),
        "nonfinite_bodies": nonfinite,
        "diverged": out.diverged,
        "max_penetration": _by_scene(penetration, b).amax(dim=1),
    }
    diagnostics = {k: v.reshape(world.time.shape) for k, v in diagnostics.items()}
    # Port-only: whether the full step ran (False = the all-asleep early-out;
    # a world's is the host's branch, B scenes' bool[B]), the pairs each
    # narrowphase launch and each swept-CCD launch covered over the world,
    # by canonical shape pair, and the colliders swept.
    diagnostics.update(
        stepped=stepped if world.time.dim() else ran,
        manifold_pairs=stats["manifold_pairs"] if ran else {},
        swept_pairs=stats["swept_pairs"] if ran else {},
        swept_colliders=stats["swept_colliders"] if ran else 0,
    )
    return out, diagnostics


def physics_step(world: World, config: PhysicsConfig, return_diagnostics=False,
                 hooks=None, custom_joints=None, custom_shapes=()):
    """Advance the world by ``config.dt`` seconds (``step_scenes`` of one
    scene). ``hooks`` (an object with ``filter_pairs(world, collider_a,
    collider_b, valid) -> valid`` and or ``modify_contacts(world, contacts)
    -> contacts``), ``custom_joints`` (``api/custom.py``) and
    ``custom_shapes`` (a tuple of ``CustomShape``, which takes precedence
    over ``world.custom_shapes``) are used as the reference uses them."""
    if world.scene_count != 1:
        raise ValueError("physics_step: a batched world (gravity [B, 3]); step it with "
                         "avian_tpu_torch.parallel.make_batched_step")
    return step_scenes(world, config, return_diagnostics, hooks, custom_joints,
                       resolve_shapes(world, custom_shapes))


def rollout(world: World, config: PhysicsConfig, num_steps: int) -> World:
    """Run ``num_steps`` steps."""
    for _ in range(num_steps):
        world = physics_step(world, config)
    return world
