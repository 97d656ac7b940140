"""Where one full step of the port spends its time on a CUDA card.

    python3 profile_step.py [--scene pile|pyramid|hinges|shapes|terrain|terrain_ccd|
                                     batched|pyramid2d|many_pyramids2d|hinges2d|pyramid_ccd2d]
                            [--out profile.json]

Settles the scene with the smoke's config for 30 steps (40 for ``shapes``
and ``terrain``, 2 for ``terrain_ccd``),
so that it is awake and its contacts are warm: ``pile`` is
``cube_pile(10_000)`` with 160,000 contact slots, ``pyramid`` is
``box_pyramid(base=100)`` (5,050 boxes, the 2D profile) with 24 slots per
body, 121,224, ``hinges`` is ``falling_hinges(30, 334)`` (10,020 boxes, 9,990
revolute joints) with 16 slots per body, 160,336, ``shapes`` is
``many_shapes(10_000, per_row=48)`` (spheres, boxes, capsules, cylinders and
cones, five layers of 48 x 48) with 16 slots per body, 160,016, and its 20
shape pairs, ``terrain`` is ``terrain_shapes(10_000, per_row=48)`` (those
shapes, rocks and round cuboids over a heightfield of 8,192 triangles) with
24 slots per body, 240,000, its 21 shape pairs and a sweep window of 64,
and ``terrain_ccd`` is ``terrain_ccd(10_000, per_row=48)`` (that terrain and
32 bullets fired down into it at 300 m/s, 24 slots per body) with the
terrain's config and swept CCD, two steps in: the bullets are 2 m above the
pile and the field, and meet them in the measured steps. ``pyramid2d`` is
the native 2D engine's ``box_pyramid_2d(100)`` (5,050 boxes) and
``many_pyramids2d`` its ``many_pyramids_2d(10, 10)`` (5,500 boxes), both with
24 slots per body and ``PhysicsConfig(substeps=4, max_colors=8)``, stepped by
``dim2.physics_step_2d``; ``hinges2d`` is ``hinge_blocks_2d(84)`` (10,080
boxes, 7,560 revolute joints) with 16 slots per body and
``pyramid_ccd2d`` is ``pyramid_ccd_2d(100, 32)`` (the base-100 2D pyramid
and 32 bullets fired down at 300 m/s, 24 slots per body) with swept CCD, two
steps in: the bullets are 2 m above the apex and meet the pyramid in the
measured steps. ``batched`` is the reference bench's batched scene: 4,096
copies of ``cube_pile(27)`` with 216 slots each and gravity jittered by 1 +
0.1 N(0, 1) (seed 0), ``PhysicsConfig(substeps=4, max_colors=4,
sap_window=8)`` and box pairs, stepped by ``parallel.make_batched_step``;
its stages are timed on the flat world the batched step runs (114,688
bodies, 884,736 slots). Then it measures from
that state:

- ``stage_ms``: each stage of ``physics_step`` on the host clock, the card
  synchronized after every stage, mean of 3 steps (solver and integration
  stages summed over the substeps; ``ccd`` is the swept-CCD pass, Kernel R
  and its prologue, with ``swept_ccd`` on); for a 2D scene the stages are
  broadphase (Kernel U with L's slots and finish), narrowphase (V, F's
  join, W), prepare (Z's prologue, G, X), prepare joints (AA's rows, G),
  substeps (Z and Y), joints (AA's colours and velocities), ccd (the
  prologue and Kernel AB), restitution (Y), store+writeback (the impulses'
  store, K's 2D writeback) and sleeping (J's labels and 2D sleep update);
- ``narrowphase_split_ms`` (3D scenes): the narrowphase's manifold kernels
  (A, M, N, O, P, Q) on the same state, each the sum of its shape-pair buckets, and the
  bucketing before them, mean of 3; the rest of the stage ``narrowphase``
  is the persistence join and Kernel F;
- ``step_wall_ms``: 5 whole steps, synchronized around each;
- ``profile``: ``torch.profiler`` over 3 steps: the card's busy time (the
  sum of its kernels' times), the share of the profiled wall time it was
  idle, and the largest kernels. The profiler slows the host, so that
  share is higher than without it.

Prints the card's name and power limit and one JSON object, and writes the
object to ``--out`` if given. Needs a CUDA card; imports nothing of JAX.
"""

import argparse
import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from avian_tpu_torch import PhysicsConfig, physics_step, scenes
from avian_tpu_torch.core.types import ShapeType
from avian_tpu_torch.dim2 import broadphase as bp2
from avian_tpu_torch.dim2 import ccd as ccd2
from avian_tpu_torch.dim2 import contacts as nc2
from avian_tpu_torch.dim2 import dynamics as dyn2
from avian_tpu_torch.dim2 import physics_step_2d
from avian_tpu_torch.dim2 import scenes as scenes2d
from avian_tpu_torch.dim2 import solver as sol2
from avian_tpu_torch.dim2 import xpbd as xpbd2
from avian_tpu_torch.dim2.step import update_sleeping as update_sleeping_2d
from avian_tpu_torch.geometry.narrowphase import manifold_buckets
from avian_tpu_torch.parallel import make_batched_step, replicate_world
from avian_tpu_torch.parallel.sharding import flatten
from avian_tpu_torch.pipeline import broadphase as bp_m
from avian_tpu_torch.pipeline import ccd as ccd_m
from avian_tpu_torch.pipeline import contacts as np_m
from avian_tpu_torch.pipeline import integrator as int_m
from avian_tpu_torch.pipeline import sleeping as sleep_m
from avian_tpu_torch.pipeline import solver as sol_m
from avian_tpu_torch.pipeline import solver_body as sb_m
from avian_tpu_torch.pipeline import xpbd as xpbd_m

N_CUBES, PYRAMID_BASE, SETTLE_STEPS = 10_000, 100, 30
HINGE_ROWS, HINGE_COLS = 30, 334
SHAPES_N, SHAPES_PER_ROW, SHAPES_SETTLE_STEPS = 10_000, 48, 40
TERRAIN_N, TERRAIN_PER_ROW, TERRAIN_SLOTS = 10_000, 48, 24 * 10_000
PYRAMID_SLOTS = 24 * (PYRAMID_BASE * (PYRAMID_BASE + 1) // 2 + 1)
CONFIG = PhysicsConfig(
    substeps=4, shape_pairs=((ShapeType.BOX, ShapeType.BOX), (ShapeType.BOX, ShapeType.PLANE))
)
SHAPES_CONFIG = CONFIG.replace(
    shape_pairs=tuple((a, b) for a in range(6) for b in range(a, 6) if (a, b) != (3, 3)))
_TERRAIN_SHAPES = (0, 1, 2, 4, 5, 8)
TERRAIN_CONFIG = CONFIG.replace(sap_window=64, shape_pairs=tuple(
    (a, b) for i, a in enumerate(_TERRAIN_SHAPES) for b in _TERRAIN_SHAPES[i:]))
CCD_BULLETS, CCD_SETTLE_STEPS = 32, 2
CONFIG_2D = PhysicsConfig(substeps=4, max_colors=8)
BATCH_SCENES, BATCH_CUBES = 4096, 27
BATCH_CONFIG = CONFIG.replace(max_colors=4, sap_window=8)
KERNEL_OF = {"box_manifold": "Kernel A", "convex_manifold": "Kernel M",
             "round_manifold": "Kernel N", "plane_patch_manifold": "Kernel O",
             "hull_manifold": "Kernel P", "plane_hull_manifold": "Kernel Q"}


def stage_ms(world, config):
    """{stage: ms} of one step, staged as ``pipeline/step.py::_core``."""
    out = {}
    t0 = [time.perf_counter()]

    def mark(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        out[name] = out.get(name, 0.0) + 1e3 * (now - t0[0])
        t0[0] = now

    h = config.substep_dt
    w2, pos, quat = bp_m.update_aabbs_and_poses(world, config)
    bp = bp_m.broad_phase(w2, config)
    mark("broadphase")
    contacts, _ = np_m.narrow_phase(w2, bp, config, poses=(pos, quat))
    mark("narrowphase")
    s, table = sb_m.prepare_with_table(w2.bodies, w2.gravity, h)
    mark("solver bodies")
    con = sol_m.prepare_constraints(w2, contacts, s, config)
    mark("prepare")
    jcon = xpbd_m.prepare_joints(w2, s, config) if w2.joints.capacity > 0 else None
    if jcon is not None:
        mark("prepare joints")
    for _ in range(config.substeps):
        s = int_m.integrate_velocities(s, table, h)
        mark("integrate")
        s = sol_m.warm_start(s, con, config)
        mark("warm")
        s, con = sol_m.solve_pass(s, con, True, config)
        mark("bias")
        s = int_m.integrate_positions(s, table, h)
        mark("integrate")
        s, con = sol_m.solve_pass(s, con, False, config)
        mark("relax")
        if jcon is not None:
            s = xpbd_m.solve_position_constraints(s, jcon, h, config)
            mark("joints")
    if config.swept_ccd:
        s, _ = ccd_m.solve_swept_ccd(w2, s, pos, quat, config)
        mark("ccd")
    s, con = sol_m.solve_restitution(s, con, config)
    mark("restitution")
    stored = sol_m.store_impulses(contacts, con)
    joints = xpbd_m.store_joint_forces(w2.joints, jcon, config) if jcon is not None else w2.joints
    bodies = sb_m.writeback(w2.bodies, s)
    mark("store+writeback")
    sleep_m.update_sleeping(bodies, stored, joints, config)
    mark("sleeping")
    return out


def stage_ms_2d(world, config):
    """{stage: ms} of one 2D step, staged as ``dim2/step.py::_core``."""
    out = {}
    t0 = [time.perf_counter()]

    def mark(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        out[name] = out.get(name, 0.0) + 1e3 * (now - t0[0])
        t0[0] = now

    h = config.substep_dt
    poses = bp2.collider_poses(world)
    w2 = bp2.update_aabbs(world, config, poses)
    bp = bp2.broad_phase(w2, config)
    mark("broadphase")
    contacts = nc2.narrow_phase(w2, bp, config, poses)
    mark("narrowphase")
    s, table = dyn2.prepare(w2.bodies, w2.gravity, h)
    con = sol2.prepare_constraints(w2, contacts, s, config)
    mark("prepare")
    jcon = None
    if bool(w2.joints.active.any()):
        jcon = xpbd2.prepare_joints(w2, s, poses, config)
        mark("prepare joints")
    for _ in range(config.substeps):
        s = dyn2.integrate_velocities(s, table, h)
        s = sol2.warm_start(s, con, config)
        s, con = sol2.solve_pass(s, con, True, config)
        s = dyn2.integrate_positions(s, table, h)
        s, con = sol2.solve_pass(s, con, False, config)
        mark("substeps")
        if jcon is not None:
            s, _ = xpbd2.solve_position_constraints(s, jcon, h, config)
            mark("joints")
    if config.swept_ccd:
        s = ccd2.solve_swept_ccd_2d(w2, s, poses, config)
        mark("ccd")
    s, con = sol2.solve_restitution(s, con, config)
    mark("restitution")
    stored = sol2.store_impulses(contacts, con)
    bodies = dyn2.writeback(w2.bodies, s)
    mark("store+writeback")
    update_sleeping_2d(bodies, stored, w2.joints, config)
    mark("sleeping")
    return out


def narrowphase_split_ms(world, config):
    """{kernel: ms} of the manifold launches of one step, each kernel's
    buckets summed, and the bucketing that precedes them."""
    out = {}
    w2, pos, quat = bp_m.update_aabbs_and_poses(world, config)
    bp = bp_m.broad_phase(w2, config)
    col = w2.colliders
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    buckets = manifold_buckets(col.shape_type, col.params, pos, quat, bp.collider_a.long(),
                               bp.collider_b.long(), bp.valid, config.shape_pairs,
                               w2.convex_verts)
    torch.cuda.synchronize()
    out["bucketing"] = 1e3 * (time.perf_counter() - t0)
    for b in buckets:
        t0 = time.perf_counter()
        b.run()
        torch.cuda.synchronize()
        key = KERNEL_OF[b.name]
        out[key] = out.get(key, 0.0) + 1e3 * (time.perf_counter() - t0)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="pile",
                    choices=("pile", "pyramid", "hinges", "shapes", "terrain", "terrain_ccd",
                             "batched", "pyramid2d", "many_pyramids2d", "hinges2d", "pyramid_ccd2d"))
    ap.add_argument("--out", help="also write the JSON object to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
    config, settle = CONFIG, SETTLE_STEPS
    step, stages = physics_step, stage_ms
    if args.scene in ("pyramid2d", "many_pyramids2d", "hinges2d", "pyramid_ccd2d"):
        config, step, stages = CONFIG_2D, physics_step_2d, stage_ms_2d
        if args.scene == "pyramid2d":
            world, ids = scenes2d.box_pyramid_2d(PYRAMID_BASE, max_contacts=PYRAMID_SLOTS,
                                                 device=device)
        elif args.scene == "hinges2d":
            world, ids = scenes2d.hinge_blocks_2d(84, max_contacts=16 * 10_081, device=device)
        elif args.scene == "pyramid_ccd2d":
            config, settle = CONFIG_2D.replace(swept_ccd=True), CCD_SETTLE_STEPS
            world, ids, shots = scenes2d.pyramid_ccd_2d(
                PYRAMID_BASE, CCD_BULLETS, max_contacts=PYRAMID_SLOTS + 24 * CCD_BULLETS,
                device=device)
            ids = ids + shots
        else:
            world, ids = scenes2d.many_pyramids_2d(10, 10, max_contacts=24 * 5_501,
                                                   device=device)
    elif args.scene == "shapes":
        config, settle = SHAPES_CONFIG, SHAPES_SETTLE_STEPS
        world, ids = scenes.many_shapes(SHAPES_N, per_row=SHAPES_PER_ROW,
                                        max_contacts=16 * (SHAPES_N + 1), device=device)
    elif args.scene == "terrain":
        config, settle = TERRAIN_CONFIG, SHAPES_SETTLE_STEPS
        world, ids = scenes.terrain_shapes(TERRAIN_N, per_row=TERRAIN_PER_ROW,
                                           max_contacts=TERRAIN_SLOTS, device=device)
    elif args.scene == "terrain_ccd":
        config, settle = TERRAIN_CONFIG.replace(swept_ccd=True), CCD_SETTLE_STEPS
        world, ids, shots = scenes.terrain_ccd(
            TERRAIN_N, per_row=TERRAIN_PER_ROW, bullets=CCD_BULLETS,
            max_contacts=24 * (TERRAIN_N + CCD_BULLETS), device=device)
        ids = ids + shots
    elif args.scene == "batched":
        config = BATCH_CONFIG
        batched_step = make_batched_step(config)
        step = lambda w, _: batched_step(w)  # noqa: E731
        single, _ = scenes.cube_pile(BATCH_CUBES, max_contacts=8 * BATCH_CUBES, device=device)
        world = replicate_world(single, BATCH_SCENES)
        gen = torch.Generator().manual_seed(0)
        jitter = (1.0 + 0.1 * torch.randn(BATCH_SCENES, generator=gen)).to(device)
        world = world.replace(gravity=world.gravity * jitter[:, None])
        ids = range(BATCH_SCENES * BATCH_CUBES)
    elif args.scene == "pile":
        world, ids = scenes.cube_pile(N_CUBES, max_contacts=16 * N_CUBES, device=device)
    elif args.scene == "pyramid":
        world, ids = scenes.box_pyramid(PYRAMID_BASE, max_contacts=PYRAMID_SLOTS, device=device)
    else:
        world, ids = scenes.falling_hinges(
            HINGE_ROWS, HINGE_COLS, max_contacts=16 * (HINGE_ROWS * HINGE_COLS + 1), device=device)
    for _ in range(settle):
        world = step(world, config)
    torch.cuda.synchronize()

    # The batched step's stages run on its flat world.
    staged = flatten(world) if args.scene == "batched" else world
    runs = [stages(staged, config) for _ in range(3)]
    result = {"card": smi, "scene": args.scene, "bodies": len(ids),
              "contact_slots": staged.contacts.capacity, "after_steps": settle,
              "stage_ms": {k: sum(r[k] for r in runs) / len(runs) for k in runs[0]}}
    if stages is stage_ms:
        splits = [narrowphase_split_ms(staged, config) for _ in range(3)]
        result["narrowphase_split_ms"] = {k: sum(r[k] for r in splits) / len(splits)
                                          for k in splits[0]}

    walls = []
    w = world
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w = step(w, config)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    result["step_wall_ms"] = walls

    w = world
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            w = step(w, config)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    kernels = []
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if us and "CUDA" in str(e.device_type):
            kernels.append((e.key, us / 1e3, e.count))
    kernels.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in kernels)
    result["profile"] = {
        "steps": 3, "wall_ms": wall, "device_busy_ms": busy,
        "idle_share": 1.0 - busy / wall, "top_kernels_ms_calls": kernels[:25],
    }

    print(smi)
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
