"""Where one full step of the port's 10,000-cube pile spends its time on a
CUDA card.

    python3 profile_step.py [--out profile.json]

Settles ``cube_pile(10_000)`` (160,000 contact slots, the smoke's config)
for 30 steps, so that it is awake and its contacts are warm, and then
measures from that state:

- ``stage_ms``: each stage of ``physics_step`` on the host clock, the card
  synchronized after every stage, mean of 3 steps (solver and integration
  stages summed over the substeps);
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
from avian_tpu_torch.pipeline import broadphase as bp_m
from avian_tpu_torch.pipeline import contacts as np_m
from avian_tpu_torch.pipeline import integrator as int_m
from avian_tpu_torch.pipeline import sleeping as sleep_m
from avian_tpu_torch.pipeline import solver as sol_m
from avian_tpu_torch.pipeline import solver_body as sb_m

N_CUBES, SETTLE_STEPS = 10_000, 30
CONFIG = PhysicsConfig(
    substeps=4, shape_pairs=((ShapeType.BOX, ShapeType.BOX), (ShapeType.BOX, ShapeType.PLANE))
)


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
    w2 = bp_m.update_aabbs(world, config)
    bp = bp_m.broad_phase(w2, config)
    mark("broadphase")
    contacts, _ = np_m.narrow_phase(w2, bp, config)
    mark("narrowphase")
    s = sb_m.prepare(w2.bodies)
    table = int_m.integration_table(
        w2.bodies, int_m.pre_process_velocity_increments(w2.bodies, w2.gravity, h)
    )
    con = sol_m.prepare_constraints(w2, contacts, s, config)
    mark("prepare")
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
    s, con = sol_m.solve_restitution(s, con, config)
    mark("restitution")
    stored = sol_m.store_impulses(contacts, con)
    bodies = sb_m.writeback(w2.bodies, s)
    sleep_m.update_sleeping(bodies, stored, w2.joints, config)
    mark("store+writeback+sleeping")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON object to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
    world, _ = scenes.cube_pile(N_CUBES, max_contacts=16 * N_CUBES, device=device)
    for _ in range(SETTLE_STEPS):
        world = physics_step(world, CONFIG)
    torch.cuda.synchronize()

    runs = [stage_ms(world, CONFIG) for _ in range(3)]
    result = {"card": smi, "cubes": N_CUBES, "after_steps": SETTLE_STEPS,
              "stage_ms": {k: sum(r[k] for r in runs) / len(runs) for k in runs[0]}}

    walls = []
    w = world
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w = physics_step(w, CONFIG)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    result["step_wall_ms"] = walls

    w = world
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            w = physics_step(w, CONFIG)
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
