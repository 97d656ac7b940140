"""The hooked cube pile of ``chip_smoke.py``'s ``extensions`` phase, cut in
size, through both packages on the CPU: ``cube_pile(n)`` at 16 contact slots
a cube, 180 steps, the conveyor's ``modify_contacts`` on the ground (2 m/s
along +x) and a ``filter_pairs`` that drops every pair of a cube whose index
is divisible by 10. Prints, for each package, the filtered cubes above the
ground, the cubes resting on the ground, how many of those move along +x at
0.5 m/s or less, their slowest and median speed along +x, and the most pairs
dropped in a step: the reading that the smoke's hook gate is set from.

    JAX_PLATFORMS=cpu python tests/torch_cases/hook_pile_reference.py [--cubes 2000] [--seed 0]
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(os.path.dirname(HERE))]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import avian_tpu as jav  # noqa: E402
import avian_tpu_torch as tav  # noqa: E402
from avian_tpu import scenes as jscenes  # noqa: E402
from avian_tpu_torch import scenes as tscenes  # noqa: E402

import shared_ext  # noqa: E402

STEPS, EVERY, BELT = 180, 10, 2.0
SLOTS = 16  # contact slots a cube, as the smoke's pile
PAIRS = ((2, 2), (2, 3))  # box/box, box/half-space


class JHooks:
    """The smoke's hooks on the reference's arrays."""

    def filter_pairs(self, world, ca, cb, valid):
        body = world.colliders.body_idx
        ba, bb = body[ca], body[cb]
        return valid & ~((ba % EVERY == 0) & (ba > 0)) & ~((bb % EVERY == 0) & (bb > 0))

    def modify_contacts(self, world, contacts):
        on_belt = (contacts.body_a == 0) | (contacts.body_b == 0)
        sign = jnp.where(contacts.body_a == 0, -1.0, 1.0)
        sv = jnp.where(on_belt[:, None], sign[:, None] * jnp.asarray([BELT, 0.0, 0.0]),
                       contacts.surface_velocity)
        return contacts.replace(surface_velocity=sv)


class THooks(shared_ext.Conveyor):
    """The smoke's hooks on the port's tensors."""

    def filter_pairs(self, world, ca, cb, valid):
        body = world.colliders.body_idx
        ba, bb = body[ca.long()], body[cb.long()]
        return valid & ~((ba % EVERY == 0) & (ba > 0)) & ~((bb % EVERY == 0) & (bb > 0))


def reading(pos, vel, active, drops):
    """The smoke's gate quantities from the final state (numpy)."""
    pos, vel, active = pos[1:], vel[1:], active[1:]
    idx = np.arange(1, pos.shape[0] + 1)
    filtered = (idx % EVERY == 0) & active
    resting = (~filtered & (np.abs(pos[:, 1] - 0.5) < 0.05) & (np.abs(vel[:, 1]) < 0.1)
               & active)
    vx = vel[resting, 0]
    return {
        "filtered": int(filtered.sum()),
        "filtered_above_ground": int((pos[filtered, 1] >= 0.0).sum()),
        "resting": int(resting.sum()),
        "resting_at_most_0.5": int((vx <= 0.5).sum()),
        "share_at_most_0.5": float((vx <= 0.5).mean()) if vx.size else None,
        "slowest_vx": float(vx.min()) if vx.size else None,
        "median_vx": float(np.median(vx)) if vx.size else None,
        "most_pairs_dropped": int(drops),
    }


def run_reference(n, seed):
    world, _ = jscenes.cube_pile(n, seed=seed, max_contacts=SLOTS * n)
    cfg = jav.PhysicsConfig(substeps=4, shape_pairs=PAIRS, sleep_early_out=False)
    hooks, drops = JHooks(), 0
    for _ in range(STEPS):
        world, diag = jav.physics_step(world, cfg, return_diagnostics=True, hooks=hooks)
        drops = max(drops, int(diag["dropped_pairs"]))
    b = world.bodies
    return reading(np.asarray(b.pos), np.asarray(b.lin_vel), np.asarray(b.active), drops)


def run_port(n, seed):
    world, _ = tscenes.cube_pile(n, seed=seed, max_contacts=SLOTS * n, device="cpu")
    cfg = tav.PhysicsConfig(substeps=4, shape_pairs=PAIRS, sleep_early_out=False)
    hooks, drops = THooks(0, BELT), 0
    for _ in range(STEPS):
        world, diag = tav.physics_step(world, cfg, return_diagnostics=True, hooks=hooks)
        drops = max(drops, int(diag["dropped_pairs"]))
    b = world.bodies
    return reading(b.pos.numpy(), b.lin_vel.numpy(), b.active.numpy(), drops)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cubes", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0, help="cube_pile's jitter seed")
    ap.add_argument("--only", choices=("reference", "port"))
    args = ap.parse_args()
    torch.set_num_threads(max(1, min(4, os.cpu_count() or 1)))
    for name, fn in (("reference", run_reference), ("port", run_port)):
        if args.only in (None, name):
            t0 = time.perf_counter()
            out = fn(args.cubes, args.seed)
            out.update(package=name, cubes=args.cubes, seed=args.seed,
                       seconds=time.perf_counter() - t0)
            print(json.dumps(out), flush=True)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    main()
