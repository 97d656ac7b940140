"""Record the JAX reference's base-100 2D pyramid curve for the port's chip smoke.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_cases/record_pyramid2d_curve.py

Steps ``avian_tpu.dim2.scenes.box_pyramid_2d(100)`` (5,050 boxes) with 24
contact slots a box and ``PhysicsConfig(substeps=4, max_colors=8)`` for 60
steps on XLA:CPU, and writes ``pyramid2d_curve.npz`` beside this file: per
step the apex box's height (``apex``), the lowest box's height (``lowest``),
the rows in the overflow colour (``num_overflow``) and the dropped pairs and
overflow drops (``dropped``). ``chip_smoke.py`` holds the port's curve on the
card to it. Takes about 0.2 s a step on the CPU.
"""

import os

import numpy as np

BASE = 100
SLOTS_PER_BOX = 24
STEPS = 60


def main():
    from avian_tpu import PhysicsConfig
    from avian_tpu.dim2 import scenes
    from avian_tpu.dim2.state import Contacts2D
    from avian_tpu.dim2.step import physics_step_2d

    world, ids = scenes.box_pyramid_2d(BASE)
    n = len(ids) + 1
    world = world.replace(contacts=Contacts2D.zeros(SLOTS_PER_BOX * n))
    config = PhysicsConfig(substeps=4, max_colors=8)
    idx = np.asarray(ids)
    apex_id = idx[int(np.argmax(np.asarray(world.bodies.pos)[idx, 1]))]
    rows = {k: [] for k in ("apex", "lowest", "num_overflow", "dropped")}
    for _ in range(STEPS):
        world, diag = physics_step_2d(world, config, return_diagnostics=True)
        pos = np.asarray(world.bodies.pos)
        rows["apex"].append(pos[apex_id, 1])
        rows["lowest"].append(pos[idx, 1].min())
        rows["num_overflow"].append(int(diag["num_overflow"]))
        rows["dropped"].append(int(diag["dropped_pairs"]) + int(diag["overflow_dropped"]))
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "pyramid2d_curve.npz")
    np.savez(out, apex_id=apex_id, **{k: np.asarray(v) for k, v in rows.items()})
    print(f"wrote {out}: apex {rows['apex'][0]:.4f} .. {rows['apex'][-1]:.4f} m, lowest "
          f"{min(rows['lowest']):.4f} m, dropped {max(rows['dropped'])}")


if __name__ == "__main__":
    main()
