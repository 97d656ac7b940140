"""Hand-written Hopper kernels of the port, each with its plain PyTorch twin:

- ``box_manifold`` (Kernel A, CUDA): box/box and box/plane manifolds;
- ``grid_sweep`` (Kernel B, CUDA): the broadphase's same-cell window sweep;
- ``integrate_bodies`` (Kernel C, Triton): substep integration;
- ``solve_color`` (Kernel D, CUDA): one color of the contact solver.

``build`` compiles ``csrc/*.cu`` at first use. Each wrapper counts its
launches in ``<wrapper>.launches``; ``reset_launches`` zeroes all four.
"""

from avian_tpu_torch.kernels import box_manifold as _a
from avian_tpu_torch.kernels import grid_sweep as _b
from avian_tpu_torch.kernels import integrate_bodies as _c
from avian_tpu_torch.kernels import solve_color as _d

WRAPPERS = {
    "box_manifold": _a.box_manifold,
    "grid_sweep": _b.grid_sweep,
    "integrate_bodies": _c.integrate_bodies,
    "solve_color": _d.solve_color,
}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
