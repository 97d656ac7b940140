"""2D narrowphase stage: manifolds, persistent pair matching and warm-start
carry (port of ``avian_tpu/dim2/contacts.py::narrow_phase``).

Manifolds come from Kernel V (``dim2/narrowphase.py``). Then one stable sort
of ``[old keys ++ new keys]``, Kernel F's key join (``contact_join``, which
does not depend on the dimension), one ``cumsum`` minting the new contact
ids, and Kernel W (``kernels/contact_rows_2d.py``) for everything else.
"""

import torch

from avian_tpu_torch.core.config import PhysicsConfig
from avian_tpu_torch.dim2.broadphase import BroadPhaseResult2D, Poses2D
from avian_tpu_torch.dim2.narrowphase import compute_manifold_2d
from avian_tpu_torch.dim2.state import Contacts2D, World2D
from avian_tpu_torch.kernels import contact_rows as kf
from avian_tpu_torch.kernels import contact_rows_2d as kw


def row_params(config: PhysicsConfig) -> kw.RowParams2D:
    return kw.RowParams2D(
        dt=config.dt,
        spec_default=config.narrow_phase.default_speculative_margin,
        tolerance=config.narrow_phase.contact_tolerance * config.length_unit,
        match_distance2=(config.narrow_phase.match_distance * config.length_unit) ** 2,
        match_contacts=config.narrow_phase.match_contacts,
    )


def narrow_phase(world: World2D, bp: BroadPhaseResult2D, config: PhysicsConfig,
                 poses: Poses2D) -> Contacts2D:
    """This step's ``Contacts2D`` from the broadphase pairs and the old buffer;
    ``poses`` is this step's ``broadphase.collider_poses``."""
    old = world.contacts
    col = world.colliders
    c_cap = old.capacity
    man = compute_manifold_2d(bp.collider_a.long(), bp.collider_b.long(), poses.pos,
                              poses.cs, col)

    ks, s = torch.sort(torch.cat([old.pair_key, bp.pair_key]), stable=True)
    hit, survives = kf.contact_join(ks, s, c_cap)
    minted = torch.cumsum((bp.valid & (hit == 0)).to(torch.int32), dim=0, dtype=torch.int32)
    rows = kw.contact_rows_2d(
        world.bodies, poses.body_cs, col, old, bp.valid, bp.collider_a, bp.collider_b, man,
        hit, survives, minted - 1, row_params(config),
    )
    dev = bp.valid.device
    return Contacts2D(
        pair_key=bp.pair_key,
        collider_a=bp.collider_a,
        collider_b=bp.collider_b,
        active=bp.valid,
        normal=man.normal,
        max_normal_impulse=torch.zeros((c_cap, 2), device=dev),
        surface_speed=torch.zeros((c_cap,), device=dev),
        next_contact_id=(old.next_contact_id + minted[-1]).to(torch.int32),
        **rows,
    )
