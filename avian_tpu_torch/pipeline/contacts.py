"""Narrowphase stage: manifolds, persistent pair matching and warm-start
carry (port of ``avian_tpu/pipeline/contacts.py::narrow_phase``).

Manifolds come from Kernels A, M, N, O, P and Q through
``geometry.narrowphase``, which gets the world's vertex pool for the
pool-backed convex shapes (reference ``contacts.py:80``). Everything
after them is Kernel F (``kernels/contact_rows.py``): the join of old and new
pair keys, the speculative keep predicate, in-row point compaction, anchors,
contact ids, feature-id / anchor-distance warm-start matching, material
combination and eviction flags. Between its two launches stand the two
library calls the reference also makes: one stable sort of the int64 pair
keys and one ``cumsum`` over the new pairs.
"""

import torch

from avian_tpu_torch.core.config import PhysicsConfig
from avian_tpu_torch.core.state import Contacts, World
from avian_tpu_torch.geometry.narrowphase import compute_manifolds
from avian_tpu_torch.kernels import contact_rows as kf
from avian_tpu_torch.pipeline.broadphase import BroadPhaseResult


def row_params(config: PhysicsConfig) -> kf.RowParams:
    return kf.RowParams(
        dt=config.dt,
        spec_default=config.narrow_phase.default_speculative_margin,
        tolerance=config.narrow_phase.contact_tolerance * config.length_unit,
        match_distance2=(config.narrow_phase.match_distance * config.length_unit) ** 2,
        match_contacts=config.narrow_phase.match_contacts,
    )


def narrow_phase(world: World, bp: BroadPhaseResult, config: PhysicsConfig, poses,
                 custom_shapes=()):
    """Build this step's Contacts from broadphase pairs + the old buffer.

    ``poses`` is the colliders' world ``(pos, quat)`` from
    ``update_aabbs_and_poses``; ``custom_shapes`` the step's custom shapes
    (their pairs are one more bucket each). Returns
    ``(contacts, bucket_sizes)``; ``bucket_sizes`` maps each canonical shape
    pair launched to its number of pairs."""
    old = world.contacts
    col = world.colliders
    c_cap = old.capacity
    dev = col.params.device

    pos, quat = poses
    pairs = config.shape_pairs if config.shape_pairs is not None else world.shape_pairs
    man, sizes = compute_manifolds(
        col.shape_type, col.params, pos, quat,
        bp.collider_a.long(), bp.collider_b.long(), bp.valid, pairs, world.convex_verts,
        custom_shapes,
    )

    # ---- pair persistence: one stable sort of [old keys ++ new keys] ----
    ks, s = torch.sort(torch.cat([old.pair_key, bp.pair_key]), stable=True)
    hit, survives = kf.contact_join(ks, s, c_cap)
    is_new = bp.valid & (hit == 0)
    minted = torch.cumsum(is_new.to(torch.int32), dim=0, dtype=torch.int32)
    num_new = minted[-1] if c_cap else torch.zeros((), dtype=torch.int32, device=dev)

    rows = kf.contact_rows(
        world.bodies, col, old, bp.valid, bp.collider_a, bp.collider_b, man,
        hit, survives, minted - 1, row_params(config),
    )
    contacts = Contacts(
        pair_key=bp.pair_key,
        collider_a=bp.collider_a,
        collider_b=bp.collider_b,
        active=bp.valid,
        normal=man.normal,
        max_normal_impulse=torch.zeros((c_cap, 4), device=dev),
        surface_velocity=torch.zeros((c_cap, 3), device=dev),
        next_contact_id=(old.next_contact_id + num_new).to(torch.int32),
        **rows,
    )
    return contacts, sizes
