"""Island-based sleeping as a pure per-step computation (port of
``avian_tpu/pipeline/sleeping.py``).

Island labels come from the reference's 10 rounds of min-label propagation
with pointer jumping over a fixed-degree neighbor table, kept as written
so that labels match exactly (a union-find would give the same labels only
when the rounds converge). Plain PyTorch, except the run rank of the
neighbor table, which is Kernel G's (``kernels/run_rank.py``).
"""

import torch

from avian_tpu_torch.core import types
from avian_tpu_torch.core.config import PhysicsConfig
from avian_tpu_torch.core.state import Bodies, Contacts, Joints
from avian_tpu_torch.kernels.run_rank import run_rank

_LABEL_ROUNDS = 10
_MAX_DEGREE = 24


def island_incidences(bodies: Bodies, contacts: Contacts, joints: Joints):
    """The island graph's directed incidences, grouped by body: ``(src i64[2E]
    the other end of each, sorted_key i32[2E] the body it belongs to with
    ``N`` for a dead one, order i64[2E] the stable sort's permutation)``."""
    n = bodies.capacity
    non_static = bodies.active & (bodies.body_type != types.BodyType.STATIC)
    ca, cb = contacts.body_a.long(), contacts.body_b.long()
    c_ok = (
        contacts.active & contacts.touching & ~contacts.is_sensor
        & non_static[ca] & non_static[cb]
    )
    ja, jb = joints.body_a.long(), joints.body_b.long()
    j_ok = joints.active & non_static[ja] & non_static[jb]
    ea = torch.cat([ca, ja])
    eb = torch.cat([cb, jb])
    e_ok = torch.cat([c_ok, j_ok])

    src = torch.cat([ea, eb])
    dst = torch.cat([eb, ea])
    ok2 = torch.cat([e_ok, e_ok])
    key = torch.where(ok2, dst, n).to(torch.int32)
    sorted_key, order = torch.sort(key, stable=True)
    return src, sorted_key, order


def compute_islands(bodies: Bodies, contacts: Contacts, joints: Joints):
    """(i32[N] island label = min body index in the component,
    bool[N] neighbor-table overflow)."""
    n = bodies.capacity
    dev = bodies.pos.device
    d = _MAX_DEGREE
    src, sorted_key, order = island_incidences(bodies, contacts, joints)
    rank = run_rank(sorted_key)
    slot_ok = (rank < d) & (sorted_key < n)
    slot = torch.clamp(sorted_key, 0, n - 1).long() * d + rank
    table = torch.full((n * d + 1,), n, dtype=torch.int64, device=dev)
    table[torch.where(slot_ok, slot, n * d)] = src[order]
    neighbors = table[:-1].reshape(n, d)
    # A body whose incidences did not all fit in the table. (The reference
    # masks this with the unsorted ``ok2`` against sorted entries, which
    # can miss a flag; the intended sorted mask is ``sorted_key < n``.)
    overflow = torch.zeros((n + 1,), dtype=torch.bool, device=dev)
    overflow[torch.where(slot_ok, n, sorted_key).long()] = True
    overflow = overflow[:n]

    label = torch.arange(n, device=dev)
    pad = torch.full((1,), n, dtype=torch.int64, device=dev)
    for _ in range(_LABEL_ROUNDS):
        label_pad = torch.cat([label, pad])
        label = torch.minimum(label, label_pad[neighbors].amin(dim=1))
        label = torch.minimum(label, label[label])
    return label.to(torch.int32), overflow


def update_sleeping(bodies: Bodies, contacts: Contacts, joints: Joints,
                    config: PhysicsConfig) -> Bodies:
    """Sleep timers, island all-ready reduction, wake and velocity zeroing
    (reference ``update_sleeping``)."""
    if not config.sleeping_enabled:
        island, _ = compute_islands(bodies, contacts, joints)
        return bodies.replace(island=island)
    n = bodies.capacity
    dev = bodies.pos.device
    lin_t = config.sleep_linear_threshold * config.length_unit
    ang_t = config.sleep_angular_threshold

    teleported = bodies.sleeping & (
        (torch.abs(bodies.pos - bodies.sleep_pos) > 1e-6).any(-1)
        | (torch.abs(bodies.quat - bodies.sleep_quat) > 1e-6).any(-1)
    )
    tele_island = torch.zeros((n + 1,), dtype=torch.bool, device=dev)
    old_island = bodies.island.long()
    tele_island[torch.where(teleported, old_island, n)] = True
    teleported = teleported | tele_island[:n][old_island]
    lv, av = bodies.lin_vel, bodies.ang_vel
    below = (
        ((lv * lv).sum(-1) < lin_t * lin_t)
        & ((av * av).sum(-1) < ang_t * ang_t)
        & ~bodies.sleep_disabled
        & ~teleported
    )
    timer = torch.where(below, bodies.sleep_timer + config.dt, 0.0)

    island, overflow = compute_islands(bodies, contacts, joints)
    isl = island.long()
    ready = (timer >= config.time_to_sleep) & ~overflow
    considered = bodies.active & (bodies.body_type != types.BodyType.STATIC)
    all_ready = torch.ones((n,), dtype=torch.int32, device=dev)
    all_ready.scatter_reduce_(
        0, isl, torch.where(considered, ready, True).to(torch.int32), reduce="amin"
    )
    sleep = considered & (all_ready[isl] > 0) & (
        bodies.body_type == types.BodyType.DYNAMIC
    )
    woke = bodies.sleeping & ~sleep
    timer = torch.where(woke, 0.0, timer)
    z = sleep[:, None]
    return bodies.replace(
        sleeping=sleep,
        sleep_timer=timer,
        island=island,
        lin_vel=torch.where(z, 0.0, bodies.lin_vel),
        ang_vel=torch.where(z, 0.0, bodies.ang_vel),
        sleep_pos=bodies.pos,
        sleep_quat=bodies.quat,
    )
