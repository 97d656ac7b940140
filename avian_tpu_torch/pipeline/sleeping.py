"""Island-based sleeping as a pure per-step computation (port of
``avian_tpu/pipeline/sleeping.py``).

Island labels come from the reference's 10 rounds of min-label propagation
with pointer jumping over a fixed-degree neighbor table, kept as written
so that labels match exactly (a union-find would give the same labels only
when the rounds converge). The incidences are sorted here (``torch.sort``)
and ranked by Kernel G's run rank (``kernels/run_rank.py``); the table, the
rounds and the sleep update are Kernel J (``kernels/islands.py``).
"""

import torch

from avian_tpu_torch.core import types
from avian_tpu_torch.core.config import PhysicsConfig
from avian_tpu_torch.core.state import Bodies, Contacts, Joints
from avian_tpu_torch.kernels import islands as kj
from avian_tpu_torch.kernels.run_rank import run_rank


def island_incidences(bodies: Bodies, contacts: Contacts, joints: Joints):
    """The island graph's directed incidences, grouped by body: ``(src i32[2E]
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

    src = torch.cat([ea, eb]).to(torch.int32)
    dst = torch.cat([eb, ea])
    ok2 = torch.cat([e_ok, e_ok])
    key = torch.where(ok2, dst, n).to(torch.int32)
    sorted_key, order = torch.sort(key, stable=True)
    return src, sorted_key, order


def compute_islands(bodies: Bodies, contacts: Contacts, joints: Joints):
    """(i32[N] island label = min body index in the component,
    bool[N] neighbor-table overflow)."""
    src, sorted_key, order = island_incidences(bodies, contacts, joints)
    # A body whose incidences did not all fit in the table is flagged. (The
    # reference masks this with the unsorted ``ok2`` against sorted entries,
    # which can miss a flag; the intended sorted mask is ``sorted_key < n``.)
    neighbors, overflow = kj.island_table(src, sorted_key, order, run_rank(sorted_key),
                                          bodies.capacity)
    return kj.island_labels(neighbors), overflow


def update_sleeping(bodies: Bodies, contacts: Contacts, joints: Joints,
                    config: PhysicsConfig) -> Bodies:
    """Sleep timers, island all-ready reduction, wake and velocity zeroing
    (reference ``update_sleeping``)."""
    island, overflow = compute_islands(bodies, contacts, joints)
    if not config.sleeping_enabled:
        return bodies.replace(island=island)
    lin_t = config.sleep_linear_threshold * config.length_unit
    ang_t = config.sleep_angular_threshold
    params = kj.SleepParams(lin_t * lin_t, ang_t * ang_t, config.dt, config.time_to_sleep)
    sleep, timer, lin_vel, ang_vel = kj.sleep_update(bodies, island, overflow, params)
    return bodies.replace(
        sleeping=sleep, sleep_timer=timer, island=island, lin_vel=lin_vel, ang_vel=ang_vel,
        sleep_pos=bodies.pos, sleep_quat=bodies.quat,
    )
