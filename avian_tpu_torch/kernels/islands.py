"""Kernel J, ``islands``: island labels and the sleep update.

Replaces ``avian_tpu/pipeline/sleeping.py::compute_islands`` (:33) and
``update_sleeping`` (:99). Four entry points:

- ``island_table`` (one thread per sorted incidence): the fixed-degree
  neighbour table ``i32[N, 24]`` from the incidences that
  ``pipeline/sleeping.py::island_incidences`` sorted by body, with the run
  rank of Kernel G (``kernels/run_rank.py``), and the flag of a body whose
  incidences did not all fit;
- ``island_labels`` (one block): the reference's 10 rounds of min-label
  propagation, each ``label = min(label, min over neighbours)`` followed by
  ``label = min(label, label[label])``. The rounds are Jacobi, as the
  reference's: each step reads the previous step's labels from one buffer
  and writes the other, with a block-wide barrier between. The labels are
  what they are after exactly 10 rounds, converged or not: a hinged row of
  334 boxes is longer than 10 rounds cover, and an in-place (Gauss-Seidel)
  update or a union-find would label it otherwise and change the sleep
  decisions;
- ``sleep_update`` (one block): teleported islands, timers, the all-ready
  reduction per island (an integer ``atomicMin``, which has no order), the
  sleep flags and the zeroed velocities of sleepers.

``sleep_update_2d`` is ``sleep_update`` for the native 2D engine
(``avian_tpu/dim2/step.py::_update_sleeping``, :160): a scalar angular
speed, and no teleport test, since 2D bodies keep no sleep pose.

On the H100 the work is a few integer gathers per body per round, held in
L2; one block of 1,024 threads keeps the rounds' barriers inside the block,
so the 10 rounds are one launch. Bound by latency, not bytes.

The plain PyTorch versions, ``island_table_twin``, ``island_labels_twin``,
``sleep_update_twin`` and ``sleep_update_2d_twin``, run on CPU tensors; on a CUDA tensor the wrappers
launch the kernels or raise.
"""

from typing import NamedTuple

import torch

from avian_tpu_torch.core import types
from avian_tpu_torch.math import vec

LABEL_ROUNDS = 10
MAX_DEGREE = 24


class SleepParams(NamedTuple):
    lin_t2: float          # squared linear sleep threshold
    ang_t2: float          # squared angular sleep threshold
    dt: float
    time_to_sleep: float


def island_table_twin(src, sorted_key, order, rank, n):
    """Plain PyTorch version; see ``island_table``."""
    d = MAX_DEGREE
    dev = src.device
    slot_ok = (rank < d) & (sorted_key < n)
    slot = torch.clamp(sorted_key, 0, n - 1).long() * d + rank
    table = torch.full((n * d + 1,), n, dtype=torch.int32, device=dev)
    table[torch.where(slot_ok, slot, n * d)] = src[order].to(torch.int32)
    overflow = torch.zeros((n + 1,), dtype=torch.bool, device=dev)
    overflow[torch.where(slot_ok, n, sorted_key).long()] = True
    return table[:-1].reshape(n, d), overflow[:n]


def island_table(src, sorted_key, order, rank, n):
    """``(neighbors i32[N, 24], overflow bool[N])``: each body's neighbours
    in sorted-incidence order (``N`` = empty) and whether some did not fit.
    ``src`` i32[2E] is the other end of each incidence, ``sorted_key``
    i32[2E] the body of each sorted incidence (``N`` for a dead one),
    ``order`` i64[2E] the sort's permutation and ``rank`` i32[2E] the run
    rank."""
    dev = src.device
    if dev.type == "cpu":
        return island_table_twin(src, sorted_key, order, rank, n)
    if dev.type != "cuda":
        raise RuntimeError(f"island_table: unsupported device {dev}")
    from avian_tpu_torch.kernels import build

    e2 = src.shape[0]
    build.require("island_table", dev, (
        ("src", src, (e2,), torch.int32), ("sorted_key", sorted_key, (e2,), torch.int32),
        ("order", order, (e2,), torch.int64), ("rank", rank, (e2,), torch.int32),
    ))
    table = torch.full((n, MAX_DEGREE), n, dtype=torch.int32, device=dev)
    overflow = torch.zeros((n,), dtype=torch.bool, device=dev)
    if e2 == 0:
        return table, overflow
    build.launch("avian_island_table", dev, e2, n, src, sorted_key, order, rank, table, overflow)
    island_table.launches += 1
    return table, overflow


island_table.launches = 0


def island_labels_twin(neighbors):
    """Plain PyTorch version; see ``island_labels``."""
    n = neighbors.shape[0]
    dev = neighbors.device
    label = torch.arange(n, dtype=torch.int32, device=dev)
    pad = torch.full((1,), n, dtype=torch.int32, device=dev)
    nb = neighbors.long()
    for _ in range(LABEL_ROUNDS):
        label_pad = torch.cat([label, pad])
        label = torch.minimum(label, label_pad[nb].amin(dim=1))
        label = torch.minimum(label, label[label.long()])
    return label


def island_labels(neighbors):
    """``label`` i32[N]: after 10 rounds of min-label propagation with
    pointer jumping over ``neighbors`` i32[N, 24], the least body index each
    body has reached (the island's least index where the rounds converge)."""
    dev = neighbors.device
    if dev.type == "cpu":
        return island_labels_twin(neighbors)
    if dev.type != "cuda":
        raise RuntimeError(f"island_labels: unsupported device {dev}")
    from avian_tpu_torch.kernels import build

    n = neighbors.shape[0]
    build.require("island_labels", dev, (
        ("neighbors", neighbors, (n, MAX_DEGREE), torch.int32),
    ))
    label = torch.empty((n,), dtype=torch.int32, device=dev)
    scratch = torch.empty((max(n, 1),), dtype=torch.int32, device=dev)
    if n == 0:
        return label
    build.launch("avian_island_labels", dev, n, LABEL_ROUNDS, neighbors, label, scratch)
    island_labels.launches += 1
    return label


island_labels.launches = 0


def _teleported(bodies):
    return bodies.sleeping & (
        (torch.abs(bodies.pos - bodies.sleep_pos) > 1e-6).any(-1)
        | (torch.abs(bodies.quat - bodies.sleep_quat) > 1e-6).any(-1)
    )


def sleep_update_twin(bodies, island, overflow, p: SleepParams):
    """Plain PyTorch version; see ``sleep_update``."""
    n = bodies.capacity
    dev = bodies.pos.device
    teleported = _teleported(bodies)
    tele_island = torch.zeros((n + 1,), dtype=torch.bool, device=dev)
    old_island = bodies.island.long()
    tele_island[torch.where(teleported, old_island, n)] = True
    teleported = teleported | tele_island[:n][old_island]
    below = (
        (vec.length_sq(bodies.lin_vel) < p.lin_t2)
        & (vec.length_sq(bodies.ang_vel) < p.ang_t2)
        & ~bodies.sleep_disabled
        & ~teleported
    )
    timer = torch.where(below, bodies.sleep_timer + p.dt, 0.0)
    sleep, timer = _all_asleep(bodies, island, overflow, timer, p)
    z = sleep[:, None]
    return (sleep, timer, torch.where(z, 0.0, bodies.lin_vel),
            torch.where(z, 0.0, bodies.ang_vel))


def sleep_update(bodies, island, overflow, p: SleepParams):
    """``(sleeping bool[N], sleep_timer f32[N], lin_vel, ang_vel f32[N, 3])``
    after this step: a body's timer runs while both speeds are under the
    thresholds (and it was not teleported, nor its last island), an island
    sleeps when every non-static member's timer has reached
    ``time_to_sleep`` and none overflowed the neighbour table, and sleepers'
    velocities are zeroed (reference ``update_sleeping``)."""
    dev = bodies.pos.device
    if dev.type == "cpu":
        return sleep_update_twin(bodies, island, overflow, p)
    if dev.type != "cuda":
        raise RuntimeError(f"sleep_update: unsupported device {dev}")
    from avian_tpu_torch.kernels import build

    n = bodies.capacity
    f32, i32, u8 = torch.float32, torch.int32, torch.bool
    b = bodies
    build.require("sleep_update", dev, (
        ("island", island, (n,), i32), ("overflow", overflow, (n,), u8),
        ("old_island", b.island, (n,), i32), ("sleeping", b.sleeping, (n,), u8),
        ("active", b.active, (n,), u8), ("body_type", b.body_type, (n,), i32),
        ("sleep_disabled", b.sleep_disabled, (n,), u8),
        ("pos", b.pos, (n, 3), f32), ("sleep_pos", b.sleep_pos, (n, 3), f32),
        ("quat", b.quat, (n, 4), f32), ("sleep_quat", b.sleep_quat, (n, 4), f32),
        ("lin_vel", b.lin_vel, (n, 3), f32), ("ang_vel", b.ang_vel, (n, 3), f32),
        ("sleep_timer", b.sleep_timer, (n,), f32),
    ))
    sleep = torch.empty((n,), dtype=u8, device=dev)
    timer = torch.empty((n,), dtype=f32, device=dev)
    lin = torch.empty((n, 3), dtype=f32, device=dev)
    ang = torch.empty((n, 3), dtype=f32, device=dev)
    tele = torch.zeros((n,), dtype=u8, device=dev)
    all_ready = torch.ones((n,), dtype=i32, device=dev)
    if n == 0:
        return sleep, timer, lin, ang
    build.launch("avian_sleep_update", dev, n, island, overflow, b.island, b.sleeping, b.active,
                 b.body_type, b.sleep_disabled, b.pos, b.sleep_pos, b.quat, b.sleep_quat,
                 b.lin_vel, b.ang_vel, b.sleep_timer, tele, all_ready, sleep, timer, lin, ang,
                 float(p.lin_t2), float(p.ang_t2), float(p.dt), float(p.time_to_sleep))
    sleep_update.launches += 1
    return sleep, timer, lin, ang


sleep_update.launches = 0


def _all_asleep(bodies, island, overflow, timer, p: SleepParams):
    """(sleep, timer): the island all-ready reduction and the woken bodies'
    timers, shared by both twins."""
    n = bodies.capacity
    isl = island.long()
    ready = (timer >= p.time_to_sleep) & ~overflow
    considered = bodies.active & (bodies.body_type != types.BodyType.STATIC)
    all_ready = torch.ones((n,), dtype=torch.int32, device=timer.device)
    all_ready.scatter_reduce_(
        0, isl, torch.where(considered, ready, True).to(torch.int32), reduce="amin"
    )
    sleep = considered & (all_ready[isl] > 0) & (bodies.body_type == types.BodyType.DYNAMIC)
    return sleep, torch.where(bodies.sleeping & ~sleep, 0.0, timer)


def sleep_update_2d_twin(bodies, island, overflow, p: SleepParams):
    """Plain PyTorch version; see ``sleep_update_2d``."""
    v, w = bodies.lin_vel, bodies.ang_vel
    below = ((v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1] < p.lin_t2) & (w * w < p.ang_t2)
             & ~bodies.sleep_disabled)
    timer = torch.where(below, bodies.sleep_timer + p.dt, 0.0)
    sleep, timer = _all_asleep(bodies, island, overflow, timer, p)
    return (sleep, timer, torch.where(sleep[:, None], 0.0, v), torch.where(sleep, 0.0, w))


def sleep_update_2d(bodies, island, overflow, p: SleepParams):
    """``(sleeping bool[N], sleep_timer f32[N], lin_vel f32[N, 2], ang_vel
    f32[N])`` of the ``Bodies2D`` ``bodies`` after this step, by the rules
    of ``sleep_update`` with a scalar angular speed and no teleport test
    (reference ``dim2/step.py::_update_sleeping``)."""
    dev = bodies.pos.device
    if dev.type == "cpu":
        return sleep_update_2d_twin(bodies, island, overflow, p)
    if dev.type != "cuda":
        raise RuntimeError(f"sleep_update_2d: unsupported device {dev}")
    from avian_tpu_torch.kernels import build

    n = bodies.capacity
    f32, i32, u8 = torch.float32, torch.int32, torch.bool
    b = bodies
    build.require("sleep_update_2d", dev, (
        ("island", island, (n,), i32), ("overflow", overflow, (n,), u8),
        ("sleeping", b.sleeping, (n,), u8), ("active", b.active, (n,), u8),
        ("body_type", b.body_type, (n,), i32), ("sleep_disabled", b.sleep_disabled, (n,), u8),
        ("lin_vel", b.lin_vel, (n, 2), f32), ("ang_vel", b.ang_vel, (n,), f32),
        ("sleep_timer", b.sleep_timer, (n,), f32),
    ))
    sleep = torch.empty((n,), dtype=u8, device=dev)
    timer = torch.empty((n,), dtype=f32, device=dev)
    lin = torch.empty((n, 2), dtype=f32, device=dev)
    ang = torch.empty((n,), dtype=f32, device=dev)
    all_ready = torch.ones((n,), dtype=i32, device=dev)
    if n == 0:
        return sleep, timer, lin, ang
    build.launch("avian_sleep_update_2d", dev, n, island, overflow, b.sleeping, b.active,
                 b.body_type, b.sleep_disabled, b.lin_vel, b.ang_vel, b.sleep_timer, all_ready,
                 sleep, timer, lin, ang, float(p.lin_t2), float(p.ang_t2), float(p.dt),
                 float(p.time_to_sleep))
    sleep_update_2d.launches += 1
    return sleep, timer, lin, ang


sleep_update_2d.launches = 0
