"""The port's hand-written kernels against their plain PyTorch twins on a
CUDA card. Every test here skips on a machine without one. The file imports
no JAX, so on the card it runs without the suite's conftest:

    python -m pytest tests/torch_cases/cases_cuda.py --noconftest -o addopts="" -q
"""

import contextlib

import numpy as np
import pytest
import torch

from avian_tpu_torch import PhysicsConfig, kernels, physics_step, scenes
from avian_tpu_torch.core.types import BodyType
from avian_tpu_torch.geometry.narrowphase import (PAIR_KERNELS, compute_manifolds,
                                                  manifold_buckets)
from avian_tpu_torch.kernels import box_manifold as ka
from avian_tpu_torch.kernels import collider_aabbs as ke
from avian_tpu_torch.kernels import color_edges as kg
from avian_tpu_torch.kernels import contact_rows as kf
from avian_tpu_torch.kernels import convex_manifold as km
from avian_tpu_torch.kernels import grid_sweep as kb
from avian_tpu_torch.kernels import hull_manifold as kpq
from avian_tpu_torch.kernels import integrate_bodies as kc
from avian_tpu_torch.kernels import pack_constraints as kh
from avian_tpu_torch.kernels import round_manifold as kn
from avian_tpu_torch.kernels import solve_color as kd
from avian_tpu_torch.kernels.run_rank import run_rank, run_rank_twin
from avian_tpu_torch.pipeline import broadphase as bp_m
from avian_tpu_torch.pipeline import contacts as np_m
from avian_tpu_torch.pipeline import sleeping as sleep_m
from avian_tpu_torch.pipeline import solver as sol_m
from avian_tpu_torch.pipeline import solver_body as sb_m
from avian_tpu_torch.pipeline.step import prepare_step

pytestmark = pytest.mark.cuda
CONFIG = PhysicsConfig(substeps=4, shape_pairs=((2, 2), (2, 3)))


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def pile(cuda):
    world, _ = scenes.cube_pile(512, max_contacts=16 * 512, device=cuda)
    for _ in range(30):
        world = physics_step(world, CONFIG)
    return world


@pytest.fixture(scope="module")
def pyramid(cuda):
    """A base-40 2D-profile pyramid (820 boxes) after 12 steps: awake, its
    contacts warm, some of its colors still unsettled."""
    world, _ = scenes.box_pyramid(40, max_contacts=24 * 821, device=cuda)
    for _ in range(12):
        world = physics_step(world, CONFIG)
    return world


@pytest.fixture(scope="module")
def fresh_pyramid(cuda):
    """The same pyramid after 2 steps: most of its constraints are still in
    the overflow color."""
    world, _ = scenes.box_pyramid(40, max_contacts=24 * 821, device=cuda)
    for _ in range(2):
        world = physics_step(world, CONFIG)
    return world


@pytest.fixture(params=["pile", "pyramid"])
def settled(request):
    return request.getfixturevalue(request.param)


def _quats(rng, k):
    q = rng.normal(size=(k, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


@pytest.mark.parametrize("kind", [ka.BOX_BOX, ka.BOX_PLANE])
def test_box_manifold_matches_twin(cuda, kind):
    rng = np.random.default_rng(kind)
    k = 4096
    pa = rng.uniform(-1, 1, (k, 3)).astype(np.float32)
    pb = (pa + rng.uniform(-0.9, 0.9, (k, 3))).astype(np.float32)
    ha = rng.uniform(0.2, 0.7, (k, 3)).astype(np.float32)
    hb = rng.uniform(0.2, 0.7, (k, 3)).astype(np.float32)
    if kind == ka.BOX_PLANE:
        hb[:] = (0.0, 1.0, 0.0)
    args = [torch.from_numpy(x).to(cuda)
            for x in (pa, _quats(rng, k), ha, pb, _quats(rng, k), hb)]
    got = ka.box_manifold(kind, *args)
    want = ka.box_manifold_twin(kind, *args)
    assert torch.equal(got[4], want[4]) and torch.equal(got[5], want[5])
    for x, y in zip(got[:4], want[:4]):
        assert float((x - y).abs().max()) <= 1e-5


def test_box_manifold_matches_twin_on_the_step_s_pairs(cuda, settled):
    """The scenes' own pairs: a pyramid's faces are exactly parallel."""
    w2, pos, quat = bp_m.update_aabbs_and_poses(settled, CONFIG)
    bp = bp_m.broad_phase(w2, CONFIG)
    col = w2.colliders
    buckets = manifold_buckets(col.shape_type, col.params, pos, quat, bp.collider_a,
                               bp.collider_b, bp.valid, CONFIG.shape_pairs)
    assert {b.kind for b in buckets} == {ka.BOX_BOX, ka.BOX_PLANE}
    for b in buckets:
        got, want = ka.box_manifold(b.kind, *b.inputs), ka.box_manifold_twin(b.kind, *b.inputs)
        assert torch.equal(got[4], want[4]) and torch.equal(got[5], want[5])
        for x, y in zip(got[:4], want[:4]):
            assert float((x - y).abs().max()) <= 1e-5


def test_grid_sweep_matches_twin(cuda, settled):
    g = bp_m.grid_entries(bp_m.update_aabbs(settled, CONFIG), CONFIG)
    got = kb.grid_sweep(g.skey, g.sf, g.si, g.window)
    want = kb.grid_sweep_twin(g.skey, g.sf, g.si, g.window)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int((got[0] != 0).sum()) > 0


def test_integrate_bodies_matches_twin(cuda, settled):
    """On the pyramid the locked axes zero rows of the inverse mass and
    inertia in the table."""
    p = prepare_step(settled, CONFIG)
    for mode in (kc.VELOCITIES, kc.POSITIONS):
        got = kc.integrate_bodies(p.s.state, p.table, CONFIG.substep_dt, mode)
        want = kc.integrate_bodies_twin(p.s.state, p.table, CONFIG.substep_dt, mode)
        assert float((got - want).abs().max()) <= 1e-6 * max(1.0, float(want.abs().max()))


def _bouncing(world):
    """The pile with restitution 0.7 on every collider and every dynamic
    body awake and moving down at 3 m/s, so that restitution acts."""
    b = world.bodies
    down = torch.tensor([0.0, -3.0, 0.0], device=b.lin_vel.device)
    dyn = (b.body_type == BodyType.DYNAMIC)[:, None]
    return world.replace(
        bodies=b.replace(lin_vel=b.lin_vel + down * dyn, sleeping=torch.zeros_like(b.sleeping)),
        colliders=world.colliders.replace(
            restitution=torch.full_like(world.colliders.restitution, 0.7)
        ),
    )


@pytest.mark.parametrize(
    "scene,max_colors,bounce",
    [("pile", 12, False), ("pile", 3, False), ("pile", 12, True), ("pyramid", 12, False),
     ("fresh_pyramid", 12, False)],
)
def test_solve_color_matches_twin_and_is_reproducible(cuda, request, scene, max_colors, bounce):
    world = request.getfixturevalue(scene)
    config = PhysicsConfig(substeps=4, shape_pairs=((2, 2), (2, 3)), max_colors=max_colors)
    p = prepare_step(_bouncing(world) if bounce else world, config)
    con, params = p.con, sol_m.solve_params(config)
    if scene == "fresh_pyramid":  # most rows are in the overflow color
        assert int(con.bucket_valid[-1].sum()) > int(con.bucket_valid[:-1].sum())
    modes = (kd.WARM, kd.BIAS, kd.RELAX, kd.RESTITUTION)

    def run(fn, twin):
        # The twin runs on CPU copies: its overflow colour sums with
        # index_add_, whose float atomics on the card add in no fixed order.
        to = (lambda x: x.cpu()) if twin else (lambda x: x)
        state, imp = to(p.s.state).clone(), to(con.imp).clone()
        rows = [to(x) for x in (con.data, con.bucket_a, con.bucket_b, con.bucket_valid,
                                con.relax)]
        for mode in modes:
            if mode == kd.RESTITUTION:
                before = imp.clone()
            for c in range(max_colors):
                tail = () if twin else (con.ovf_order, con.ovf_key)
                fn(mode, c, state, rows[0], imp, *rows[1:], *tail, params)
        return state.cpu(), imp.cpu(), before.cpu()

    runs = [run(kd.solve_color, False) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    state, imp, before = run(kd.solve_color_twin, True)
    assert float((runs[0][0][:, :6] - state[:, :6]).abs().max()) <= 1e-5
    assert float((runs[0][1] - imp).abs().max()) <= 1e-5
    if bounce:
        # The restitution pass changed impulses, so its check is not vacuous.
        assert not torch.equal(runs[0][1][..., :4], runs[0][2][..., :4])


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic mode: ``index_add_`` on the card sums in a
    fixed order."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before)


def _same(got, want, tol=0.0):
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype.is_floating_point:
        equal = (got == want) | (got.isnan() & want.isnan())  # infinities too
        assert float(torch.where(equal, 0.0, (got - want).abs()).max()) <= tol
    else:
        assert torch.equal(got, want)


def test_collider_aabbs_and_cell_keys_match_twin(cuda, settled):
    b, col = settled.bodies, settled.colliders
    args = (b, col, CONFIG.dt, float("inf"), 0.005)
    for x, y in zip(ke.collider_aabbs(*args), ke.collider_aabbs_twin(*args)):
        _same(x, y, 1e-6)
    col2 = bp_m.update_aabbs(settled, CONFIG).colliders
    cell, in_sweep, _ = bp_m.sweep_cell(col2)
    got = ke.cell_keys(b, col2, cell, in_sweep)
    for x, y in zip(got, ke.cell_keys_twin(b, col2, cell, in_sweep)):
        _same(x, y, 1e-6)
    assert int((got[0] != kb.SENTINEL).sum()) >= col.capacity - 1


def test_contact_rows_match_twin(cuda, settled):
    w2, pos, quat = bp_m.update_aabbs_and_poses(settled, CONFIG)
    bp = bp_m.broad_phase(w2, CONFIG)
    col, old = w2.colliders, w2.contacts
    man, _ = compute_manifolds(col.shape_type, col.params, pos, quat, bp.collider_a.long(),
                               bp.collider_b.long(), bp.valid, CONFIG.shape_pairs,
                               w2.convex_verts)
    ks, s = torch.sort(torch.cat([old.pair_key, bp.pair_key]), stable=True)
    hit, survives = kf.contact_join(ks, s, old.capacity)
    for x, y in zip((hit, survives), kf.contact_join_twin(ks, s, old.capacity)):
        _same(x, y)
    assert int((hit > 0).sum()) > 0
    minted = torch.cumsum((bp.valid & (hit == 0)).to(torch.int32), 0, dtype=torch.int32)
    args = (w2.bodies, col, old, bp.valid, bp.collider_a, bp.collider_b, man, hit, survives,
            old.next_contact_id + (minted - 1), np_m.row_params(CONFIG))
    got, want = kf.contact_rows(*args), kf.contact_rows_twin(*args)
    for name in kf.ROW_COLUMNS:
        _same(got[name], want[name], 1e-6)
    assert float(got["normal_impulse"].max()) > 0.0  # impulses were carried


def _flags(world):
    w2, pos, quat = bp_m.update_aabbs_and_poses(world, CONFIG)
    contacts, _ = np_m.narrow_phase(w2, bp_m.broad_phase(w2, CONFIG), CONFIG, poses=(pos, quat))
    s = sb_m.prepare(w2.bodies)
    return w2, contacts, s, kh.constraint_flags(contacts, s.solve_mask)


def test_color_edges_and_buckets_equal_twin(cuda, settled):
    w2, contacts, s, (dyn_a, dyn_b, solve, _) = _flags(settled)
    n = w2.bodies.capacity
    for prev in (contacts.color, None):
        args = (contacts.body_a, contacts.body_b, dyn_a, dyn_b, solve, n, 12, prev)
        got, want = kg.color_edges(*args), kg.color_edges_twin(*args)
        _same(got[0], want[0])
        _same(got[1], want[1])
    assert int(solve.sum()) > 0
    color = got[0]
    for cap in (2 * contacts.capacity // 12, 64):  # roomy, and too small
        got_b = kg.bucket_edges(color, solve, 12, cap)
        want_b = kg.bucket_edges_twin(color, solve, 12, cap)
        for x, y in zip(got_b, want_b):
            _same(x.reshape(-1), y.reshape(-1))
    assert int(want_b[2]) > 0  # the small buckets dropped rows


def test_run_rank_equals_twin(cuda):
    rng = np.random.default_rng(5)
    keys = torch.from_numpy(np.sort(rng.integers(0, 5000, size=200_000)).astype(np.int32))
    keys = keys.to(cuda)
    _same(run_rank(keys), run_rank_twin(keys))


def test_run_rank_equals_twin_on_the_island_table_s_keys(cuda, settled):
    _, contacts, _, _ = _flags(settled)
    keys = sleep_m.island_incidences(settled.bodies, contacts, settled.joints)[1]
    rank = run_rank(keys)
    _same(rank, run_rank_twin(keys))
    assert int(rank.max()) > 0


def test_pack_constraints_match_twin(cuda, settled):
    w2, contacts, s, flags = _flags(settled)
    for x, y in zip(flags, kh.constraint_flags_twin(contacts, s.solve_mask)):
        _same(x, y)
    dyn_a, dyn_b, solve, base_imp = flags
    color, _ = kg.color_edges(contacts.body_a, contacts.body_b, dyn_a, dyn_b, solve,
                              w2.bodies.capacity, 12, contacts.color)
    buckets, valid, _, _ = kg.bucket_edges(color, solve, 12, 2 * contacts.capacity // 12)
    soft = sol_m.contact_softness(CONFIG)
    args = (w2.bodies, contacts, s, dyn_a, dyn_b, solve, base_imp, buckets, valid, *soft)
    got, want = kh.pack_constraints(*args), kh.pack_constraints_twin(*args)
    for x, y in zip(got, want):
        _same(x, y, 1e-6)
    assert int(valid.sum()) == int(solve.sum())


def test_pile_step_launches_every_kernel(cuda):
    world, _ = scenes.cube_pile(216, max_contacts=16 * 216, device=cuda)
    kernels.reset_launches()
    for _ in range(3):
        world = physics_step(world, CONFIG)
    counts = kernels.launches()
    assert counts["grid_sweep"] == 3 and counts["integrate_bodies"] == 3 * 2 * 4
    assert counts["solve_color"] == 3 * (4 * 3 * 12 + 12)
    assert counts["box_manifold"] >= 3
    assert bool(torch.isfinite(world.bodies.pos).all())


def test_pyramid_step_launches_all_eight_kernels(cuda):
    """And K, L and J; a world without joint slots launches no I."""
    world, _ = scenes.box_pyramid(20, max_contacts=24 * 211, device=cuda)
    kernels.reset_launches()
    for _ in range(3):
        world = physics_step(world, CONFIG)
    counts = kernels.launches()
    assert counts["grid_sweep"] == 3 and counts["integrate_bodies"] == 3 * 2 * 4
    assert counts["solve_color"] == 3 * (4 * 3 * 12 + 12)
    assert counts["box_manifold"] == 3 * 2  # box/box and box/plane every step
    assert counts["collider_aabbs"] == 3 * 2 and counts["contact_rows"] == 3 * 2
    assert counts["color_edges"] == 3 * 15 and counts["pack_constraints"] == 3 * 3
    assert counts["body_pass"] == 3 * 2 and counts["compact_pairs"] == 3 * 3
    assert counts["islands"] == 3 * 3 and counts["solve_joints"] == 0
    assert bool(torch.isfinite(world.bodies.pos).all())
    assert float(world.bodies.pos[:, 2].abs().max()) == 0.0  # the Z lock holds


def test_default_device_is_the_card(cuda):
    world, _ = scenes.cube_pile(8)
    assert world.device.type == "cuda"


# ---- Kernels I-L (the hinged-box path) --------------------------------------


@pytest.fixture(scope="module")
def hinges(cuda):
    """10 blocks of 30 x 4 hinged boxes after 40 steps: landed, contacts warm."""
    world, _ = scenes.hinge_blocks(10, max_contacts=16 * 1201, device=cuda)
    for _ in range(40):
        world = physics_step(world, CONFIG)
    return world


@pytest.fixture(params=["pile", "pyramid", "hinges"])
def any_scene(request):
    return request.getfixturevalue(request.param)


def test_body_pass_matches_twin(cuda, any_scene):
    """Kernel K bit for bit, on the scenes and on random bodies with forces,
    constant actuation, locked and free axes and sleepers."""
    from avian_tpu_torch.kernels import body_pass as kk

    rng = np.random.default_rng(11)
    b = any_scene.bodies
    n = b.capacity

    def rand(*shape, lo=-1.0, hi=1.0):
        return torch.from_numpy(rng.uniform(lo, hi, size=shape).astype(np.float32)).to(cuda)

    noisy = b.replace(
        force=rand(n, 3), torque=rand(n, 3), const_force=rand(n, 3),
        const_local_force=rand(n, 3), const_torque=rand(n, 3),
        const_local_torque=rand(n, 3), const_lin_acc=rand(n, 3),
        const_local_lin_acc=rand(n, 3), const_ang_acc=rand(n, 3),
        const_local_ang_acc=rand(n, 3), lin_damping=rand(n, lo=0.0, hi=2.0),
        locked_axes=torch.from_numpy(rng.integers(0, 64, n).astype(np.int32)).to(cuda),
        sleeping=torch.from_numpy(rng.random(n) < 0.2).to(cuda),
        gyroscopic=torch.from_numpy(rng.random(n) < 0.5).to(cuda),
    )
    for bodies in (b, noisy):
        got = kk.prepare_bodies(bodies, any_scene.gravity[None], 1.0 / 240.0)
        want = kk.prepare_bodies_twin(bodies, any_scene.gravity[None], 1.0 / 240.0)
        for x, y in zip(got, want):
            _same(x, y)
        state = got[0].clone()
        state[:, 6:9] = rand(n, 3, lo=-0.01, hi=0.01)
        dq = rand(n, 4, lo=-0.05, hi=0.05)
        dq[:, 3] = 1.0
        state[:, 9:13] = dq / dq.norm(dim=1, keepdim=True)
        for x, y in zip(kk.writeback_bodies(bodies, state),
                        kk.writeback_bodies_twin(bodies, state)):
            _same(x, y)


def _sweep(world):
    w2 = bp_m.update_aabbs(world, CONFIG)
    g = bp_m.grid_entries(w2, CONFIG)
    bits, rank = kb.grid_sweep(g.skey, g.sf, g.si, g.window)
    return w2, g, bits, rank


def test_compact_pairs_match_twin(cuda, any_scene):
    """Kernel L exactly: roomy, and with too few slots for the grid pairs
    (every global pair dropped)."""
    from avian_tpu_torch.kernels import compact_pairs as kl

    w2, g, bits, rank = _sweep(any_scene)
    roomy = bp_m.compaction_args(w2, g, bits, rank)
    got = kl.compact_pairs(*roomy)
    for x, y in zip(got, kl.compact_pairs_twin(*roomy)):
        _same(x, y)
    total = int(got.num_pairs)
    args = roomy[:-1] + (total // 2,)
    got = kl.compact_pairs(*args)
    for x, y in zip(got, kl.compact_pairs_twin(*args)):
        _same(x, y)
    assert total > 100 and int(got.dropped) > 0


def _scrambled_chains(cuda, n_chains=40, length=300, seed=3):
    """Bodies joined into chains in a seeded order of their indices, and a
    hub with 40 spokes: labels that 10 rounds do not converge, and a table
    overflow."""
    from avian_tpu_torch.core.builder import SceneBuilder

    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    g = b.add_body(body_type=BodyType.STATIC)
    b.half_space(g, normal=(0, 1, 0))
    n = n_chains * length + 41
    ids = [b.add_body(pos=(float(k), 5.0, 0.0)) for k in range(n)]
    for i in ids:
        b.box(i, 0.2, 0.2, 0.2)
    order = rng.permutation(n_chains * length)
    for c in range(n_chains):
        chain = order[c * length:(c + 1) * length]
        for a, bb in zip(chain[:-1], chain[1:]):
            b.add_joint(3, ids[a], ids[bb])
    for spoke in ids[-40:]:
        b.add_joint(0, ids[-41], spoke)
    return b.finalize(device=cuda)


def test_islands_match_twin(cuda):
    """Kernel J exactly: the table, 10 Jacobi rounds on chains longer than
    they cover, and the sleep update on random speeds, timers, sleepers and
    teleports."""
    from avian_tpu_torch.kernels import islands as kj

    world = _scrambled_chains(cuda)
    b = world.bodies
    src, skey, order = sleep_m.island_incidences(b, world.contacts, world.joints)
    rank = run_rank(skey)
    got = kj.island_table(src, skey, order, rank, b.capacity)
    want = kj.island_table_twin(src, skey, order, rank, b.capacity)
    _same(got[0], want[0])
    _same(got[1], want[1])
    assert int(got[1].sum()) == 1
    label = kj.island_labels(got[0])
    _same(label, kj.island_labels_twin(got[0]))
    assert len(torch.unique(label)) > 41  # not converged

    rng = np.random.default_rng(4)
    n = b.capacity

    def rand(*shape, lo, hi):
        return torch.from_numpy(rng.uniform(lo, hi, size=shape).astype(np.float32)).to(cuda)

    # Most bodies slow and ready; a few fast, not ready, disabled or teleported.
    sleeping = torch.from_numpy(rng.random(n) < 0.5).to(cuda)
    moved = b.pos + (torch.from_numpy(rng.random((n, 1)) < 0.001).to(cuda)) * 0.1
    fast = torch.from_numpy(rng.random((n, 1)) < 0.001).to(cuda)
    timer = torch.where(torch.from_numpy(rng.random(n) < 0.001).to(cuda), 0.1,
                        rand(n, lo=0.5, hi=1.0))
    noisy = b.replace(
        pos=moved, lin_vel=rand(n, 3, lo=-0.05, hi=0.05) + 3.0 * fast,
        ang_vel=rand(n, 3, lo=-0.05, hi=0.05), sleep_timer=timer, sleeping=sleeping,
        island=label, sleep_disabled=torch.from_numpy(rng.random(n) < 0.001).to(cuda),
    )
    params = kj.SleepParams(0.15 ** 2, 0.15 ** 2, 1.0 / 60.0, 0.5)
    got = kj.sleep_update(noisy, label, got[1], params)
    want = kj.sleep_update_twin(noisy, label, want[1], params)
    for x, y in zip(got, want):
        _same(x, y)
    assert 0 < int(got[0].sum()) < n


def _random_joints(cuda, seed, n_bodies=600, n_joints=1500):
    """Random joints of all five types between random bodies (many sharing a
    body), with limits, twist, compliance and damping, some to the static
    ground; the bodies turned and moved from a seed."""
    from avian_tpu_torch.core.builder import SceneBuilder

    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    g = b.add_body(body_type=BodyType.STATIC)
    b.half_space(g, normal=(0, 1, 0))
    ids = [g]
    for k in range(n_bodies):
        q = rng.normal(size=4)
        i = b.add_body(pos=tuple(rng.uniform(-5, 5, 3) + (0, 8, 0)), quat=tuple(q),
                       locked_axes=int(rng.integers(0, 64)) if k % 7 == 0 else 0)
        b.box(i, *rng.uniform(0.1, 0.5, 3))
        ids.append(i)
    for _ in range(n_joints):
        a, c = rng.choice(len(ids), 2, replace=False)

        def quat():
            q = rng.normal(size=4)
            return tuple(q / np.linalg.norm(q))
        lo = float(rng.uniform(-0.5, 0.0))
        b.add_joint(int(rng.integers(0, 5)), ids[a], ids[c],
                    anchor_a=tuple(rng.uniform(-0.5, 0.5, 3)),
                    anchor_b=tuple(rng.uniform(-0.5, 0.5, 3)), basis_a=quat(), basis_b=quat(),
                    compliance=tuple(rng.choice([0.0, 1e-5, 1e-3], 4)),
                    limit_min=lo, limit_max=lo + float(rng.uniform(0.1, 1.0)),
                    limit_enabled=bool(rng.random() < 0.7), twist_min=-0.1, twist_max=0.2,
                    twist_enabled=bool(rng.random() < 0.5),
                    lin_damping=float(rng.uniform(0, 2)), ang_damping=float(rng.uniform(0, 2)))
    return b.finalize(device=cuda)


@pytest.mark.parametrize("max_colors", [12, 3])
def test_solve_joints_matches_twin_and_is_reproducible(cuda, max_colors):
    """Kernel I through a substep (every color, then the velocities) against
    its twin: the proper colors have one writer a body, the overflow color
    and the damping sum in the kernel's fixed order and in the twin's
    ``index_add_`` order, hence a tolerance. The twin runs on the card in
    PyTorch's deterministic mode, where ``index_add_`` sums in a fixed
    order (on the card its float atomics add in none). A twin run on CPU
    copies is no oracle here: the CPU's ``asin``, ``sin``, ``cos`` and
    ``sqrt`` round differently from libdevice's, which the kernel and the
    twin on the card share, and one substep of the random joints amplifies
    that to 4e-5 of the state's scale, past the tolerance."""
    from avian_tpu_torch.kernels import solve_joints as ki
    from avian_tpu_torch.pipeline import xpbd

    world = _random_joints(cuda, seed=max_colors)
    config = PhysicsConfig(max_colors=max_colors)
    s, _ = sb_m.prepare_with_table(world.bodies, world.gravity, config.substep_dt)
    r_in = (world.joints, world.bodies, s.inv_mass, s.inv_inertia, s.solve_mask)
    for x, y in zip(ki.joint_rows(*r_in), ki.joint_rows_twin(*r_in)):
        _same(x, y)
    jc = xpbd.prepare_joints(world, s, config)
    assert int((jc.color == max_colors - 1).sum()) > 10
    rng = np.random.default_rng(1)
    n = world.bodies.capacity
    state = s.state.clone()
    state[:, 0:6] = torch.from_numpy(rng.uniform(-1, 1, (n, 6)).astype(np.float32)).to(cuda)
    state[:, 6:9] = torch.from_numpy(rng.uniform(-0.02, 0.02, (n, 3)).astype(np.float32)).to(cuda)
    h = config.substep_dt

    def run(color_fn, vel_fn, twin):
        st, lam = state.clone(), jc.lam.clone()
        pre = st[:, 6:13].clone()
        for c in range(max_colors):
            if twin:
                color_fn(c, st, jc.data, lam, jc.jtype, jc.body_a, jc.body_b, jc.color, jc.mask,
                         h * h)
            else:
                color_fn(c, c == max_colors - 1, st, jc.data, lam, jc.jtype, jc.body_a,
                         jc.body_b, jc.color, jc.mask, jc.ovf_order, jc.ovf_key, h * h)
        if twin:
            vel_fn(st, pre, jc.data, jc.body_a, jc.body_b, jc.mask, h)
        else:
            vel_fn(st, pre, jc.data, jc.body_a, jc.body_b, jc.mask, jc.damp_order, jc.damp_key, h)
        return st, lam

    k1 = run(ki.joint_color, ki.joint_velocities, False)
    k2 = run(ki.joint_color, ki.joint_velocities, False)
    assert torch.equal(k1[0], k2[0]) and torch.equal(k1[1], k2[1])
    with deterministic():
        t = run(ki.joint_color_twin, ki.joint_velocities_twin, True)
    scale = float(t[0].abs().max())
    assert float((k1[0] - t[0]).abs().max()) <= 1e-6 * max(1.0, scale)
    assert float((k1[1] - t[1]).abs().max()) <= 1e-6 * max(1.0, float(t[1].abs().max()))
    assert not torch.equal(k1[0], state)


def test_hinges_step_launches_every_kernel(cuda):
    world, _ = scenes.hinge_blocks(5, 6, 4, max_contacts=16 * 121, device=cuda)
    kernels.reset_launches()
    for _ in range(3):
        world = physics_step(world, CONFIG)
    counts = kernels.launches()
    assert counts["solve_joints"] == 3 * (1 + 4 * (12 + 1))
    assert counts["body_pass"] == 3 * 2 and counts["compact_pairs"] == 3 * 3
    assert counts["islands"] == 3 * 3
    assert counts["color_edges"] == 3 * (15 + 13)
    assert bool(torch.isfinite(world.bodies.pos).all())


# ---- Kernels M, N, O (the mixed-shape path) and E on all five shapes -----

SHAPE_PAIRS = tuple((a, b) for a in range(6) for b in range(a, 6) if (a, b) != (3, 3))
SHAPES_CONFIG = PhysicsConfig(substeps=4, shape_pairs=SHAPE_PAIRS)


@pytest.fixture(scope="module")
def shapes(cuda):
    """1,200 spheres, boxes, capsules, cylinders and cones (rows of 20,
    three layers) after 50 steps: landed on the plane and on each other."""
    world, _ = scenes.many_shapes(1200, per_row=20, max_contacts=16 * 1201, device=cuda)
    for _ in range(50):
        world = physics_step(world, SHAPES_CONFIG)
    return world


def _shape_inputs(cuda, pair, k=4096, seed=0):
    rng = np.random.default_rng(seed + 10 * pair[0] + pair[1])

    def prm(shape):
        p = np.zeros((k, 3), np.float32)
        if shape == 3:
            p[:] = (0.0, 1.0, 0.0)
        elif shape == 2:
            p[:] = rng.uniform(0.2, 0.7, (k, 3))
        else:
            p[:, 0], p[:, 1] = rng.uniform(0.2, 0.7, k), rng.uniform(0.2, 0.6, k)
        return p

    pa = rng.uniform(-1, 1, (k, 3)).astype(np.float32)
    pb = (pa + rng.normal(size=(k, 3)) * 0.6).astype(np.float32)
    return [torch.from_numpy(x).to(cuda)
            for x in (pa, _quats(rng, k), prm(pair[0]), pb, _quats(rng, k), prm(pair[1]))]


def _bit_equal(got, want):
    for x, y in zip(got, want):
        assert torch.equal(x, y), float((x.float() - y.float()).abs().max())


@pytest.mark.parametrize("kind", range(len(kn.KINDS)), ids=kn.KINDS)
def test_round_manifold_matches_twin(cuda, kind):
    pair = ((0, 0), (0, 1), (0, 2), (0, 3), (1, 1), (1, 3))[kind]
    args = _shape_inputs(cuda, pair)
    _bit_equal(kn.round_manifold(kind, *args), kn.round_manifold_twin(kind, *args))


@pytest.mark.parametrize("kind", range(len(km.GENERIC_PAIRS)),
                         ids=[f"{a}-{b}" for a, b in km.GENERIC_PAIRS])
def test_convex_manifold_matches_twin(cuda, kind):
    args = _shape_inputs(cuda, km.GENERIC_PAIRS[kind])
    _bit_equal(km.convex_manifold(kind, *args), km.convex_manifold_twin(kind, *args))


@pytest.mark.parametrize("kind", [km.PLANE_CYLINDER, km.PLANE_CONE, km.PLANE_SEGMENT],
                         ids=["cylinder", "cone", "segment"])
def test_plane_patch_manifold_matches_twin(cuda, kind):
    args = _shape_inputs(cuda, (3, km.PLANE_SHAPES[kind]))
    _bit_equal(km.plane_patch_manifold(kind, *args), km.plane_patch_manifold_twin(kind, *args))


def test_shape_buckets_match_twins(cuda, shapes):
    """Every shape-pair bucket of the landed mixed shapes, bit for bit."""
    w2, pos, quat = bp_m.update_aabbs_and_poses(shapes, SHAPES_CONFIG)
    bp = bp_m.broad_phase(w2, SHAPES_CONFIG)
    col = w2.colliders
    buckets = manifold_buckets(col.shape_type, col.params, pos, quat, bp.collider_a,
                               bp.collider_b, bp.valid, SHAPES_CONFIG.shape_pairs)
    assert {b.name for b in buckets} == {"box_manifold", "convex_manifold", "round_manifold",
                                         "plane_patch_manifold"}
    for b in buckets:
        _bit_equal(b.run(), b.run(twin=True))


def test_collider_aabbs_match_twin_on_all_shapes(cuda, shapes):
    b, col = shapes.bodies, shapes.colliders
    args = (b, col, SHAPES_CONFIG.dt, float("inf"), 0.005)
    for x, y in zip(ke.collider_aabbs(*args), ke.collider_aabbs_twin(*args)):
        _same(x, y, 1e-6)
    assert set(col.shape_type.tolist()) == {0, 1, 2, 3, 4, 5}


def test_shapes_step_launches_m_n_o(cuda, shapes):
    kernels.reset_launches()
    world, diag = physics_step(shapes, SHAPES_CONFIG, return_diagnostics=True)
    counts = kernels.launches()
    by_kernel = {}
    for pair in diag["manifold_pairs"]:
        name = PAIR_KERNELS[pair][1]
        by_kernel[name] = by_kernel.get(name, 0) + 1
    for name in ("convex_manifold", "round_manifold", "plane_patch_manifold", "box_manifold"):
        assert counts[name] == by_kernel[name] > 0, (name, counts, by_kernel)
    assert bool(torch.isfinite(world.bodies.pos).all())
    assert float(world.bodies.pos[1:, 1].min()) > 0.0


# ---- Kernels P, Q (the hull-and-terrain path) ---------------------------------


def _hull_params(rng, k, pool, start):
    """``k`` seeded CONVEX shapes appended to ``pool`` (a list of vertex
    blocks) from row ``start``: ellipsoid hulls of 4-32 vertices, box hulls
    (round in half the cases), flat triangles and octahedra. Params
    f32[k, 7]."""
    prm = np.zeros((k, 7), np.float32)
    row = start
    for i in range(k):
        kind, flat, r = int(rng.integers(0, 4)), 0.0, 0.0
        if kind == 0:
            p = rng.normal(size=(int(rng.integers(4, 33)), 3))
            p = p / np.linalg.norm(p, axis=1, keepdims=True) * rng.uniform(0.3, 0.7, 3)
        elif kind == 1:
            e = rng.uniform(0.25, 0.6, 3)
            p = np.asarray([(a * e[0], b * e[1], c * e[2])
                            for a in (-1, 1) for b in (-1, 1) for c in (-1, 1)])
            r = float(rng.choice([0.0, 0.05]))
        elif kind == 2:
            p = rng.uniform(-0.8, 0.8, (3, 3)) * np.asarray([1.0, 0.2, 1.0])
            flat = 1.0
        else:
            s = rng.uniform(0.35, 0.6)
            p = np.concatenate([np.eye(3) * s, -np.eye(3) * s])
        p = (p - p.mean(0)).astype(np.float32)
        h = np.abs(p).max(0) + r
        prm[i] = (row, len(p), h[0], h[1], h[2], flat, r)
        pool.append(p)
        row += len(p)
    return prm


def _hull_inputs(cuda, pair, k=4096, seed=0):
    """``k`` random pairs of ``pair`` (B CONVEX), params [k, 7] and their
    vertex pool (with the builder's 32 zero rows)."""
    rng = np.random.default_rng(seed + 10 * pair[0] + pair[1])
    args = _shape_inputs(cuda, pair[:1] * 2, k, seed)
    blocks = []
    prm_a = np.zeros((k, 7), np.float32)
    if pair[0] == 8:
        prm_a = _hull_params(rng, k, blocks, 0)
    else:
        prm_a[:, :3] = args[2].cpu().numpy()
    prm_b = _hull_params(rng, k, blocks, sum(len(b) for b in blocks))
    pool = np.concatenate(blocks + [np.zeros((32, 3), np.float32)])
    return [args[0], args[1], torch.from_numpy(prm_a).to(cuda), args[3], args[4],
            torch.from_numpy(prm_b).to(cuda), torch.from_numpy(pool).to(cuda)]


@pytest.mark.parametrize("kind", range(len(kpq.HULL_PAIRS)),
                         ids=[f"{a}-{b}" for a, b in kpq.HULL_PAIRS])
def test_hull_manifold_matches_twin(cuda, kind):
    args = _hull_inputs(cuda, kpq.HULL_PAIRS[kind])
    _bit_equal(kpq.hull_manifold(kind, *args), kpq.hull_manifold_twin(kind, *args))


def test_plane_hull_manifold_matches_twin(cuda):
    args = _hull_inputs(cuda, (3, 8))
    rows = args[0].shape[0]
    plane = torch.zeros((rows, 7), device=cuda)
    plane[:, 1] = 1.0
    args[2] = plane
    args[3] = args[0] + torch.tensor([0.0, 0.4, 0.0], device=cuda) * torch.rand(
        (rows, 1), device=cuda, generator=torch.Generator(cuda).manual_seed(1))
    _bit_equal(kpq.plane_hull_manifold(kpq.PLANE_CONVEX, *args),
               kpq.plane_hull_manifold_twin(kpq.PLANE_CONVEX, *args))


@pytest.fixture(scope="module")
def terrain(cuda):
    """700 mixed shapes, rocks and round cuboids on a 21 x 21 heightfield
    (800 triangles) after 40 steps: landed on the triangles."""
    world, _ = scenes.terrain_shapes(700, per_row=16, field=21, max_contacts=24 * 701,
                                     device=cuda)
    for _ in range(40):
        world = physics_step(world, CONFIG.replace(shape_pairs=None))
    return world


def test_terrain_buckets_match_twins(cuda, terrain):
    """Every shape-pair bucket of the landed terrain, bit for bit."""
    config = CONFIG.replace(shape_pairs=None)
    w2, pos, quat = bp_m.update_aabbs_and_poses(terrain, config)
    bp = bp_m.broad_phase(w2, config)
    col = w2.colliders
    buckets = manifold_buckets(col.shape_type, col.params, pos, quat, bp.collider_a,
                               bp.collider_b, bp.valid, terrain.shape_pairs, terrain.convex_verts)
    assert "hull_manifold" in {b.name for b in buckets}
    for b in buckets:
        _bit_equal(b.run(), b.run(twin=True))


def test_terrain_and_hull_stack_steps_launch_p_and_q(cuda, terrain):
    config = CONFIG.replace(shape_pairs=None)
    kernels.reset_launches()
    world, diag = physics_step(terrain, config, return_diagnostics=True)
    hull_buckets = sum(PAIR_KERNELS[p][1] == "hull_manifold" for p in diag["manifold_pairs"])
    assert kernels.launches()["hull_manifold"] == hull_buckets >= 5
    assert bool(torch.isfinite(world.bodies.pos).all())
    stack, ids = scenes.hull_stack(device=cuda)
    kernels.reset_launches()
    for _ in range(30):
        stack = physics_step(stack, config)
    counts = kernels.launches()
    assert counts["plane_hull_manifold"] > 0 and counts["hull_manifold"] > 0, counts
    assert abs(float(stack.bodies.pos[ids[0], 1]) - 0.5) < 0.05


# ---- Kernels R, S, T: swept CCD and the casts ---------------------------------

def _grid_to_cpu(grid):
    from avian_tpu_torch.pipeline import ccd

    return ccd.SweptGrid(type(grid.tab)(*(x.cpu() for x in grid.tab)), grid.swept.cpu(),
                         grid.k_ok, [(pair, flat.cpu()) for pair, flat in grid.buckets])


@pytest.fixture(scope="module")
def bullets(cuda):
    """A 300-body terrain_ccd with 8 bullets after 2 steps (the bullets are
    still in the air), and its swept-CCD grid for a solver state of two
    steps' delta pose at each body's velocity."""
    from avian_tpu_torch.pipeline import ccd

    world, _, shots = scenes.terrain_ccd(300, per_row=12, bullets=8, field=17, device=cuda)
    config = PhysicsConfig(substeps=4, swept_ccd=True, sap_window=64)
    for _ in range(2):
        world = physics_step(world, config)
    w2, pos, quat = bp_m.update_aabbs_and_poses(world, config)
    s = sb_m.prepare(w2.bodies)
    s.state[:, 6:9] = w2.bodies.lin_vel * (2.0 / 60.0)
    from avian_tpu_torch.math import quat as quat_m

    s.state[:, 9:13] = quat_m.from_scaled_axis(w2.bodies.ang_vel * (2.0 / 60.0))
    return ccd.swept_grid(w2, s, pos, quat, config), shots, w2


def test_swept_toi_matches_twin_and_is_reproducible(cuda, bullets):
    """Kernel R over the whole grid against its twin on CPU copies: the
    linear rows (spheres) bit for bit, the nonlinear rows (spinning
    capsules, whose rotation at t the kernel takes through the card's
    sinf/cosf) within 1e-5."""
    from avian_tpu_torch.pipeline import ccd

    grid, shots, w2 = bullets
    assert grid.k_ok == 8
    kernels.reset_launches()
    got = ccd.grid_tois(grid)
    assert kernels.launches()["swept_toi"] == len(grid.buckets) >= 5
    assert torch.equal(got, ccd.grid_tois(grid))
    want = ccd.grid_tois(_grid_to_cpu(grid), twin=True)
    got = got.cpu()
    assert float(got.min()) < 1.0  # some bullet meets something within the sweep
    body = w2.colliders.body_idx[grid.swept[:grid.k_ok].long()].cpu()
    nonlinear = w2.bodies.swept_ccd_nonlinear.cpu()[body]
    _same(got[~nonlinear], want[~nonlinear])
    _same(got[nonlinear], want[nonlinear], 1e-5)


def test_swept_toi_rounds_mark_the_pairs_that_ran_out(cuda, bullets):
    """The kernel's optional rounds: every pair ran 1 to 8 rounds, and a
    pair marked as having run out (negative, valid pairs only) ran all 8 and
    returned a TOI below 1; the TOIs are those of the launch without
    rounds."""
    from avian_tpu_torch.kernels import swept_toi as kr
    from avian_tpu_torch.pipeline import ccd

    grid = bullets[0]
    m = grid.tab.pos0.shape[0]
    toi = torch.ones(grid.k_ok * m, device=cuda)
    rounds = torch.zeros(grid.k_ok * m, dtype=torch.int32, device=cuda)
    for pair, flat in grid.buckets:
        kr.swept_toi(pair, flat, grid.swept[:grid.k_ok].contiguous(), m, grid.tab, toi, rounds)
    assert torch.equal(toi, ccd.grid_tois(grid).reshape(-1))
    launched = torch.cat([flat for _, flat in grid.buckets]).long()
    ran = rounds[launched]
    assert bool(((ran.abs() >= 1) & (ran.abs() <= kr.ROUNDS)).all())
    assert bool((toi[launched][ran < 0] < 1.0).all())
    assert bool((ran[ran < 0] == -kr.ROUNDS).all())


def test_step_launches_r_on_a_moving_swept_body(cuda):
    world, _, _ = scenes.terrain_ccd(300, per_row=12, bullets=4, field=17, device=cuda)
    config = PhysicsConfig(substeps=4, swept_ccd=True, sap_window=64)
    kernels.reset_launches()
    world = physics_step(world, config)
    assert kernels.launches()["swept_toi"] >= 4
    kernels.reset_launches()
    physics_step(world, config.replace(swept_ccd=False))
    assert kernels.launches()["swept_toi"] == 0


@pytest.fixture(scope="module")
def landed(cuda):
    world, _ = scenes.terrain_shapes(300, per_row=12, field=17, device=cuda)
    config = PhysicsConfig(substeps=4, sap_window=64)
    for _ in range(20):
        world = physics_step(world, config)
    return world


CAST_SHAPES = [(0, (0.3,)), (1, (0.3, 0.15)), (2, (0.3, 0.2, 0.4)), (4, (0.3, 0.25)),
               (5, (0.35, 0.3)), (8, None)]


@pytest.mark.parametrize("shape_type,params", CAST_SHAPES)
def test_shape_cast_matches_twin_and_is_reproducible(cuda, landed, shape_type, params):
    """Kernel S on every collider of the landed terrain against its twin on
    a CPU copy, all within 1e-5 (bit for bit where the card rounds as the
    CPU does)."""
    from avian_tpu_torch.queries import QueryFilter, shapecast

    if params is None:  # a rock of the pile, as the query shape
        rock = int(torch.nonzero(landed.colliders.shape_type == 8)[-1])
        params = tuple(landed.colliders.params[rock, :7].tolist())
    args = (shape_type, params, (0.5, 9.0, -1.0), (0.1, 0.2, 0.3, 0.927), (0.05, -1.0, 0.02),
            20.0, QueryFilter())
    kernels.reset_launches()
    got = shapecast.sweep_all(landed, *args)
    assert kernels.launches()["shape_cast"] >= 3
    again = shapecast.sweep_all(landed, *args)
    for x, y in zip(got, again):
        assert torch.equal(x, y)
    want = shapecast.sweep_all(landed.to("cpu"), *args)
    for x, y in zip(got, want):
        _same(x.cpu(), y, 1e-5)
    assert float(got[0].min()) < shapecast.BIG


@pytest.mark.parametrize("solid", [True, False])
def test_ray_cast_matches_twin_and_is_reproducible(cuda, landed, solid):
    """Kernel T for 128 rays (96 down through the pile, 32 level through
    it) on every collider of the landed terrain against its twin on a CPU
    copy."""
    from avian_tpu_torch.queries import QueryFilter, raycast

    rng = np.random.default_rng(5)
    o = np.concatenate([np.stack([rng.uniform(-7, 7, 96), np.full(96, 12.0),
                                  rng.uniform(-7, 7, 96)], 1),
                        np.stack([np.full(32, -9.0), rng.uniform(0.2, 3.0, 32),
                                  rng.uniform(-7, 7, 32)], 1)]).astype(np.float32)
    d = np.concatenate([np.tile([[0.0, -1.0, 0.0]], (96, 1)), np.tile([[1.0, 0.0, 0.0]], (32, 1))])
    d = (d + rng.uniform(-0.05, 0.05, d.shape)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o_t, d_t = torch.from_numpy(o), torch.from_numpy(d)
    kernels.reset_launches()
    got = raycast.all_hits(landed, o_t.to(cuda), d_t.to(cuda), solid, QueryFilter())
    assert kernels.launches()["ray_cast"] >= 6
    again = raycast.all_hits(landed, o_t.to(cuda), d_t.to(cuda), solid, QueryFilter())
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    want = raycast.all_hits(landed.to("cpu"), o_t, d_t, solid, QueryFilter())
    hit = want[0] < raycast.BIG
    assert torch.equal(got[0].cpu() < raycast.BIG, hit) and int(hit.sum()) > 100
    _same(got[0].cpu()[hit], want[0][hit], 1e-5)
    _same(got[1].cpu()[hit], want[1][hit], 1e-5)


# ---- the native 2D engine: Kernels U-Z ------------------------------------

DIM2_CONFIG = PhysicsConfig(substeps=4, max_colors=8)


@pytest.fixture(scope="module", params=[2, 12])
def dim2_pyramid(cuda, request):
    """A base-40 2D pyramid (820 boxes) at 24 contact slots a box after 2
    steps (most rows in the overflow colour) and after 12."""
    from avian_tpu_torch.dim2 import physics_step_2d, scenes as scenes2d

    world, _ = scenes2d.box_pyramid_2d(40, max_contacts=24 * 821, device=cuda)
    for _ in range(request.param):
        world = physics_step_2d(world, DIM2_CONFIG)
    return world


def _dim2_stages(world):
    """This step's inputs of every 2D kernel, on the card."""
    from avian_tpu_torch.dim2 import broadphase as bp2, contacts as nc2, dynamics as dyn2
    from avian_tpu_torch.dim2 import solver as sol2

    poses = bp2.collider_poses(world)
    world = bp2.update_aabbs(world, DIM2_CONFIG, poses)
    bp = bp2.broad_phase(world, DIM2_CONFIG)
    contacts = nc2.narrow_phase(world, bp, DIM2_CONFIG, poses)
    s, table = dyn2.prepare(world.bodies, world.gravity, DIM2_CONFIG.substep_dt)
    con = sol2.prepare_constraints(world, contacts, s, DIM2_CONFIG)
    return world, poses, bp, contacts, s, table, con


def test_grid_pairs_2d_matches_twin(cuda, dim2_pyramid):
    from avian_tpu_torch.dim2 import broadphase as bp2
    from avian_tpu_torch.kernels import grid_pairs_2d as ku

    world = bp2.update_aabbs(dim2_pyramid, DIM2_CONFIG, bp2.collider_poses(dim2_pyramid))
    args = bp2.grid_pair_inputs(world, DIM2_CONFIG)
    got, want = ku.grid_pairs_2d(*args), ku.grid_pairs_2d_twin(*args)
    for x, y in zip(got, want):
        _same(x, y)
    assert int(got.num_pairs) > 2000 and int(got.dropped) == 0
    skey, _, sf, si, w, col, g_idx, g_valid = args[:8]
    for x, y in zip(ku.grid_counts_2d(skey, sf, si, w, col, g_idx, g_valid),
                    ku.grid_counts_2d_twin(skey, sf, si, w, col, g_idx, g_valid)):
        _same(x, y)


def test_prepare_2d_writeback_2d_and_sleep_update_2d_match_twins(cuda, dim2_pyramid):
    """Z's prologue bitwise; K's 2D writeback at 1e-6 (``cosf``/``sinf`` of
    the new angle in the kernel); J's 2D sleep update bitwise."""
    from avian_tpu_torch.kernels import body_pass as kk, integrate_2d as kz, islands as kj
    from avian_tpu_torch.pipeline.sleeping import compute_islands

    world, _, _, contacts, _, _, _ = _dim2_stages(dim2_pyramid)
    b, h = world.bodies, DIM2_CONFIG.substep_dt
    got = kz.prepare_2d(b, world.gravity, h)
    for x, y in zip(got, kz.prepare_2d_twin(b, world.gravity, h)):
        _same(x, y)
    moved = kz.integrate_2d(kz.integrate_2d(got[0], got[4], h, kz.VELOCITIES), got[4], h,
                            kz.POSITIONS)
    wb = kk.writeback_2d(b, moved)
    for x, y in zip(wb, kk.writeback_2d_twin(b, moved)):
        _same(x, y, 1e-6)
    b = b.replace(pos=wb[0], angle=wb[1], lin_vel=wb[2], ang_vel=wb[3])
    island, overflow = compute_islands(b, contacts, world.joints)
    cfg = DIM2_CONFIG
    lin_t = cfg.sleep_linear_threshold * cfg.length_unit
    params = kj.SleepParams(lin_t * lin_t, cfg.sleep_angular_threshold ** 2, cfg.dt,
                            cfg.time_to_sleep)
    for timer in (b.sleep_timer, torch.full_like(b.sleep_timer, 10.0)):
        args = (b.replace(sleep_timer=timer), island, overflow, params)
        for x, y in zip(kj.sleep_update_2d(*args), kj.sleep_update_2d_twin(*args)):
            _same(x, y)


def test_manifold_2d_matches_twin(cuda, dim2_pyramid):
    """On the step's pairs and on 4,096 random pairs of every kind: bitwise."""
    from avian_tpu_torch.kernels import manifold_2d as kv
    from random_pairs_2d import random_pairs

    world, poses, bp, *_ = _dim2_stages(dim2_pyramid)
    col = world.colliders
    args = (bp.collider_a.long(), bp.collider_b.long(), poses.pos, poses.cs, col.poly_verts,
            col.vert_count, col.radius, col.is_plane)
    for got, want in zip(kv.manifold_2d(*args), kv.manifold_2d_twin(*args)):
        _same(got, want)
    ca, cb, t = random_pairs(4096, 3, device=cuda)
    cs = torch.stack([torch.cos(t["angle"]), torch.sin(t["angle"])], -1).contiguous()
    args = (ca, cb, t["pos"], cs, t["verts"], t["count"], t["radius"], t["plane"])
    for got, want in zip(kv.manifold_2d(*args), kv.manifold_2d_twin(*args)):
        _same(got, want)


def test_contact_rows_2d_and_pack_2d_match_twins(cuda, dim2_pyramid):
    from avian_tpu_torch.dim2 import contacts as nc2
    from avian_tpu_torch.kernels import contact_rows_2d as kw, manifold_2d as kv, pack_2d as kx
    from avian_tpu_torch.pipeline.solver import contact_softness

    world, poses, bp, contacts, s, _, con = _dim2_stages(dim2_pyramid)
    col, old = world.colliders, world.contacts
    man = kv.manifold_2d(bp.collider_a.long(), bp.collider_b.long(), poses.pos, poses.cs,
                         col.poly_verts, col.vert_count, col.radius, col.is_plane)
    ks, order = torch.sort(torch.cat([old.pair_key, bp.pair_key]), stable=True)
    hit, survives = kf.contact_join(ks, order, old.capacity)
    rank = torch.cumsum((bp.valid & (hit == 0)).to(torch.int32), 0, dtype=torch.int32) - 1
    args = (world.bodies, poses.body_cs, col, old, bp.valid, bp.collider_a, bp.collider_b, man,
            hit, survives, rank, nc2.row_params(DIM2_CONFIG))
    got, want = kw.contact_rows_2d(*args), kw.contact_rows_2d_twin(*args)
    for name in kw.ROW_COLUMNS:
        _same(got[name], want[name].to(got[name].dtype))

    ba, bb = contacts.body_a.long(), contacts.body_b.long()
    dyn_a, dyn_b = s.solve_mask[ba] > 0, s.solve_mask[bb] > 0
    solve = contacts.active & contacts.touching & ~contacts.is_sensor & (dyn_a | dyn_b)
    args = (world.bodies, contacts, s.state, s.inv_mass, s.inv_inertia, dyn_a, dyn_b, solve,
            con.buckets, con.bucket_valid, *contact_softness(DIM2_CONFIG))
    for got, want in zip(kx.pack_2d(*args), kx.pack_2d_twin(*args)):
        _same(got, want)


@pytest.mark.parametrize("bounce", [False, True])
def test_solve_2d_and_integrate_2d_match_twins_and_are_reproducible(cuda, dim2_pyramid, bounce):
    """One substep and a restitution pass. The twin runs on CPU copies (its
    overflow colour sums with ``index_add_``); the bias and relax modes take
    ``cosf``/``sinf`` in the kernel: 1e-5."""
    from avian_tpu_torch.dim2 import solver as sol2
    from avian_tpu_torch.kernels import integrate_2d as kz, solve_2d as ky

    world = dim2_pyramid
    if bounce:
        b = world.bodies
        world = world.replace(
            bodies=b.replace(lin_vel=b.lin_vel + torch.tensor([0.0, -3.0], device=cuda)),
            colliders=world.colliders.replace(
                restitution=torch.full_like(world.colliders.restitution, 0.7)))
    world, _, _, _, s, table, con = _dim2_stages(world)
    h = DIM2_CONFIG.substep_dt
    params = sol2.solve_params(DIM2_CONFIG)
    for mode in (kz.VELOCITIES, kz.POSITIONS):
        _same(kz.integrate_2d(s.state, table, h, mode), kz.integrate_2d_twin(s.state, table, h, mode))

    def run(twin):
        to = (lambda x: x.cpu()) if twin else (lambda x: x)
        state, imp = to(s.state).clone(), to(con.imp).clone()
        rows = [to(x) for x in (con.data, con.bucket_a, con.bucket_b, con.bucket_valid,
                                con.relax)]
        for mode in (ky.WARM, ky.BIAS, ky.RELAX, ky.RESTITUTION):
            for c in range(DIM2_CONFIG.max_colors):
                if twin:
                    ky.solve_2d_twin(mode, c, state, rows[0], imp, *rows[1:], params)
                else:
                    ky.solve_2d(mode, c, state, rows[0], imp, *rows[1:], con.ovf_order,
                                con.ovf_key, params)
        return state.cpu(), imp.cpu()

    runs = [run(False) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    state, imp = run(True)
    assert float((runs[0][0] - state).abs().max()) <= 1e-5
    assert float((runs[0][1] - imp).abs().max()) <= 1e-5
    if bounce:
        assert float(imp[..., 4:6].abs().max()) > 0.0


def test_dim2_step_launches_u_to_z_and_reruns_equal(cuda):
    from avian_tpu_torch.dim2 import physics_step_2d, scenes as scenes2d

    runs = []
    for _ in range(2):
        world, _ = scenes2d.box_pyramid_2d(20, max_contacts=24 * 211, device=cuda)
        kernels.reset_launches()
        for _ in range(3):
            world = physics_step_2d(world, DIM2_CONFIG)
        runs.append(world)
        got = kernels.launches()
        cfg = DIM2_CONFIG
        assert got["grid_pairs_2d"] == 3 and got["compact_pairs"] == 2 * 3
        assert got["manifold_2d"] == 3
        assert got["contact_rows_2d"] == 3 and got["pack_2d"] == 2 * 3
        assert got["solve_2d"] == 3 * (3 * cfg.substeps + 1) * cfg.max_colors
        assert got["integrate_2d"] == 3 * 2 * cfg.substeps
        assert got["prepare_2d"] == got["writeback_2d"] == got["sleep_update_2d"] == 3
    for name in ("pos", "angle", "lin_vel", "ang_vel"):
        assert torch.equal(getattr(runs[0].bodies, name), getattr(runs[1].bodies, name))


@pytest.mark.parametrize("colors", [8, 2])
def test_solve_joints_2d_matches_twins_and_is_reproducible(cuda, colors):
    """Kernel AA on ``hinge_blocks_2d(4)`` after 5 steps: the rows bitwise
    (the cosines come in); one substep of every colour, the projection and
    the damping against the twins within 1e-5 (``cosf``/``sinf``/``atan2f``
    in the kernel; the twins' shared-body sums are in the kernel's order);
    at 2 colours every joint is put in the overflow colour, where a row's
    joints share its boxes. Two runs bitwise equal."""
    from avian_tpu_torch.dim2 import physics_step_2d, scenes as scenes2d, xpbd as xpbd2
    from avian_tpu_torch.dim2 import step as step2
    from avian_tpu_torch.kernels import solve_joints_2d as kaa
    from shared_2d import all_in_overflow, joint_substep

    config = DIM2_CONFIG.replace(max_colors=colors)
    world, _ = scenes2d.hinge_blocks_2d(4, max_contacts=16 * 481, device=cuda)
    for _ in range(5):
        world = physics_step_2d(world, config)
    p = step2.substepped(world, config)
    j, s = p.world.joints, p.s
    axis_cs = torch.stack([torch.cos(j.axis_angle), torch.sin(j.axis_angle)], -1).contiguous()
    args = (j, p.world.bodies, p.poses.body_cs, axis_cs, s.inv_mass, s.inv_inertia, s.solve_mask)
    for x, y in zip(kaa.joint_rows_2d(*args), kaa.joint_rows_2d_twin(*args)):
        _same(x, y)
    jc = xpbd2.prepare_joints(p.world, s, p.poses, config)
    if colors == 2:
        jc = all_in_overflow(jc, colors, s.state.shape[0])
    h = config.substep_dt
    runs = [joint_substep(jc, colors, h, False, s.state.clone(), jc.lam.clone())
            for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    want = joint_substep(jc, colors, h, True, s.state.clone(), jc.lam.clone())
    _same(runs[0][0], want[0], 1e-5)
    _same(runs[0][1], want[1], 1e-5 * max(1.0, float(want[1].abs().max())))
    if colors == 2:
        ends = torch.cat([jc.body_a, jc.body_b])[torch.cat([jc.color_j, jc.color_j]) == 1]
        assert ends.numel() > torch.unique(ends).numel()


def test_swept_toi_2d_matches_twin_and_is_reproducible(cuda):
    """Kernel AB on ``pyramid_ccd_2d(20, 8)``'s grid of step 3: pairs where
    neither collider turns along its sweep bitwise, the rest within 1e-5
    (``cosf``/``sinf`` in the kernel), the body minima likewise; a rerun
    bitwise; a pair whose rounds ran out returned t < 1."""
    from avian_tpu_torch.dim2 import ccd as ccd2, physics_step_2d, scenes as scenes2d
    from avian_tpu_torch.dim2 import step as step2
    from avian_tpu_torch.kernels import swept_toi_2d as kab

    config = DIM2_CONFIG.replace(swept_ccd=True)
    world, _, shots = scenes2d.pyramid_ccd_2d(20, 8, max_contacts=24 * 219, device=cuda)
    for _ in range(2):
        world = physics_step_2d(world, config)
    p = step2.substepped(world, config)
    tab, swept = ccd2.swept_tables(p.world, p.s, p.poses, config)
    assert swept.numel() == len(shots)
    n = world.bodies.capacity
    rounds = torch.zeros((swept.numel() * tab.pos0.shape[0],), dtype=torch.int32, device=cuda)
    toi, body_toi = kab.swept_toi_2d(swept, tab, n, rounds)
    again = kab.swept_toi_2d(swept, tab, n)
    assert torch.equal(toi, again[0]) and torch.equal(body_toi, again[1])
    want, want_body = kab.swept_toi_2d_twin(swept, tab, n)
    still = ((tab.dang[swept.long()][:, None] == 0) & (tab.dang[None, :] == 0)).reshape(-1)
    _same(toi[still], want[still])
    _same(toi, want, 1e-5)
    _same(body_toi, want_body, 1e-5)
    assert bool((toi[rounds < 0] < 1.0).all()) and int((toi < 1.0).sum()) > 0


def test_dim2_step_launches_aa_and_ab(cuda):
    from avian_tpu_torch.dim2 import physics_step_2d, scenes as scenes2d

    cfg = DIM2_CONFIG
    world, _ = scenes2d.hinge_blocks_2d(2, max_contacts=16 * 241, device=cuda)
    kernels.reset_launches()
    for _ in range(3):
        world = physics_step_2d(world, cfg)
    got = kernels.launches()
    assert got["solve_joints_2d"] == 3 * (1 + cfg.substeps * (cfg.max_colors + 1))
    assert got["swept_toi_2d"] == 0
    cfg = cfg.replace(swept_ccd=True)
    world, _, _ = scenes2d.pyramid_ccd_2d(10, 4, max_contacts=24 * 60, device=cuda)
    kernels.reset_launches()
    for _ in range(3):
        world = physics_step_2d(world, cfg)
    got = kernels.launches()
    assert got["swept_toi_2d"] == 3 and got["solve_joints_2d"] == 0


def test_batched_step_kernels_match_twins_and_scenes_alone(cuda):
    """32 jittered ``cube_pile(27)`` scenes through ``make_batched_step``:
    Kernels E, B, L and K at the flat world's shapes against their twins (no
    pair across two scenes), and 3 scenes stepped alone bit for bit their
    batched copies; the batched step reads the host no more often than a
    single world's."""
    import warnings

    from avian_tpu_torch.kernels import body_pass as kk
    from avian_tpu_torch.kernels import compact_pairs as kl
    from avian_tpu_torch.parallel import make_batched_step, replicate_world
    from avian_tpu_torch.parallel.sharding import flatten

    config = PhysicsConfig(substeps=4, max_colors=4, sap_window=8, shape_pairs=((2, 2), (2, 3)))
    single, _ = scenes.cube_pile(27, max_contacts=216, device=cuda)
    jitter = torch.from_numpy(
        (1.0 + 0.1 * np.random.default_rng(3).standard_normal(32)).astype(np.float32)).to(cuda)
    batched = replicate_world(single, 32)
    batched = batched.replace(gravity=batched.gravity * jitter[:, None])
    start = batched
    step = make_batched_step(config)
    for _ in range(12):
        batched = step(batched)
    flat = bp_m.update_aabbs(flatten(batched), config)
    cell, in_sweep, _ = bp_m.sweep_cell(flat.colliders, 32)
    k_in = (flat.bodies, flat.colliders, cell, in_sweep)
    for x, y in zip(ke.cell_keys(*k_in), ke.cell_keys_twin(*k_in)):
        assert torch.equal(x, y)
    g = bp_m.grid_entries(flat, config)
    bits, rank = kb.grid_sweep(g.skey, g.sf, g.si, g.window)
    want = kb.grid_sweep_twin(g.skey, g.sf, g.si, g.window)
    assert torch.equal(bits, want[0]) and torch.equal(rank, want[1])
    args = bp_m.compaction_args(flat, g, bits, rank)
    pairs = kl.compact_pairs(*args)
    for x, y in zip(pairs, kl.compact_pairs_twin(*args)):
        assert torch.equal(x, y)
    m = single.colliders.capacity
    assert torch.equal((pairs.collider_a // m)[pairs.valid], (pairs.collider_b // m)[pairs.valid])
    assert int(pairs.valid.sum()) > 32 * 27
    for x, y in zip(kk.prepare_bodies(flat.bodies, flat.gravity, config.substep_dt),
                    kk.prepare_bodies_twin(flat.bodies, flat.gravity, config.substep_dt)):
        assert torch.equal(x, y)

    def reads(fn):
        """``(fn(), the host reads the port's own code made)``: a read whose
        stack holds no frame of ``avian_tpu_torch`` (the first call in sync
        debug mode makes one inside ``torch.cuda``) is not the step's."""
        import traceback

        torch.cuda.synchronize()
        sites = []

        def record(message, *args, **kwargs):
            if "synchroniz" in str(message) and any(
                    "avian_tpu_torch" in f.filename for f in traceback.extract_stack()):
                sites.append(str(message))

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return out, len(sites)

    for sid in (0, 17, 31):
        world = start.replace(
            **{group: getattr(start, group).replace(**{
                k: v[sid].clone() for k, v in vars(getattr(start, group)).items()})
               for group in ("bodies", "colliders", "contacts", "joints")},
            gravity=start.gravity[sid].clone(), time=start.time[sid].clone(),
            diverged=start.diverged[sid].clone(), convex_verts=start.convex_verts[sid].clone())
        for _ in range(12):
            world = physics_step(world, config)
        assert torch.equal(world.bodies.pos, batched.bodies.pos[sid])
        assert torch.equal(world.contacts.pair_key, batched.contacts.pair_key[sid])
    _, batched_reads = reads(lambda: step(batched))
    _, alone_reads = reads(lambda: physics_step(world, config))
    assert 0 < batched_reads <= alone_reads  # the early-out's read, at least
