"""The batched scene step (``avian_tpu_torch.parallel``) against the JAX
reference's ``replicate_world`` and ``jax.vmap`` of its step, and against
each scene stepped alone by the port: the batched world's leaves, 4
domain-randomized 27-cube piles for 60 steps through the sleep onset, 20
piles with more ground planes than ``MAX_GLOBALS``, a NaN in one scene, a
scene whose fast body widens its cells, 3 hinged scenes, and what the step
refuses, and the overflow colour's counts split by scene. The reference's runs are read from ``batched_reference.npz``
(``port_common.Recording``; rerecord with ``record_references.py
cases_batched.py``); its ``replicate_world`` runs live."""

from port_common import ieee_reference

ieee_reference()

import dataclasses  # noqa: E402
import functools  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from avian_tpu import scenes as jscenes  # noqa: E402
from avian_tpu.core.config import PhysicsConfig as JConfig  # noqa: E402
from avian_tpu.parallel import replicate_world as j_replicate  # noqa: E402
from avian_tpu.pipeline.step import physics_step as j_step  # noqa: E402
from avian_tpu_torch import PhysicsConfig, World, physics_step, scenes  # noqa: E402
from avian_tpu_torch.parallel import (  # noqa: E402
    gather_metrics, make_batched_step, replicate_world)
from avian_tpu_torch.parallel.sharding import flatten  # noqa: E402
from avian_tpu_torch.pipeline import broadphase as bp_m  # noqa: E402

from port_common import PAIRS, Recording, assert_worlds_equal, to_torch  # noqa: E402

RECORDING = Recording("batched")
GROUPS = ("bodies", "colliders", "contacts", "joints")
# The bench's batched cell (bench.py:128-162): cube_pile(27) at 8 N.
CUBES, SLOTS, SCENES, STEPS = 27, 216, 4, 60
HELD_STEPS = 20  # 1e-4 m against the reference; 1e-3 m (golden_common) to STEPS
DIAG = ("num_pairs", "dropped_pairs", "overflow_dropped", "num_overflow", "num_touching",
        "num_contact_points", "num_sleeping", "nonfinite_bodies")


def _configs():
    kw = dict(substeps=4, max_colors=4, sap_window=8, shape_pairs=PAIRS)
    return JConfig(**kw), PhysicsConfig(**kw)


def _gravity_jitter(b, seed=0):
    """1 + 0.1 N(0, 1) per scene, as the bench and the example jitter it."""
    return (1.0 + 0.1 * np.random.default_rng(seed).standard_normal(b)).astype(np.float32)


def _jittered(world, jitter):
    return world.replace(gravity=world.gravity * torch.from_numpy(jitter)[:, None])


def _scene(batched, i):
    """Scene ``i`` of a batched world as a world of its own."""
    def group(g):
        return g.replace(**{f.name: getattr(g, f.name)[i].clone()
                            for f in dataclasses.fields(g)})

    return batched.replace(
        **{name: group(getattr(batched, name)) for name in GROUPS},
        **{k: getattr(batched, k)[i].clone()
           for k in ("gravity", "time", "diverged", "convex_verts")})


def _same(got, want):
    """Equal dtype, shape and values, NaN where the other has NaN."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    same = got == want
    if got.is_floating_point():
        same = same | (got.isnan() & want.isnan())
    return bool(same.all())


def _assert_scene_equal(batched, i, single, what):
    for name in GROUPS:
        for f in dataclasses.fields(getattr(single, name)):
            got = getattr(getattr(batched, name), f.name)[i]
            assert _same(got, getattr(getattr(single, name), f.name)), \
                f"{what}: scene {i} {name}.{f.name}"
    for k in ("gravity", "time", "diverged", "convex_verts"):
        assert _same(getattr(batched, k)[i], getattr(single, k)), f"{what}: scene {i} {k}"


def test_batched_world_converts_leaf_for_leaf():
    """(a) The JAX ``replicate_world`` of ``cube_pile(8)`` converts with the
    batched ``World.from_numpy``/``to_numpy`` leaf for leaf, equal to the
    port's ``replicate_world``: real copies, scene-local indices, each
    scene's pair keys with its own M."""
    jw = jscenes.cube_pile(8, max_contacts=64)[0]
    ref = RECORDING((jw, 5), lambda: j_replicate(jw, 5), live=True)
    port = replicate_world(to_torch(jw), 5)
    assert_worlds_equal(j_replicate(jw, 5), port)
    back = World.from_numpy(jax.tree.map(np.asarray, j_replicate(jw, 5)), device="cpu")
    port_np = port.to_numpy()
    for name in GROUPS:
        for f in dataclasses.fields(getattr(port, name)):
            got, want = getattr(getattr(back, name), f.name), getattr(getattr(port, name), f.name)
            assert _same(got, want), f"{name}.{f.name}"
            np.testing.assert_array_equal(port_np[name][f.name], ref[name][f.name],
                                          err_msg=f"{name}.{f.name}")
    assert tuple(port.bodies.pos.shape) == (5, 9, 3) and tuple(port.gravity.shape) == (5, 3)
    assert port.bodies.pos.stride()[0] == 9 * 3  # no stride-0 view
    # Only the copy that is written changes.
    port.bodies.pos[1, 1, 0] += 1.0
    assert float(port.bodies.pos[0, 1, 0]) != float(port.bodies.pos[1, 1, 0])


def _ref_run(jb, jcfg, steps):
    step = jax.jit(jax.vmap(lambda w: j_step(w, jcfg, return_diagnostics=True)))
    pos, diags = [], {k: [] for k in DIAG}
    for _ in range(steps):
        jb, d = step(jb)
        pos.append(np.asarray(jb.bodies.pos))
        for k in DIAG:
            diags[k].append(np.asarray(d[k]))
    return {"pos": np.stack(pos), "diag": {k: np.stack(v) for k, v in diags.items()}}


@functools.cache
def _piles():
    """The batched run of the 4 piles: (start, worlds after each step, the
    diagnostics of each step) and the reference's run."""
    jcfg, tcfg = _configs()
    jw = jscenes.cube_pile(CUBES, max_contacts=SLOTS)[0]
    jitter = _gravity_jitter(SCENES)
    jb = j_replicate(jw, SCENES)
    jb = jb.replace(gravity=jb.gravity * jitter[:, None])
    ref = RECORDING((jb, repr(jcfg), STEPS), lambda: _ref_run(jb, jcfg, STEPS))
    start = _jittered(replicate_world(to_torch(jw), SCENES), jitter)
    step = make_batched_step(tcfg)
    worlds, diags = [], []
    world = start
    for _ in range(STEPS):
        world, d = step(world, return_diagnostics=True)
        worlds.append(world)
        diags.append(d)
    return start, worlds, diags, ref


def _first_asleep(num_sleeping):
    """Per scene, the first step (1-based) after which every body sleeps."""
    asleep = np.asarray(num_sleeping) == CUBES
    return [int(np.argmax(asleep[:, i])) + 1 if asleep[:, i].any() else -1
            for i in range(asleep.shape[1])]


def test_piles_follow_the_vmapped_reference():
    """(b) 4 piles with seeded gravity jitter against ``jax.vmap`` of the
    reference: within 1e-4 m and the same per-scene diagnostics for 20
    steps, within golden_common's 1e-3 m to step 60, and each scene's first
    all-asleep step the reference's."""
    _, worlds, diags, ref = _piles()
    for t in range(STEPS):
        err = float(np.abs(worlds[t].bodies.pos.numpy() - ref.pos[t]).max())
        assert err <= (1e-4 if t < HELD_STEPS else 1e-3), (t + 1, err)
        if t < HELD_STEPS:
            for k in DIAG:
                np.testing.assert_array_equal(diags[t][k].numpy(), ref.diag[k][t],
                                              err_msg=f"step {t + 1} {k}")
                assert tuple(diags[t][k].shape) == (SCENES,)
    port_sleep = np.stack([d["num_sleeping"].numpy() for d in diags])
    first = _first_asleep(port_sleep)
    assert first == _first_asleep(ref.diag["num_sleeping"]), first
    assert min(first) > 0 and len(set(first)) > 1  # the scenes fall asleep apart
    assert max(int(d["dropped_pairs"].max()) for d in diags) == 0
    assert max(int(d["overflow_dropped"].max()) for d in diags) == 0
    mean = gather_metrics(diags[0])
    assert float(mean["num_pairs"]) == float(diags[0]["num_pairs"].float().mean())


def test_piles_equal_each_scene_stepped_alone():
    """(c) The same 4 scenes, 60 steps through the sleep onset, bit for bit
    equal to each scene stepped alone by ``physics_step`` (every leaf), and
    the same scenes taking the early-out at every step: nothing in the flat
    world is reduced across scenes in floating point."""
    start, worlds, diags, _ = _piles()
    _, tcfg = _configs()
    singles = [_scene(start, i) for i in range(SCENES)]
    mixed = 0
    for t in range(STEPS):
        stepped = []
        for i in range(SCENES):
            singles[i], d = physics_step(singles[i], tcfg, return_diagnostics=True)
            stepped.append(d["stepped"])
            _assert_scene_equal(worlds[t], i, singles[i], f"step {t + 1}")
        assert diags[t]["stepped"].tolist() == stepped, t + 1
        mixed += len(set(stepped)) > 1
    assert mixed > 0  # some steps had scenes asleep beside scenes stepping


def test_more_planes_than_max_globals_pair_within_each_scene():
    """(d) 20 scenes of ``cube_pile(2)`` at identical positions: 20 ground
    planes, more than ``MAX_GLOBALS``. Each scene's pairs are its single
    world's, none is dropped, none joins two scenes."""
    _, tcfg = _configs()
    single, _ = scenes.cube_pile(2, max_contacts=16, device="cpu")
    b = 20
    assert b > bp_m.MAX_GLOBALS
    batched = replicate_world(single, b)
    flat = bp_m.update_aabbs(flatten(batched), tcfg)
    pairs = bp_m.broad_phase(flat, tcfg)
    m = single.colliders.capacity
    a, c = pairs.collider_a[pairs.valid], pairs.collider_b[pairs.valid]
    assert torch.equal(a // m, c // m) and int(pairs.valid.sum()) > 0
    want = bp_m.broad_phase(bp_m.update_aabbs(single, tcfg), tcfg)
    assert pairs.dropped.tolist() == [0] * b
    assert pairs.num_pairs.tolist() == [int(want.num_pairs)] * b
    for s in range(b):
        rows = slice(s * want.valid.shape[0], (s + 1) * want.valid.shape[0])
        assert torch.equal(pairs.valid[rows], want.valid)
        assert torch.equal(pairs.collider_a[rows] - s * m, want.collider_a)
        assert torch.equal(pairs.collider_b[rows] - s * m, want.collider_b)
    step = make_batched_step(tcfg)
    for _ in range(8):
        batched, d = step(batched, return_diagnostics=True)
        single, ds = physics_step(single, tcfg, return_diagnostics=True)
        assert d["dropped_pairs"].tolist() == [0] * b
        assert d["num_pairs"].tolist() == [int(ds["num_pairs"])] * b
    for s in range(b):
        _assert_scene_equal(batched, s, single, "8 steps")


def test_nan_in_one_scene_freezes_that_scene_alone():
    """(e) A non-finite velocity in scene 2 of 4: that scene keeps its state,
    is flagged diverged and counts its bad body; the others step as alone."""
    _, tcfg = _configs()
    single, _ = scenes.cube_pile(8, max_contacts=64, device="cpu")
    batched = _jittered(replicate_world(single, 4), _gravity_jitter(4, seed=1))
    vel = batched.bodies.lin_vel.clone()
    vel[2, 3, 1] = float("nan")
    batched = batched.replace(bodies=batched.bodies.replace(lin_vel=vel))
    start = batched
    batched, d = make_batched_step(tcfg)(batched, return_diagnostics=True)
    assert d["diverged"].tolist() == [False, False, True, False]
    assert d["nonfinite_bodies"].tolist()[2] > 0 and d["nonfinite_bodies"].tolist()[0] == 0
    frozen = _scene(start, 2)
    frozen = frozen.replace(time=frozen.time + tcfg.dt, diverged=torch.ones((), dtype=torch.bool))
    _assert_scene_equal(batched, 2, frozen, "frozen")
    for i in (0, 1, 3):
        _assert_scene_equal(batched, i, physics_step(_scene(start, i), tcfg), "stepped")


def test_fast_body_widens_its_own_scenes_cells():
    """(f) A fast cube in scene 1 of 3 grows its speculative AABB and so its
    scene's cell size; every scene's cell size, slots and step equal its
    single world's."""
    _, tcfg = _configs()
    single, _ = scenes.cube_pile(8, max_contacts=64, device="cpu")
    batched = replicate_world(single, 3)
    vel = batched.bodies.lin_vel.clone()
    vel[1, 4] = torch.tensor([0.0, -40.0, 25.0])
    batched = batched.replace(bodies=batched.bodies.replace(lin_vel=vel))
    flat = bp_m.update_aabbs(flatten(batched), tcfg)
    cell, _, _ = bp_m.sweep_cell(flat.colliders, 3)
    pairs = bp_m.broad_phase(flat, tcfg)
    c = single.contacts.capacity
    m = single.colliders.capacity
    cells = []
    for s in range(3):
        alone = bp_m.update_aabbs(_scene(batched, s), tcfg)
        cells.append(float(bp_m.sweep_cell(alone.colliders)[0]))
        want = bp_m.broad_phase(alone, tcfg)
        rows = slice(s * c, (s + 1) * c)
        assert torch.equal(pairs.valid[rows], want.valid)
        assert torch.equal(pairs.collider_a[rows] - s * m, want.collider_a)
        assert torch.equal(pairs.collider_b[rows] - s * m, want.collider_b)
        assert int(pairs.num_pairs[s]) == int(want.num_pairs)
    assert cell.tolist() == cells and cells[1] > cells[0] == cells[2]
    out = make_batched_step(tcfg)(batched)
    for s in range(3):
        _assert_scene_equal(out, s, physics_step(_scene(batched, s), tcfg), "step")


def test_hinged_scenes_equal_each_scene_alone():
    """(g) 3 scenes of a small ``falling_hinges`` (revolute joints, Kernel I
    on the flat world), gravity jittered, equal to each scene alone."""
    _, tcfg = _configs()
    single, _ = scenes.falling_hinges(3, 4, max_contacts=96, device="cpu")
    batched = _jittered(replicate_world(single, 3), _gravity_jitter(3, seed=2))
    singles = [_scene(batched, i) for i in range(3)]
    step = make_batched_step(tcfg)
    for t in range(12):
        batched = step(batched)
        for i in range(3):
            singles[i] = physics_step(singles[i], tcfg)
            _assert_scene_equal(batched, i, singles[i], f"step {t + 1}")
    assert int(batched.joints.active.sum()) == 3 * 3 * 3


def test_batched_step_refuses_what_it_does_not_take():
    _, tcfg = _configs()
    with pytest.raises(NotImplementedError):
        make_batched_step(tcfg.replace(swept_ccd=True))
    single, _ = scenes.cube_pile(2, max_contacts=16, device="cpu")
    batched = replicate_world(single, 2)
    with pytest.raises(ValueError):
        physics_step(batched, tcfg)
    with pytest.raises(NotImplementedError):
        make_batched_step(tcfg)(batched.replace(custom_shapes=(object(),)))
    with pytest.raises(ValueError):
        make_batched_step(tcfg)(single)


def test_overflow_rows_split_by_scene():
    """3 piles of 8 at two colours, so that rows go to the overflow colour
    once they land (step 13): each scene's ``num_overflow`` and
    ``overflow_dropped`` (``solver.overflow_by_scene``, the pooled buckets'
    counts split by scene) equal its single world's, and so does its state."""
    _, tcfg = _configs()
    tcfg = tcfg.replace(max_colors=2)
    single, _ = scenes.cube_pile(8, max_contacts=64, device="cpu")
    batched = _jittered(replicate_world(single, 3), _gravity_jitter(3, seed=4))
    singles = [_scene(batched, i) for i in range(3)]
    step = make_batched_step(tcfg)
    most = [0, 0, 0]
    for t in range(15):
        batched, d = step(batched, return_diagnostics=True)
        for i in range(3):
            singles[i], ds = physics_step(singles[i], tcfg, return_diagnostics=True)
            for k in ("num_overflow", "overflow_dropped", "num_pairs", "num_contact_points"):
                assert int(d[k][i]) == int(ds[k]), (t + 1, i, k)
            most[i] = max(most[i], int(ds["num_overflow"]))
            _assert_scene_equal(batched, i, singles[i], f"step {t + 1}")
    assert min(most) > 0, most
