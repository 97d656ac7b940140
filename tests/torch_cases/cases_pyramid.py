"""The box-pyramid path against the JAX reference: the scenes leaf for leaf,
one full ``physics_step`` from the start and one from a settled state (1e-4
abs), Kernel H's plain version against ``prepare_constraints`` with locked
axes (1e-6 abs), 60 steps of the small pyramids, which must stand, and the
sag of a deeper pyramid in its first steps, step by step against the
reference's.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_cases/cases_pyramid.py BASE STEPS [SLOTS]

prints that sag for another depth (apex height, rows in the overflow color and
rows it had no room for after every step, reference and port side by side), at
``SLOTS`` contact slots a box (24; the reference's scenes take 8).

The JAX side runs jitted at ``max_colors=6``: a base-6 pyramid's boxes have
at most six dynamic neighbours, so five proper colors and the overflow color
are all used. Its outputs are read from ``pyramid_reference.npz``
(``port_common.Recording``, keyed by a digest of its inputs; rerecord with
``record_references.py cases_pyramid.py``), except ``many_pyramids(2, 3)``'s
step, which runs live, traced and compiled in a thread as the module loads
while the port steps (``_warm``), and is held to the recording. The port runs under
``torch.inference_mode`` (it keeps no autograd state; the results are the
same bit for bit), and each small scene's 60 steps run once (``_stand``):
the settled states the other cases start from are its steps."""

import functools
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import sys

import jax
import numpy as np
import pytest
import torch

from avian_tpu import scenes as jscenes
from avian_tpu.pipeline import broadphase as jbp
from avian_tpu.pipeline import contacts as jcontacts
from avian_tpu.pipeline import solver as jsol
from avian_tpu.pipeline import solver_body as jsb
from avian_tpu.pipeline.step import physics_step as j_step
from avian_tpu_torch import physics_step, scenes
from avian_tpu_torch.core import types as ttypes
from avian_tpu_torch.core.builder import SceneBuilder
from avian_tpu_torch.core.state import Contacts as TContacts
from avian_tpu_torch.kernels import pack_constraints as kh
from avian_tpu_torch.pipeline import solver as tsol
from avian_tpu_torch.pipeline import solver_body as tsb

from port_common import (Recording, as_numpy, assert_packed_rows_close, assert_worlds_equal,
                         pile_configs, to_jax, to_torch)

MAX_COLORS = 6
STEP_TOL = 1e-4
PACK_TOL = 1e-6
LOCKED_2D = ttypes.LOCK_TZ | ttypes.LOCK_RX | ttypes.LOCK_RY

_J_STEP = jax.jit(partial(j_step, return_diagnostics=True), static_argnums=1)
STAND_STEPS = 60
SAG_SLOTS_PER_BOX = 24
SAG_TOL = 1e-3
RECORDING = Recording("pyramid")
_BODY = ("pos", "quat", "lin_vel", "ang_vel", "sleep_timer", "sleeping", "island")
_CONTACT = ("pair_key", "collider_a", "collider_b", "active", "touching", "num_points", "color",
            "contact_id", "was_touching", "normal_impulse")
_DIAG = ("num_pairs", "dropped_pairs", "overflow_dropped", "num_overflow", "num_touching",
         "num_contact_points", "num_sleeping", "nonfinite_bodies")
_RC = ("color_c", "buckets", "bucket_valid", "bucket_a", "bucket_b", "overflow_dropped",
       "num_overflow", "relax", "data", "imp")


@partial(jax.jit, static_argnums=1)
def _ref_prepare(world, config):
    w2 = jbp.update_aabbs(world, config)
    contacts = jcontacts.narrow_phase(w2, jbp.broad_phase(w2, config), config)
    s = jsb.prepare(w2.bodies)
    return w2, contacts, s, jsol.prepare_constraints(w2, contacts, s, config)


def _warm():
    """Run the live reference function once on a world of the shapes it
    gets (so that its trace and compile are cached): {name: future}, run in
    a thread while the port steps. A case waits for its function's future
    before it calls it."""
    jcfg6, _ = pile_configs(max_colors=MAX_COLORS)
    template, _ = jscenes.many_pyramids(grid=2, base=3)
    world, _ = scenes.many_pyramids(grid=2, base=3, device="cpu")
    job = lambda: jax.block_until_ready(_J_STEP(to_jax(world, template), jcfg6))  # noqa: E731
    return {"many": ThreadPoolExecutor(1).submit(job)}


def _ref_step(jw, jcfg):
    """The reference's step: the bodies' and contacts' columns the cases
    compare, and its diagnostics."""
    jw, jd = _J_STEP(jw, jcfg)
    return {"bodies": {n: getattr(jw.bodies, n) for n in _BODY},
            "contacts": {n: getattr(jw.contacts, n) for n in _CONTACT},
            "diag": {k: jd[k] for k in _DIAG}}


def _ref_prepare_np(jw, jcfg):
    w2, contacts, s, rc = _ref_prepare(jw, jcfg)
    return {"w2": jax.tree.leaves(w2), "contacts": jax.tree.leaves(contacts),
            "inv_mass": s.inv_mass, "inv_inertia": s.inv_inertia,
            "rc": {n: getattr(rc, n) for n in _RC}}


_WARM = _warm() if __name__ != "__main__" else {}


def _ready(name):
    if name in _WARM:
        _WARM[name].result()


@pytest.fixture(autouse=True)
def _inference_mode():
    with torch.inference_mode():
        yield


@functools.cache
def _stand(scene):
    """``scene`` ("pyramid2d", "pyramid3d": ``box_pyramid(6)``; "many2d":
    ``many_pyramids(2, 3)``) from its start under ``pile_configs()`` for
    ``STAND_STEPS`` steps: (the worlds, the start first, then one a step; the
    most pairs or overflow rows a step dropped; the ids, of "many2d" the
    lower pyramids'; the JAX template). ``physics_step`` leaves its input
    world as it was, so every case may start from any of the worlds."""
    _, tcfg = pile_configs()
    if scene == "many2d":
        template, _ = jscenes.many_pyramids(2, 3)
        world, ids = scenes.many_pyramids(2, 3, device="cpu")
        ids = [i for k, i in enumerate(ids) if (k // 6) % 2 == 0]
    else:
        template, _ = jscenes.box_pyramid(6, dim3_depth=scene == "pyramid3d")
        world, ids = scenes.box_pyramid(6, dim3_depth=scene == "pyramid3d", device="cpu")
    worlds, worst = [world], 0
    for _ in range(STAND_STEPS):
        world, diag = physics_step(world, tcfg, return_diagnostics=True)
        worlds.append(world)
        worst = max(worst, int(diag["dropped_pairs"]), int(diag["overflow_dropped"]))
    return worlds, worst, ids, template


@pytest.mark.parametrize(
    "name,kw",
    [("box_pyramid", dict(base=6)), ("box_pyramid", dict(base=6, dim3_depth=True)),
     ("many_pyramids", dict(grid=2, base=3)), ("many_pyramids", dict(grid=2, base=3, dim3=True))],
    ids=["pyramid2d", "pyramid3d", "many2d", "many3d"],
)
def test_scene_matches_reference_leaf_for_leaf(name, kw):
    ref, ref_ids = getattr(jscenes, name)(**kw)
    port, ids = getattr(scenes, name)(device="cpu", **kw)
    assert_worlds_equal(ref, port)
    assert ids == ref_ids
    planar = not (kw.get("dim3_depth") or kw.get("dim3"))
    assert port.bodies.locked_axes[1:].tolist() == [LOCKED_2D if planar else 0] * len(ids)
    # ``max_contacts=`` only sizes the contact buffer.
    wide, _ = getattr(scenes, name)(device="cpu", max_contacts=999, **kw)
    assert wide.contacts.capacity == 999
    assert torch.equal(wide.bodies.pos, port.bodies.pos)


def test_add_body_2d_locks_the_plane_and_turns_about_z():
    b = SceneBuilder()
    i = b.add_body_2d(pos=(1.0, 2.0), angle=np.pi / 2, locked_axes=ttypes.LOCK_RZ)
    b.box(i, 0.5, 0.5, 0.5)
    w = b.finalize(device="cpu")
    assert int(w.bodies.locked_axes[i]) == LOCKED_2D | ttypes.LOCK_RZ
    np.testing.assert_allclose(w.bodies.pos[i].numpy(), [1.0, 2.0, 0.0])
    np.testing.assert_allclose(w.bodies.quat[i].numpy(), [0, 0, np.sqrt(0.5), np.sqrt(0.5)],
                               atol=1e-7)


def _assert_step_matches(tw, template, ready):
    """One step of ``tw`` by both packages; the reference's live where
    ``ready`` names its warm-up, else from the recording."""
    _ready(ready)
    jcfg, tcfg = pile_configs(max_colors=MAX_COLORS)
    jw = to_jax(tw, template)
    ref = RECORDING((jw, repr(jcfg)), lambda: _ref_step(jw, jcfg), live=ready in _WARM)
    jb, jc, jd = ref.bodies, ref.contacts, ref.diag
    pw, pd = physics_step(tw, tcfg, return_diagnostics=True)
    for name in ("pos", "quat", "lin_vel", "ang_vel", "sleep_timer"):
        np.testing.assert_allclose(as_numpy(getattr(pw.bodies, name)), jb[name],
                                   atol=STEP_TOL, rtol=0, err_msg=name)
    for name in ("sleeping", "island"):
        np.testing.assert_array_equal(as_numpy(getattr(pw.bodies, name)), jb[name],
                                      err_msg=name)
    for name in _CONTACT[:-1]:
        p = as_numpy(getattr(pw.contacts, name))
        np.testing.assert_array_equal(p, jc[name].astype(p.dtype), err_msg=name)
    np.testing.assert_allclose(as_numpy(pw.contacts.normal_impulse).sum(1),
                               jc["normal_impulse"].sum(1), atol=STEP_TOL, rtol=0)
    for key in _DIAG:
        assert int(pd[key]) == int(jd[key]), key
    return pw, pd


@pytest.mark.parametrize("dim3_depth", [False, True], ids=["2d", "3d"])
def test_one_step_from_the_start_and_one_settled_match_reference(dim3_depth):
    worlds, _, _, template = _stand("pyramid3d" if dim3_depth else "pyramid2d")
    pw, pd = _assert_step_matches(worlds[0], template, "pyramid")
    # Every contact appears in the first step; few get a proper color.
    first_overflow = int(pd["num_overflow"])
    assert int(pd["num_touching"]) > 21 and first_overflow > 10
    if not dim3_depth:
        assert float(pw.bodies.pos[:, 2].abs().max()) == 0.0      # Z stays locked
        assert float(pw.bodies.ang_vel[:, :2].abs().max()) == 0.0
    _, pd = _assert_step_matches(worlds[12], template, "pyramid")
    # The carried colors have settled; with 5 proper colors a few boxes with
    # six neighbours keep one contact in the overflow color.
    assert int(pd["num_overflow"]) <= first_overflow // 2


def test_many_pyramids_step_matches_reference():
    template, _ = jscenes.many_pyramids(2, 3)
    tw, _ = scenes.many_pyramids(2, 3, device="cpu")
    pw, _ = _assert_step_matches(tw, template, "many")
    _assert_step_matches(pw, template, "many")


def test_packing_with_locked_axes_matches_reference():
    """Kernel H's plain version on the 2D-profile pyramid: two locked
    rotation axes zero rows and columns of the inverse inertia, the locked
    translation axis zeroes an inverse mass component."""
    worlds, _, _, template = _stand("pyramid2d")
    tw = worlds[8]
    jcfg, tcfg = pile_configs(max_colors=MAX_COLORS)
    jw = to_jax(tw, template)
    ref = RECORDING((jw, repr(jcfg), "prepare"), lambda: _ref_prepare_np(jw, jcfg))
    jw2 = jax.tree.unflatten(jax.tree.structure(jw), ref.w2)
    jcontacts_ = jax.tree.unflatten(jax.tree.structure(jw.contacts), ref.contacts)
    rc = ref.rc
    w2 = to_torch(jw2)
    contacts = TContacts.from_numpy(jcontacts_, n_colliders=w2.colliders.capacity, device="cpu")
    s = tsb.prepare(w2.bodies)
    np.testing.assert_allclose(s.inv_mass.numpy(), ref.inv_mass, atol=PACK_TOL)
    np.testing.assert_allclose(s.inv_inertia.numpy(), ref.inv_inertia, atol=PACK_TOL)
    assert float(s.inv_mass[1:, 2].abs().max()) == 0.0 and float(s.inv_mass[1:, 0].min()) > 0
    assert float(s.inv_inertia[1:, [0, 1, 3, 4, 5]].abs().max()) == 0.0

    con = tsol.prepare_constraints(w2, contacts, s, tcfg)
    for name in ("color_c", "buckets", "bucket_valid", "bucket_a", "bucket_b"):
        np.testing.assert_array_equal(as_numpy(getattr(con, name)), rc[name], err_msg=name)
    assert int(con.overflow_dropped) == int(rc.overflow_dropped) == 0
    assert int(con.num_overflow) == int(rc.num_overflow)
    np.testing.assert_allclose(con.relax.numpy(), rc.relax, atol=PACK_TOL)
    assert_packed_rows_close(con.data, rc.data, rc.bucket_valid, PACK_TOL)
    np.testing.assert_allclose(con.imp.numpy(), rc.imp, atol=PACK_TOL)
    assert int(rc.bucket_valid.sum()) > 40 and int(rc.bucket_valid[:-1].sum()) > 0

    # The wrapper is the plain version on the CPU, and refuses other devices.
    dyn_a, dyn_b, solve, base_imp = kh.constraint_flags(contacts, s.solve_mask)
    assert int(solve.sum()) == int(rc.bucket_valid.sum())
    with pytest.raises(RuntimeError):
        kh.constraint_flags(contacts.to("meta"), s.solve_mask.to("meta"))
    with pytest.raises(RuntimeError):
        kh.pack_constraints(w2.bodies, contacts, s, dyn_a, dyn_b, solve, base_imp,
                            con.buckets.to("meta"), con.bucket_valid, (1, 1, 1), (1, 1, 1))


@pytest.mark.parametrize("scene", ["pyramid2d", "pyramid3d", "many2d"])
def test_sixty_steps_stand(scene):
    """The small pyramids come to rest where they were built. The field's
    upper pyramids start 1 m above the lower ones and land on them after 27
    steps; its ground row must stay in place under that blow, within 0.3 m
    sideways."""
    worlds, worst, ids, _ = _stand(scene)
    start, world = worlds[0].bodies.pos, worlds[-1]
    moved = (world.bodies.pos - start)[torch.tensor(ids)].abs()
    assert worst == 0
    assert bool(torch.isfinite(world.bodies.pos).all()) and not bool(world.diverged)
    assert float(moved[:, [0, 2]].max()) <= (0.3 if scene == "many2d" else 0.1), moved.max(0)
    assert float(moved[:, 1].max()) <= 0.05, moved.max(0)
    if scene != "many2d":
        assert bool(world.bodies.sleeping[1:].all())  # at rest, and asleep


def sag_series(base, steps, slots_per_box=SAG_SLOTS_PER_BOX):
    """``box_pyramid(base)`` from its start under the bench config (12
    colors), reference and port: per step ``(apex y move in the reference, in
    the port, largest position difference of any body, rows in the overflow
    color in the reference, in the port, rows the overflow color's bucket
    dropped in the reference, in the port)``."""
    jcfg, tcfg = pile_configs()
    template, _ = jscenes.box_pyramid(base)
    n = base * (base + 1) // 2 + 1
    tw, ids = scenes.box_pyramid(base, max_contacts=slots_per_box * n, device="cpu")
    jw = to_jax(tw, template)
    start = tw.bodies.pos.numpy().copy()
    apex = ids[int(np.argmax(start[ids, 1]))]

    def reference():
        out, w = [], jw
        for _ in range(steps):
            w, jd = _J_STEP(w, jcfg)
            out.append({"pos": w.bodies.pos, **{k: jd[k] for k in _DIAG}})
        return out

    ref = RECORDING((jw, repr(jcfg), steps), reference)
    rows = []
    for jd in ref:
        tw, td = physics_step(tw, tcfg, return_diagnostics=True)
        assert int(jd["dropped_pairs"]) == 0 and int(td["dropped_pairs"]) == 0
        jp, tp = jd["pos"], tw.bodies.pos.numpy()
        rows.append((float(jp[apex, 1] - start[apex, 1]), float(tp[apex, 1] - start[apex, 1]),
                     float(np.abs(jp - tp).max()), int(jd["num_overflow"]),
                     int(td["num_overflow"]), int(jd["overflow_dropped"]),
                     int(td["overflow_dropped"])))
    return rows


def test_deep_pyramid_sags_as_the_reference_s():
    """A fresh pyramid's contacts all appear in step 1, and four proposal
    rounds a step color only part of them: the rest wait in the under-relaxed
    overflow color, for about base/4 steps, and meanwhile the upper rows
    sink. The reference does this, and the port follows it step by step."""
    rows = sag_series(base=20, steps=12)
    for i, (_, _, diff, j_overflow, t_overflow, j_dropped, t_dropped) in enumerate(rows):
        assert t_overflow == j_overflow and j_dropped == t_dropped == 0, (i, rows)
        assert diff <= SAG_TOL, (i, rows)
    overflow = [r[3] for r in rows]
    assert overflow[0] > 500 and overflow[4] > 0 and overflow[6] == 0, overflow
    lowest = min(r[0] for r in rows)
    assert -0.04 < lowest < -0.02, rows      # the reference's apex sinks 2.8 cm
    assert rows[-1][0] > lowest + 0.02       # and comes back up


if __name__ == "__main__":
    RECORDING.mode = "run"
    for step, row in enumerate(sag_series(*map(int, sys.argv[1:])), start=1):
        print(step, "apex y: reference %.4f port %.4f; largest difference %.2e m; "
              "overflow rows: reference %d port %d; dropped: reference %d port %d" % row)
