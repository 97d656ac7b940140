"""The port's native 2D step end to end against the JAX reference on the CPU:
one full step of a base-20 pyramid, 60 steps (the shapes fall and land) of
the every-shape world of ``tests/test_dim2.py`` and of one with every
constructor, the
``pyramid2d_native`` golden (500 steps at 1/64 s within the 1e-3 drift of
``tests/golden_common.py``), the NaN quarantine, determinism, and what the
2D step refuses.

Tolerances: 1e-4 on poses and velocities after one step (PyTorch's CPU
``sqrt``/``cos``/``sin`` are a few ulp off the reference's, and the warm
start sums per body in another order), 1e-3 after 60 steps of the
every-shape worlds (their largest difference over those steps was 7e-5); pairs, contact counts, colours, islands and sleep flags
exactly.

The reference's 60-step runs are read from ``dim2_step_reference.npz``
(``port_common.Recording``, keyed by a digest of its inputs; rerecord with
``record_references.py cases_dim2_step.py``); its step of the base-20
pyramid runs live and is held to the recording.
"""

from port_common import ieee_reference

ieee_reference()

import os  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from avian_tpu import PhysicsConfig as JConfig  # noqa: E402
from avian_tpu.dim2.step import physics_step_2d as j_step  # noqa: E402
from avian_tpu_torch import PhysicsConfig as TConfig  # noqa: E402
from avian_tpu_torch.core.types import BodyType  # noqa: E402
from avian_tpu_torch.dim2 import SceneBuilder2D, physics_step_2d, rollout_2d  # noqa: E402
from avian_tpu_torch.dim2 import scenes as tscenes  # noqa: E402

from cases_dim2 import every_shape_worlds, to_jax2d, to_torch2d  # noqa: E402
from port_common import Recording, as_numpy  # noqa: E402

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "golden",
                      "pyramid2d_native.npz")
DIAGNOSTICS = ("num_pairs", "dropped_pairs", "overflow_dropped", "num_overflow",
               "num_touching", "num_sleeping", "nonfinite_bodies")
RECORDING = Recording("dim2_step")
_BODY = ("pos", "angle", "lin_vel", "ang_vel", "sleep_timer", "sleeping", "island")
_CONTACT = ("pair_key", "collider_a", "collider_b", "active", "touching", "num_points", "color",
            "contact_id", "was_touching", "feature_id", "evicted", "next_contact_id")


def _fields(jw):
    """What ``_hold`` reads of a reference world."""
    return {"bodies": {n: getattr(jw.bodies, n) for n in _BODY},
            "contacts": {n: getattr(jw.contacts, n) for n in _CONTACT}, "time": jw.time}


def _hold(port_world, ref_world, atol):
    """``ref_world``: a reference world or its recorded ``_fields``."""
    p = port_world
    r = ref_world if isinstance(ref_world, dict) else jax.tree.map(np.asarray, ref_world)
    for name in ("pos", "angle", "lin_vel", "ang_vel", "sleep_timer"):
        np.testing.assert_allclose(as_numpy(getattr(p.bodies, name)),
                                   getattr(r.bodies, name), atol=atol, rtol=0, err_msg=name)
    for name in ("sleeping", "island"):
        np.testing.assert_array_equal(as_numpy(getattr(p.bodies, name)),
                                      getattr(r.bodies, name), err_msg=name)
    for name in ("pair_key", "collider_a", "collider_b", "active", "touching", "num_points",
                 "color", "contact_id", "was_touching", "feature_id", "evicted"):
        got = as_numpy(getattr(p.contacts, name))
        np.testing.assert_array_equal(got, getattr(r.contacts, name).astype(got.dtype),
                                      err_msg=name)
    assert int(p.contacts.next_contact_id) == int(r.contacts.next_contact_id)
    np.testing.assert_array_equal(as_numpy(p.time), r.time)


def test_one_step_of_a_base_20_pyramid_matches_reference():
    n = 20 * 21 // 2 + 1
    tw, _ = tscenes.box_pyramid_2d(20, max_contacts=24 * n, device="cpu")
    kw = dict(substeps=4, max_colors=8)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    for _ in range(2):  # warm contacts, colours and impulses
        tw = physics_step_2d(tw, tcfg)
    start = to_jax2d(tw)

    def reference():
        jw, jd = j_step(start, jcfg, return_diagnostics=True)
        return {"world": _fields(jw), "diag": dict(jd)}

    ref = RECORDING((start, repr(jcfg)), reference, live=True)
    jw, jd = ref.world, ref.diag
    pw, pd = physics_step_2d(tw, tcfg, return_diagnostics=True)
    _hold(pw, jw, 1e-4)
    assert set(pd) == set(jd)
    for key in DIAGNOSTICS:
        assert int(pd[key]) == int(jd[key]), key
    assert abs(float(pd["max_penetration"]) - float(jd["max_penetration"])) < 1e-4
    assert int(pd["num_touching"]) > 400 and int(pd["dropped_pairs"]) == 0


def _all_shapes_world(builder, **finalize_kw):
    """``tests/test_dim2.py::test_all_2d_shapes_rest_on_ground``'s world."""
    b = builder
    g = b.add_body(body_type=BodyType.STATIC)
    b.half_space(g, normal=(0, 1), friction=0.6)
    for pos, make in (
        ((0, 2.0), lambda x: b.circle(x, 0.5)),
        ((2, 2.0), lambda x: b.rectangle(x, 1.0, 1.0)),
        ((-2, 2.0), lambda x: b.capsule(x, 0.3, 0.8)),
        ((4, 2.0), lambda x: b.regular_polygon(x, 0.5, 6)),
        ((-4, 2.0), lambda x: b.triangle(x, (-0.5, 0.0), (0.5, 0.0), (0.0, 0.8))),
        ((6, 2.0), lambda x: b.round_rectangle(x, 0.8, 0.6, 0.1)),
        ((-6, 2.0), lambda x: b.ellipse(x, 0.6, 0.4)),
        ((8, 2.0), lambda x: b.convex_hull(x, [(-0.5, -0.4), (0.5, -0.4), (0.6, 0.2),
                                                (0.0, 0.5), (-0.6, 0.2)])),
    ):
        make(b.add_body(pos=pos))
    return b.finalize(max_bodies=16, max_colliders=16, max_contacts=64, **finalize_kw)


@pytest.mark.parametrize("world", ["test_dim2_all_shapes", "every_constructor"])
def test_sixty_steps_of_every_shape_match_reference(world):
    from avian_tpu.dim2 import SceneBuilder2D as JBuilder2D

    if world == "test_dim2_all_shapes":
        jw = _all_shapes_world(JBuilder2D())
        tw = _all_shapes_world(SceneBuilder2D(), device="cpu")
    else:
        jw, tw = every_shape_worlds(joints=False)
    cfg = dict(max_colors=4)
    jcfg, tcfg = JConfig(**cfg), TConfig(**cfg)
    tw = to_torch2d(jw) if world == "test_dim2_all_shapes" else tw
    start = jw

    def reference():
        w, diags = start, []
        for _ in range(60):
            w, d = j_step(w, jcfg, return_diagnostics=True)
            diags.append({k: d[k] for k in DIAGNOSTICS})
        return {"world": _fields(w), "diags": diags}

    ref = RECORDING((start, repr(jcfg), 60), reference)
    for i in range(60):
        tw, td = physics_step_2d(tw, tcfg, return_diagnostics=True)
        for key in DIAGNOSTICS:
            assert int(td[key]) == int(ref.diags[i][key]), (i, key)
    _hold(tw, ref.world, 1e-3)
    assert int(td["num_touching"]) >= 8


def test_pyramid2d_native_golden():
    """The reference's 2D golden scene and protocol (``tests/golden_common.py``):
    base 6, 500 steps at 1/64 s, ``max_colors=8``; positions every 10th
    step within 1e-3 of the recording, angles too."""
    golden = np.load(GOLDEN)
    world, _ = tscenes.box_pyramid_2d(6, device="cpu")
    config = TConfig(dt=1.0 / 64.0, max_colors=8)
    pos, angle = [], []
    for i in range(500):
        world = physics_step_2d(world, config)
        if (i + 1) % 10 == 0:
            pos.append(as_numpy(world.bodies.pos))
            angle.append(as_numpy(world.bodies.angle))
    assert np.abs(np.stack(pos) - golden["pos"]).max() < 1e-3
    assert np.abs(np.stack(angle) - golden["angle"]).max() < 1e-3
    assert bool(world.bodies.sleeping[1:].all())  # the pyramid came to rest


def test_scenes_build_on_the_card_by_default():
    """Without ``device=`` a 2D entry point builds on the card, and on a
    machine without one it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tscenes.box_pyramid_2d(4)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        SceneBuilder2D().finalize()


def _small(device="cpu"):
    return tscenes.box_pyramid_2d(3, device=device)[0]


def test_what_the_2d_step_refuses():
    """A sweep window past 32 entries: the candidate bitmask is one u32 per
    grid entry."""
    world, config = tscenes.box_pyramid_2d(10, device="cpu")[0], TConfig(sap_window=33)
    with pytest.raises(ValueError):
        physics_step_2d(world, config)


def test_nan_quarantine_and_determinism():
    world = _small()
    lin = world.bodies.lin_vel.clone()
    lin[2, 1] = float("nan")
    bad = world.replace(bodies=world.bodies.replace(lin_vel=lin))
    out, diag = physics_step_2d(bad, TConfig(), return_diagnostics=True)
    assert bool(out.diverged) and bool(diag["diverged"]) and int(diag["nonfinite_bodies"]) >= 1
    assert torch.equal(out.bodies.pos, bad.bodies.pos)

    a = rollout_2d(world, TConfig(max_colors=4), 6)
    b = world
    for _ in range(6):
        b = physics_step_2d(b, TConfig(max_colors=4))
    for name in ("pos", "angle", "lin_vel", "ang_vel"):
        assert torch.equal(getattr(a.bodies, name), getattr(b.bodies, name)), name
