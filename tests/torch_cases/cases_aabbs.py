"""Kernel E's plain version (collider poses, speculative AABBs, grid cell
keys) against the JAX reference, on boxes and on all five shapes: ``update_collider_poses``/``update_aabbs``
within 1e-6, and the key emission of ``broad_phase`` (broadphase.py:217-279,
repeated here in ``jnp`` since the reference does not return its keys):
keys and integer rows exactly."""

import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avian_tpu import scenes as jscenes
from avian_tpu.core import types as jtypes
from avian_tpu.geometry import shapes as jshapes
from avian_tpu.pipeline import broadphase as jbp
from avian_tpu_torch.kernels import build
from avian_tpu_torch.kernels import collider_aabbs as ke
from avian_tpu_torch.pipeline import broadphase as tbp

from port_common import assert_columns, example_many_shapes, pile_configs, to_torch

TOL = 1e-6


def _jumbled(world, seed):
    """Random small offsets, rotations and velocities on every dynamic body,
    made with numpy from a seed."""
    rng = np.random.default_rng(seed)
    pos = np.asarray(world.bodies.pos).copy()
    quat = np.asarray(world.bodies.quat).copy()
    dyn = np.arange(pos.shape[0]) > 0
    pos[dyn] += rng.uniform(-0.05, 0.05, size=(dyn.sum(), 3)).astype(np.float32)
    q = rng.normal(size=(dyn.sum(), 4)).astype(np.float32) * np.float32(0.15)
    q[:, 3] = 1.0
    quat[dyn] = q / np.linalg.norm(q, axis=1, keepdims=True)
    vel = rng.uniform(-4.0, 4.0, size=pos.shape).astype(np.float32)
    vel[0] = 0.0
    return world.replace(bodies=world.bodies.replace(
        pos=jnp.asarray(pos), quat=jnp.asarray(quat), lin_vel=jnp.asarray(vel)))


def _worlds():
    return {
        "pile": _jumbled(jscenes.cube_pile(64, spacing=0.97, seed=7, max_contacts=1024)[0], 7),
        "pyramid": _jumbled(jscenes.box_pyramid(base=6)[0], 8),
        "pyramid_at_rest": jscenes.box_pyramid(base=6)[0],
        # Spheres, boxes, capsules, cylinders and cones.
        "shapes": _jumbled(example_many_shapes(), 9),
    }


@jax.jit
def _ref_keys(world):
    """The reference's key emission, broadphase.py:217-279."""
    col, b = world.colliders, world.bodies
    ext_c = jnp.max(col.aabb_max - col.aabb_min, axis=-1)
    is_plane = ext_c > jshapes.BIG
    finite = col.active & ~is_plane
    n_finite = jnp.sum(finite.astype(jnp.int32))
    ext_sorted = jnp.sort(jnp.where(finite, ext_c, jnp.inf))
    median_ext = ext_sorted[jnp.clip(n_finite // 2, 0, ext_c.shape[0] - 1)]
    is_big = finite & (ext_c > 4.0 * jnp.maximum(median_ext, 1e-6))
    in_sweep = col.active & ~(is_plane | is_big)
    body = col.body_idx
    dyn = (b.body_type[body] == jtypes.BodyType.DYNAMIC) & b.active[body]
    ext_axis = col.aabb_max - col.aabb_min
    cell = 1.001 * jnp.maximum(jnp.max(jnp.where(in_sweep[:, None], ext_axis, 0.0)), 1e-3)
    i0 = jnp.floor(col.aabb_min / cell).astype(jnp.int32)
    i1 = jnp.floor(col.aabb_max / cell).astype(jnp.int32)
    cc = i0[:, None, :] + jnp.asarray(jbp._CELL_OFFSETS)[None, :, :]
    entry_ok = jnp.all(cc <= i1[:, None, :], axis=-1) & in_sweep[:, None]
    ckey = ((cc[..., 0] & 1023) << 20) | ((cc[..., 1] & 1023) << 10) | (cc[..., 2] & 1023)
    ckey = jnp.where(entry_ok, ckey, jnp.iinfo(jnp.int32).max)
    ipack = jnp.concatenate(
        [i0, body[:, None], col.layer_members[:, None].astype(jnp.int32),
         col.layer_filter[:, None].astype(jnp.int32), dyn[:, None].astype(jnp.int32)], axis=-1)
    return ckey.reshape(-1), jnp.concatenate([col.aabb_min, col.aabb_max], axis=-1), ipack, cell


@pytest.mark.parametrize("name", ["pile", "pyramid", "pyramid_at_rest", "shapes"])
def test_poses_aabbs_and_keys_match_reference(name):
    jw = _worlds()[name]
    jcfg, tcfg = pile_configs()
    ref_pos, ref_quat = jbp.update_collider_poses(jw)
    jw2 = jbp.update_aabbs(jw, jcfg)
    tw2, pos, quat = tbp.update_aabbs_and_poses(to_torch(jw), tcfg)
    assert_columns(jw2.colliders, tw2.colliders, atol=TOL, only=["aabb_min", "aabb_max"])
    np.testing.assert_allclose(pos.numpy(), np.asarray(ref_pos), atol=TOL, rtol=0)
    np.testing.assert_allclose(quat.numpy(), np.asarray(ref_quat), atol=TOL, rtol=0)

    # Keys from the reference's own AABBs, so that both floor the same floats.
    ref_key, ref_f, ref_i, ref_cell = _ref_keys(jw2)
    tw2 = to_torch(jw2)
    cell, in_sweep, is_global = tbp.sweep_cell(tw2.colliders)
    assert float(cell) == float(ref_cell)
    ckey, fpack, ipack = ke.cell_keys(tw2.bodies, tw2.colliders, cell, in_sweep)
    np.testing.assert_array_equal(ckey.numpy(), np.asarray(ref_key))
    np.testing.assert_array_equal(fpack.numpy(), np.asarray(ref_f))
    np.testing.assert_array_equal(ipack.numpy(), np.asarray(ref_i))
    live = ckey.numpy() != ke.SENTINEL
    assert live.sum() >= tw2.colliders.capacity - 1    # every shape is in the grid
    assert live.reshape(-1, 8).sum(1).max() > 1        # some span several cells
    assert bool(is_global[0]) and not bool(in_sweep[0])  # the ground plane


def test_speculative_expansion_is_capped_by_the_margin():
    """A fast body's AABB grows by |v| dt, but by no more than its collider's
    speculative margin."""
    jw = jscenes.cube_pile(8, max_contacts=64)[0]
    tw = to_torch(jw)
    vel = tw.bodies.lin_vel.clone()
    vel[1] = torch.tensor([0.0, -60.0, 0.0])
    vel[2] = torch.tensor([0.0, -60.0, 0.0])
    spec = tw.colliders.speculative_margin.clone()
    spec[2] = 0.25
    tw = tw.replace(bodies=tw.bodies.replace(lin_vel=vel),
                    colliders=tw.colliders.replace(speculative_margin=spec))
    _, tcfg = pile_configs()
    col = tbp.update_aabbs(tw, tcfg).colliders
    half = (col.aabb_max - col.aabb_min)[:, 1] / 2
    tol = tcfg.narrow_phase.contact_tolerance
    assert float(half[1]) == pytest.approx(0.5 + 60.0 * tcfg.dt + tol, abs=1e-5)
    assert float(half[2]) == pytest.approx(0.5 + 0.25 + tol, abs=1e-5)
    assert float(half[3]) == pytest.approx(0.5 + tol, abs=1e-5)


def test_entry_points_match_their_declared_signatures():
    """``build._SIGNATURES`` against the ``extern "C"`` declarations in
    ``csrc/*.cu``: a wrong ctypes signature would cut a pointer."""
    code = {ctypes.c_int: "I", ctypes.c_float: "F", ctypes.c_void_p: "P"}
    declared = {}
    for src in build.sources():
        for m in re.finditer(r'extern "C" int (\w+)\s*\(([^)]*)\)', src.read_text()):
            args = [a.strip() for a in m.group(2).replace("\n", " ").split(",")]
            declared[m.group(1)] = "".join(
                "P" if "*" in a else ("F" if a.startswith("float") else "I") for a in args)
    assert set(declared) == set(build._SIGNATURES)
    for name, argtypes in build._SIGNATURES.items():
        assert "".join(code[t] for t in argtypes) == declared[name], name
    assert len(build.sources()) == 38


@pytest.mark.parametrize("fn", ["collider_aabbs", "cell_keys"])
def test_wrappers_refuse_other_devices(fn):
    tw = to_torch(jscenes.cube_pile(8, max_contacts=64)[0]).to("meta")
    with pytest.raises(RuntimeError):
        if fn == "collider_aabbs":
            ke.collider_aabbs(tw.bodies, tw.colliders, 1 / 60, float("inf"), 0.005)
        else:
            ke.cell_keys(tw.bodies, tw.colliders, torch.ones((), device="meta"),
                         tw.colliders.active)
