"""The port's AABBs and broadphase (Kernel B's twin on CPU) against the JAX
reference: pair set, slot order and ``dropped`` must match exactly. The
reference's broadphase results are read from ``broadphase_reference.npz``
(``port_common.Recording``, keyed by a digest of its inputs; rerecord with
``record_references.py cases_broadphase.py``); its AABBs run live."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avian_tpu import scenes as jscenes
from avian_tpu.pipeline import broadphase as jbp
from avian_tpu_torch.kernels import grid_sweep as kb
from avian_tpu_torch.pipeline import broadphase as tbp

from port_common import Recording, assert_columns, pile_configs, to_torch

RECORDING = Recording("broadphase")


def _reference(jw, jcfg):
    """(the reference's world with its AABBs, its ``broad_phase``), from the
    recording."""

    def run():
        jw2 = jbp.update_aabbs(jw, jcfg)
        bp = jbp.broad_phase(jw2, jcfg)
        return {"world": jax.tree.leaves(jw2),
                "pairs": {f.name: getattr(bp, f.name) for f in dataclasses.fields(bp)}}

    ref = RECORDING((jw, repr(jcfg)), run)
    jw2 = jax.tree.unflatten(jax.tree.structure(jw), [jnp.asarray(x) for x in ref.world])
    return jw2, jbp.BroadPhaseResult(**ref.pairs)


def _jumbled_pile(n=64, seed=7, max_contacts=None):
    """A dense pile (cubes start overlapping) with random small rotations
    and offsets, made with numpy from a seed and given to both packages."""
    world, _ = jscenes.cube_pile(
        n, spacing=0.97, seed=seed, max_contacts=max_contacts or 16 * n
    )
    rng = np.random.default_rng(seed)
    pos = np.asarray(world.bodies.pos).copy()
    quat = np.asarray(world.bodies.quat).copy()
    dyn = np.arange(pos.shape[0]) > 0
    pos[dyn] += rng.uniform(-0.05, 0.05, size=(dyn.sum(), 3)).astype(np.float32)
    q = rng.normal(size=(dyn.sum(), 4)).astype(np.float32) * np.float32(0.15)
    q[:, 3] = 1.0
    quat[dyn] = q / np.linalg.norm(q, axis=1, keepdims=True)
    vel = rng.uniform(-1.0, 1.0, size=pos.shape).astype(np.float32)
    vel[0] = 0.0
    return world.replace(
        bodies=world.bodies.replace(
            pos=jnp.asarray(pos), quat=jnp.asarray(quat), lin_vel=jnp.asarray(vel)
        )
    )


def test_update_aabbs_match():
    jw = _jumbled_pile()
    jcfg, tcfg = pile_configs()
    ref = jbp.update_aabbs(jw, jcfg).colliders
    port = tbp.update_aabbs(to_torch(jw), tcfg).colliders
    assert_columns(ref, port, atol=1e-6, only=["aabb_min", "aabb_max"])


@pytest.mark.parametrize(
    "case",
    [
        dict(),                       # the slice's settings
        dict(sap_window=4),           # cell runs beyond the window
        dict(capacity=40),            # more candidates than slots
        dict(seed=11, sap_window=9),
    ],
    ids=["default", "window4", "capacity40", "seed11_window9"],
)
def test_broad_phase_matches_reference(case):
    case = dict(case)
    capacity = case.pop("capacity", None)
    seed = case.pop("seed", 7)
    jw = _jumbled_pile(seed=seed, max_contacts=capacity)
    jcfg, tcfg = pile_configs(**case)
    jw2, ref = _reference(jw, jcfg)
    port = tbp.broad_phase(to_torch(jw2), tcfg)
    assert_columns(ref, port)
    if capacity is not None or case.get("sap_window") == 4:
        assert int(ref.dropped) > 0  # the case exercises the drop count
    assert int(ref.num_pairs) >= 40


def test_sweep_window_refuses_more_than_32():
    """The reference refuses a window above 32; the port's candidate mask
    is 64 bits wide, so it takes up to 64 and refuses more."""
    _, tcfg = pile_configs(sap_window=65)
    with pytest.raises(ValueError):
        tbp.sweep_window(tcfg, 100)
    for w in (33, 64):
        _, tcfg = pile_configs(sap_window=w)
        assert tbp.sweep_window(tcfg, 100) == w


def _crowded_cell(builder, n=48, seed=3):
    """``n`` dynamic boxes (half 0.3) whose AABBs all start in grid cell
    (0, 0, 0) and overlap each other: a cell run of ``n`` entries, past the
    reference's window of 32."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        body = builder.add_body(pos=tuple(rng.uniform(0.31, 0.35, 3)))
        builder.box(body, 0.3, 0.3, 0.3)
    return builder.finalize(max_contacts=4096)


def test_window_64_pairs_the_entries_the_reference_drops():
    """A cell run of 48: the reference (window 32) drops the entries past
    33; the port at window 64 finds every pair the reference finds and the
    ones it dropped (all 48 * 47 / 2 boxes overlap), drops nothing, and at
    window 32 equals the reference."""
    from avian_tpu import SceneBuilder as JBuilder

    jw = _crowded_cell(JBuilder())
    jcfg, tcfg = pile_configs()
    jw2, ref = _reference(jw, jcfg)
    assert int(ref.dropped) > 0
    assert_columns(ref, tbp.broad_phase(to_torch(jw2), tcfg))
    _, wide = pile_configs(sap_window=64)
    port = tbp.broad_phase(to_torch(jw2), wide)
    assert int(port.dropped) == 0 and int(port.num_pairs) == 48 * 47 // 2
    ref_keys = set(np.asarray(ref.pair_key)[np.asarray(ref.valid)].tolist())
    assert ref_keys < set(port.pair_key[port.valid].tolist())


def test_grid_sweep_rank_is_run_rank_capped():
    rng = np.random.default_rng(0)
    keys = np.sort(rng.integers(0, 6, size=200)).astype(np.int32)
    keys[-20:] = kb.SENTINEL
    n = keys.shape[0]
    sf = torch.zeros((n, 6))
    si = torch.zeros((n, 7), dtype=torch.int32)
    w = 5
    _, rank = kb.grid_sweep(torch.from_numpy(keys), sf, si, w)
    expect = np.zeros(n, np.int64)
    for i in range(1, n):
        expect[i] = expect[i - 1] + 1 if keys[i] == keys[i - 1] else 0
    np.testing.assert_array_equal(rank.numpy(), np.minimum(expect, w + 1))


def test_grid_sweep_bits_match_a_scalar_loop():
    """The twin's bitmask against a literal per-pair loop of the
    reference's tests, on random entries with shared cells."""
    rng = np.random.default_rng(1)
    n, w = 120, 7
    cells = np.sort(rng.integers(0, 10, size=n))
    keys = np.where(cells < 9, cells * 1031, kb.SENTINEL).astype(np.int32)
    i0 = np.stack([cells % 4, cells // 4, np.zeros(n, np.int64)], -1).astype(np.int32)
    lo = rng.uniform(0.0, 1.0, size=(n, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.1, 0.6, size=(n, 3)).astype(np.float32)
    body = rng.integers(0, 30, size=n).astype(np.int32)
    mem = rng.choice(np.asarray([-1, 1, 2, 3], np.int32), size=n)
    fil = rng.choice(np.asarray([-1, 1, 2], np.int32), size=n)
    dyn = rng.integers(0, 2, size=n).astype(np.int32)
    si = np.concatenate([i0, body[:, None], mem[:, None], fil[:, None], dyn[:, None]], -1)
    sf = np.concatenate([lo, hi], -1)
    # Make the canonical-cell test pass for some pairs: keys equal to the
    # packed min-cell of the run.
    keys = np.where(
        keys != kb.SENTINEL,
        ((i0[:, 0] & 1023) << 20) | ((i0[:, 1] & 1023) << 10) | (i0[:, 2] & 1023),
        keys,
    ).astype(np.int32)
    bits, _ = kb.grid_sweep(torch.from_numpy(keys), torch.from_numpy(sf),
                            torch.from_numpy(si), w)
    bits = bits.numpy().view(np.uint64)
    for i in range(n):
        expect = 0
        for k in range(1, w + 1):
            j = i + k
            if j >= n or keys[i] == kb.SENTINEL or keys[j] != keys[i]:
                continue
            canon = np.maximum(i0[i], i0[j])
            ckey = ((canon[0] & 1023) << 20) | ((canon[1] & 1023) << 10) | (canon[2] & 1023)
            ok = (
                ckey == keys[i]
                and np.all(lo[j] <= hi[i]) and np.all(lo[i] <= hi[j])
                and body[i] != body[j]
                and (mem[i] & fil[j]) != 0 and (mem[j] & fil[i]) != 0
                and (dyn[i] | dyn[j]) > 0
            )
            expect |= int(ok) << (k - 1)
        assert bits[i] == expect, i
    assert bits.any()
