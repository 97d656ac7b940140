"""Kernel G's plain version (edge coloring, bucketing, run rank) against the
JAX reference on random graphs, exactly: every output is an integer. The
graphs have bodies of degree above 32 (whose later incidences do not fit the
adjacency row), non-dynamic ends, dead edges and carried colors. A scalar
reading of the CUDA kernel's rule (an edge wins unless a lower-indexed edge
in the row of one of its dynamic ends proposes the same color) is held
against both."""

from functools import partial

import jax
import numpy as np
import pytest
import torch

from avian_tpu.pipeline.coloring import color_constraints as jcolor
from avian_tpu.pipeline.solver import _bucketize as jbucketize
from avian_tpu_torch.kernels import color_edges as kg
from avian_tpu_torch.kernels.run_rank import run_rank
from avian_tpu_torch.pipeline import coloring as tcol
from avian_tpu_torch.pipeline import solver as tsol

MAX_COLORS = 8


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _graph(seed, e, n, hubs):
    """Random edges over ``n`` bodies; the first ``hubs`` bodies take part in
    a third of the edges, so their degree is far above 32."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, n, size=e).astype(np.int32)
    if hubs:
        hub = rng.uniform(size=e) < 0.33
        a = np.where(hub, rng.integers(0, hubs, size=e), a).astype(np.int32)
    b = ((a + rng.integers(1, n, size=e)) % n).astype(np.int32)
    dyn_a = rng.uniform(size=e) < 0.9
    dyn_b = rng.uniform(size=e) < 0.9
    mask = rng.uniform(size=e) < 0.95
    prev = rng.integers(-1, MAX_COLORS, size=e).astype(np.int32)
    return a, b, dyn_a, dyn_b, mask, prev


def _scalar_colors(a, b, dyn_a, dyn_b, mask, n, max_colors, prev):
    """The CUDA kernel's launches, one Python loop each."""
    e, d, assignable = len(a), kg.MAX_DEGREE, max_colors - 1
    rows = [[] for _ in range(n)]
    fit = np.ones(2 * e, bool)
    key = np.concatenate([np.where(mask & dyn_a, a, n), np.where(mask & dyn_b, b, n)])
    for j in np.argsort(key, kind="stable"):
        if key[j] < n:
            fit[j] = len(rows[key[j]]) < d
            if fit[j]:
                rows[key[j]].append(j % e)
    colorable = mask & (~dyn_a | fit[:e]) & (~dyn_b | fit[e:])
    color = np.full(e, -1)
    used = [0] * n

    def win(prop):
        new = color.copy()
        for i in range(e):
            p = int(prop[i])
            if p < 0:
                continue
            ends = ([a[i]] if dyn_a[i] else []) + ([b[i]] if dyn_b[i] else [])
            if any(o < i and prop[o] == p for body in ends for o in rows[body]):
                continue
            new[i] = p
            for body in ends:
                used[body] |= 1 << p
        return new

    carried = np.where(colorable & (prev >= 0) & (prev < assignable), prev, -1)
    color = win(carried)
    for _ in range(kg.ASSIGN_ROUNDS):
        prop = np.full(e, -3)
        for i in range(e):
            if not (colorable[i] and color[i] < 0):
                continue
            avail = (1 << assignable) - 1
            if dyn_a[i]:
                avail &= ~used[a[i]]
            if dyn_b[i]:
                avail &= ~used[b[i]]
            if avail:
                low = (avail & -avail).bit_length() - 1
                high = avail.bit_length() - 1
                prop[i] = high if not (dyn_a[i] and dyn_b[i]) else low
        color = win(prop)
    overflow = (mask & ~colorable) | (colorable & (color < 0))
    return np.where(color < 0, max_colors - 1, color), overflow


@pytest.mark.parametrize(
    "seed,e,n,hubs,carry",
    [(3, 300, 60, 0, True), (4, 600, 50, 2, True), (5, 400, 40, 3, False)],
    ids=["sparse", "hubs_carried", "hubs_fresh"],
)
def test_coloring_matches_reference_and_kernel_rule(seed, e, n, hubs, carry):
    a, b, dyn_a, dyn_b, mask, prev = _graph(seed, e, n, hubs)
    prev_j = prev if carry else None
    ref, ref_ovf = jax.jit(jcolor, static_argnums=(5, 6))(
        a, b, dyn_a, dyn_b, mask, n, MAX_COLORS, prev_color=prev_j)
    col, ovf = tcol.color_constraints(
        _t(a), _t(b), _t(dyn_a), _t(dyn_b), _t(mask), n, MAX_COLORS,
        prev_color=_t(prev) if carry else None)
    np.testing.assert_array_equal(col.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(ref_ovf))
    s_col, s_ovf = _scalar_colors(a, b, dyn_a, dyn_b, mask, n, MAX_COLORS,
                                  prev if carry else np.full(e, -1, np.int32))
    np.testing.assert_array_equal(s_col, np.asarray(ref))
    np.testing.assert_array_equal(s_ovf, np.asarray(ref_ovf))
    # Proper: within a non-overflow color no dynamic body appears twice.
    col = col.numpy()
    for c in range(MAX_COLORS - 1):
        sel = mask & (col == c)
        ends = np.concatenate([a[sel & dyn_a], b[sel & dyn_b]])
        assert len(ends) == len(set(ends.tolist()))
    if hubs:
        degree = np.bincount(np.concatenate([a[mask & dyn_a], b[mask & dyn_b]]), minlength=n)
        assert degree.max() > kg.MAX_DEGREE and np.asarray(ref_ovf).sum() > 0
    if carry:
        kept = mask & (prev >= 0) & (prev < MAX_COLORS - 1) & (col == prev)
        assert 0 < kept.sum() < (mask & (prev >= 0)).sum()  # some kept, some demoted


@pytest.mark.parametrize("cap", [64, 7], ids=["roomy", "tight"])
def test_bucketize_matches_reference(cap):
    rng = np.random.default_rng(11)
    c = 200
    color = rng.integers(0, MAX_COLORS, size=c).astype(np.int32)
    active = rng.uniform(size=c) < 0.8
    ref = jax.jit(partial(jbucketize, num_colors=MAX_COLORS, cap=cap))(color, active)
    buckets, valid, dropped, _ = tsol._bucketize(_t(color), _t(active), MAX_COLORS, cap)
    np.testing.assert_array_equal(buckets.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref[1]))
    assert int(dropped) == int(ref[2])
    _, _, dropped2, num_overflow = kg.bucket_edges(_t(color), _t(active), MAX_COLORS, cap)
    assert int(dropped2) == int(dropped)
    assert int(num_overflow) == int(valid[-1].sum()) + int(dropped)
    assert (int(dropped) > 0) == (cap == 7)


def test_run_rank_is_the_position_within_the_run():
    """The helper against the scan it replaces: ``index - cummax(index where a
    run starts)``."""
    rng = np.random.default_rng(0)
    keys = np.sort(rng.integers(0, 9, size=500)).astype(np.int32)
    keys[-40:] = 2**31 - 1
    idx = np.arange(keys.shape[0])
    starts = np.where(np.r_[True, keys[1:] != keys[:-1]], idx, 0)
    expect = idx - np.maximum.accumulate(starts)
    rank = run_rank(_t(keys))
    assert rank.dtype == torch.int32
    np.testing.assert_array_equal(rank.numpy(), expect)
    assert run_rank(torch.zeros((0,), dtype=torch.int32)).shape == (0,)
    with pytest.raises(TypeError):
        run_rank(_t(keys).long())


@pytest.mark.parametrize("fn", ["color_edges", "bucket_edges", "run_rank"])
def test_wrappers_refuse_other_devices(fn):
    """No silent fallback: a tensor neither on the CPU nor on a CUDA card is
    refused."""
    x = torch.zeros(4, dtype=torch.int32, device="meta")
    f = torch.zeros(4, dtype=torch.bool, device="meta")
    with pytest.raises(RuntimeError):
        if fn == "color_edges":
            kg.color_edges(x, x, f, f, f, 4, MAX_COLORS)
        elif fn == "bucket_edges":
            kg.bucket_edges(x, f, MAX_COLORS, 2)
        else:
            run_rank(x)
