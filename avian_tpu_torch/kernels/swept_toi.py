"""Kernel R, ``swept_toi``: swept-CCD times of impact of the K swept
colliders against every collider.

Replaces the K x M grid of ``avian_tpu/pipeline/ccd.py::solve_swept_ccd``
(:40, with ``toi_one`` :85, ``vs_other`` :97 and ``body_fn`` :104): for each
pair, 8 rounds of conservative advancement in relative motion on the
narrowphase's manifold of the two colliders posed at t. The reference runs
every listed pair function on every pair of the grid under ``vmap`` +
``lax.switch``; here the caller (``pipeline/ccd.py``) buckets the grid's
pairs by canonical shape pair and launches one instance per bucket.

A pair is one to eight manifolds (up to some 15,000 dependent f32 operations
each for a support-map pair) on two colliders' rows read once, so the kernel
is bound by operations and latency, not bytes. The CUDA source
(``csrc/swept_toi.cuh``) gives one thread to each pair and calls the pair's
device function of Kernels A, M, N, O, P or Q (``csrc/pair_dispatch.cuh``);
its instances are split over three translation units by pair group, so that
the parallel build keeps its wall time. A pair stops once it has hit or once
t >= 1. It follows the plain version's arithmetic operation by operation
(``-fmad=false``, IEEE ``sqrt`` and division); only the nonlinear mode's
``sinf``/``cosf`` may differ by an ulp from the plain version's.

The plain PyTorch version, ``swept_toi_twin``, runs on CPU tensors; on a CUDA
tensor the wrapper launches the kernel or raises. Both write min(TOI, 1) of
each pair into ``toi[r * m + j]``: the TOI where the pair hits, the last
time it is known not to have met by where its rounds ran out, 1 where it is
invalid or passes t = 1. ``swept_toi_twin`` says where this departs from
the reference, and why.
"""

from typing import NamedTuple

import torch

from avian_tpu_torch.kernels.convex_manifold import _disc_table
from avian_tpu_torch.math import quat as quat_m
from avian_tpu_torch.math import vec

ROUNDS = 8
# A pair already touching at t = 0 hits once the sweep has carried it this
# share of the thicker collider's inner radius deep (``swept_toi_twin``); a
# choice of this package, not a rule of the reference or the upstream engine.
DEEPER = 0.5
# The translation unit (entry point suffix) of each canonical pair's kernel.
GROUP = {
    "box_manifold": "analytic", "round_manifold": "analytic",
    "plane_patch_manifold": "analytic", "plane_hull_manifold": "analytic",
    "convex_manifold": "generic", "hull_manifold": "hull",
}


class SweptTables(NamedTuple):
    """Per-collider inputs of the grid, contiguous on one device."""

    pos0: torch.Tensor        # f32[M, 3] collider positions at t = 0
    quat0: torch.Tensor       # f32[M, 4]
    sweep: torch.Tensor       # f32[M, 3] delta position of each collider's body
    aa: torch.Tensor          # f32[M, 3] scaled-axis rotation (0 in the linear mode)
    ang: torch.Tensor         # f32[M] angular travel bound
    inner: torch.Tensor       # f32[M] inner radius (``pipeline/ccd.py::inner_radius``)
    params: torch.Tensor      # f32[M, 8]
    shape_type: torch.Tensor  # i32[M]
    body_idx: torch.Tensor    # i32[M]
    active: torch.Tensor      # bool[M]
    layer_m: torch.Tensor     # i32[M] u32 bit patterns
    layer_f: torch.Tensor     # i32[M]
    pool: torch.Tensor        # f32[V, 3] the vertex pool


def rotation_at(aa, t):
    """``quat.from_scaled_axis(aa * t)`` with a correctly rounded square
    root, as the kernel computes it."""
    v = aa * t[:, None]
    angle_sq = vec.length_sq(v)
    angle = vec.sqrt_rn(torch.clamp(angle_sq, min=1e-30))
    small = angle_sq < 1e-12
    half = 0.5 * angle
    s = torch.where(small, 0.5 - angle_sq / 48.0, torch.sin(half) / angle)
    w = torch.where(small, 1.0 - angle_sq / 8.0, torch.cos(half))
    return torch.cat([v * s[:, None], w[:, None]], dim=-1)


def swept_toi_twin(pair, flat, swept, m, tab: SweptTables, toi):
    """Plain PyTorch version; see ``swept_toi``. Reproduces the reference's
    loop: every round of every pair, no early exit, with two repairs of
    faults that let the reference's swept capsules through the terrain
    (ROADMAP 3b). Both are this package's own rules, taken neither from the
    reference nor from the upstream engine:

    - the reference drops every pair that touches at t = 0 (``sep0 <=
      1e-4``) and leaves it to the contact solver, which a fast spinning
      body pivots through, and which lets a skidding ball sink a few
      centimetres a step until it is through. Here such a pair advances
      toward a depth of ``deeper`` (``DEEPER`` x the larger of the two inner
      radii: that deep, a body is halfway through the thicker of the two),
      or toward 2e-4 past its depth at t = 0 where that is deeper already,
      and hits within 1e-4 of it, as the others hit within 1e-4 of 0 (so a
      body already that deep may move on, but no deeper): the sweep stops
      a body carried through what it touches, and leaves one that rests,
      slides or sinks no deeper than a contact does alone;
    - the reference returns 1 for a pair whose advancement has not hit
      within its 8 rounds, though every round's t is a time the pair is
      known not to have met by: a spinning body's angular bound keeps the
      steps short and lets it through a triangle it was still closing on.
      Here such a pair returns its last t (1 once t >= 1).

    Pairs apart at t = 0 that hit, or pass t = 1, within the rounds advance
    and return exactly as in the reference."""
    from avian_tpu_torch.geometry.narrowphase import pair_manifold_twin

    flat = flat.long()
    r = flat // m
    j = flat - r * m
    i = swept.long()[r]
    swap = tab.shape_type[i] > tab.shape_type[j]
    s2 = swap[:, None]
    d_rel = tab.sweep[i] - tab.sweep[j]
    dist = vec.length_rn(d_rel)
    x_axis = torch.tensor([1.0, 0.0, 0.0], device=flat.device).expand_as(d_rel)
    dirn = vec.normalize_or_rn(d_rel, x_axis)
    ang = tab.ang[i] + tab.ang[j]
    deeper = DEEPER * torch.maximum(tab.inner[i], tab.inner[j])
    prm_a = torch.where(s2, tab.params[j], tab.params[i])
    prm_b = torch.where(s2, tab.params[i], tab.params[j])
    t = torch.zeros_like(dist)
    done = torch.zeros_like(swap)
    goal = t
    for k in range(ROUNDS):
        qi = quat_m.mul(rotation_at(tab.aa[i], t), tab.quat0[i])
        qj = quat_m.mul(rotation_at(tab.aa[j], t), tab.quat0[j])
        xi = tab.pos0[i] + tab.sweep[i] * t[:, None]
        xj = tab.pos0[j] + tab.sweep[j] * t[:, None]
        normal, _, _, sep4, _, _ = pair_manifold_twin(
            pair, torch.where(s2, xj, xi), torch.where(s2, qj, qi), prm_a,
            torch.where(s2, xi, xj), torch.where(s2, qi, qj), prm_b, tab.pool)
        sep = sep4.amin(1)
        nij = torch.where(s2, -normal, normal)
        if k == 0:
            touching = sep <= 1e-4
            goal = torch.where(touching, torch.minimum(-deeper, sep - 2e-4), 0.0)
        approach = vec.dot(dirn, nij) * dist + ang
        hit = sep < goal + 1e-4
        step = torch.where(approach > 1e-6, (sep - goal) / torch.clamp(approach, min=1e-6), 2.0)
        new_t = torch.where(done | hit, t, t + torch.clamp(step, min=0.0))
        t = torch.clamp(new_t, max=1.5)
        done = done | hit
    layers_ok = ((tab.layer_m[i] & tab.layer_f[j]) != 0) & ((tab.layer_m[j] & tab.layer_f[i]) != 0)
    valid = (j != i) & tab.active[j] & (tab.body_idx[j] != tab.body_idx[i]) & layers_ok
    toi[flat] = torch.where(valid, torch.clamp(t, max=1.0), 1.0)
    return toi


def swept_toi(pair, flat, swept, m, tab: SweptTables, toi, rounds=None):
    """Write min(TOI, 1) of the pairs ``flat`` (i32[P], ``r * m + j``: swept
    collider ``swept[r]`` against collider ``j``), all of canonical shape pair
    ``pair``, into ``toi`` (f32[K * m]); returns ``toi``. A pair stops once
    it has hit or t >= 1. With ``rounds`` (i32[K * m], the kernel only) each
    pair's rounds are written too, negated where a valid pair ran all
    ``ROUNDS`` without a hit and t stayed below 1 (it returns its last t): the
    data-dependent work of the launch, and how often the second repair of
    ``swept_toi_twin`` acts."""
    from avian_tpu_torch.geometry.narrowphase import PAIR_KERNELS

    if pair not in PAIR_KERNELS:
        raise ValueError(f"swept_toi: no kernel for shape pair {pair}")
    if flat.device.type == "cpu":
        if rounds is not None:
            raise ValueError("swept_toi: the plain version counts no rounds")
        return swept_toi_twin(pair, flat, swept, m, tab, toi)
    if flat.device.type != "cuda":
        raise RuntimeError(f"swept_toi: unsupported device {flat.device}")
    from avian_tpu_torch.kernels import build

    dev, f32, i32 = flat.device, torch.float32, torch.int32
    m_n = tab.pos0.shape[0]
    build.require("swept_toi", dev, [
        ("flat", flat, flat.shape, i32), ("swept", swept, swept.shape, i32),
        ("toi", toi, toi.shape, f32),
        ("pos0", tab.pos0, (m_n, 3), f32), ("quat0", tab.quat0, (m_n, 4), f32),
        ("sweep", tab.sweep, (m_n, 3), f32), ("aa", tab.aa, (m_n, 3), f32),
        ("ang", tab.ang, (m_n,), f32), ("inner", tab.inner, (m_n,), f32),
        ("params", tab.params, (m_n, 8), f32),
        ("shape_type", tab.shape_type, (m_n,), i32), ("body_idx", tab.body_idx, (m_n,), i32),
        ("active", tab.active, (m_n,), torch.bool), ("layer_m", tab.layer_m, (m_n,), i32),
        ("layer_f", tab.layer_f, (m_n,), i32),
        ("pool", tab.pool, tab.pool.shape, f32),
    ] + ([] if rounds is None else [("rounds", rounds, toi.shape, i32)]))
    if m != m_n or toi.shape[0] != swept.shape[0] * m:
        raise ValueError("swept_toi: toi must be f32[K * M] for K swept colliders")
    n = flat.shape[0]
    if n:
        group = GROUP[PAIR_KERNELS[pair][1]]
        build.launch(f"avian_swept_toi_{group}", dev, pair[0] * 16 + pair[1], n, m, flat, swept,
                     *tab[:12], _disc_table(dev), tab.pool, toi, rounds)
        swept_toi.launches += 1
    return toi


swept_toi.launches = 0
