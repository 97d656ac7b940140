"""Kernel AB, ``swept_toi_2d``: the 2D engine's swept-CCD times of impact of
the K swept colliders against every collider.

Replaces the K x M grid of ``avian_tpu/dim2/ccd.py::solve_swept_ccd_2d``
(:28, with ``toi_one`` :70, ``vs_other`` :72 and ``body_fn`` :87): for each
pair, 8 rounds of conservative advancement in relative motion on Kernel V's
manifold of the two colliders posed at t (positions along this step's delta
positions, angles, in the nonlinear mode, along the accumulated delta
angles), the step widened by both colliders' angular travel bound; then the
validity mask (:108-115) and the minimum of each swept collider's body.

The CUDA source (``csrc/swept_toi_2d.cu``, device code
``d2::swept_toi_pair_2d`` in ``csrc/dim2.cuh``) gives one thread to each
pair and calls V's device code, so every 2D shape pair is one instance. A
pair stops once it has hit or once t >= 1. The body minimum is an integer
``atomicMin`` on the bits of the non-negative TOIs (exact, in any order);
the plain version's is ``scatter_reduce(amin)``. A round is one manifold
(up to some 1,500 dependent operations for a polygon pair) on two
colliders' rows read once, so the kernel is bound by operations and latency,
not bytes.

Trigonometry: the cosine and sine of each collider's angle at t = 0 come in
(this step's poses), and a collider that does not turn along its sweep (the
linear mode, or no rotation) uses them at every t, in the kernel and its
twin alike; a turning collider's come from ``cosf``/``sinf`` in the kernel
and ``torch.cos``/``torch.sin`` in the twin, which may round apart by an
ulp. Every other operation follows the plain version's order
(``-fmad=false``).

The plain PyTorch version, ``swept_toi_2d_twin``, runs on CPU tensors; on a
CUDA tensor the wrapper launches the kernel or raises. ``swept_toi_2d_twin``
says where both depart from the reference, and why.
"""

from typing import NamedTuple

import torch

from avian_tpu_torch.kernels.manifold_2d import manifold_2d_twin, norm2

ROUNDS = 8
# A pair already touching at t = 0 hits once the sweep has carried it this
# share of the thinner collider's inner radius deep (``swept_toi_2d_twin``);
# the 3D sweep's rule (``kernels/swept_toi.py::DEEPER``) measured from the
# thinner shape, not a rule of the reference or the upstream engine.
DEEPER = 0.5


def touch_depth(inner_i, inner_j):
    """How deep a pair that touches at t = 0 may be carried: ``DEEPER`` x the
    smaller of the two inner radii, where a collider with none (a half-space
    or a segment) counts as the other. The 3D sweep takes the larger, which
    lets a thin bullet's centre 0.2 m into a 1 m box; here a swept body's
    centre stops short of the face of what it touches."""
    a = torch.where(inner_i > 0.0, inner_i, inner_j)
    b = torch.where(inner_j > 0.0, inner_j, inner_i)
    return DEEPER * torch.minimum(a, b)


class SweptTables2D(NamedTuple):
    """Per-collider inputs of the grid, contiguous on one device."""

    pos0: torch.Tensor      # f32[M, 2] collider positions at t = 0
    cs0: torch.Tensor       # f32[M, 2] cosine and sine of the angle at t = 0
    angle0: torch.Tensor    # f32[M]
    sweep: torch.Tensor     # f32[M, 2] delta position of each collider's body
    dang: torch.Tensor      # f32[M] delta angle along the sweep (0 in the linear mode)
    ang: torch.Tensor       # f32[M] angular travel bound
    inner: torch.Tensor     # f32[M] inner radius (``dim2/ccd.py::inner_radius``)
    verts: torch.Tensor     # f32[M, 8, 2]
    count: torch.Tensor     # i32[M]
    radius: torch.Tensor    # f32[M]
    plane: torch.Tensor     # bool[M]
    body_idx: torch.Tensor  # i32[M]
    active: torch.Tensor    # bool[M]
    layer_m: torch.Tensor   # i32[M] u32 bit patterns
    layer_f: torch.Tensor   # i32[M]


def _pose_at(tab: SweptTables2D, k, t):
    """Positions and (cos, sin) of colliders ``k`` at times ``t``."""
    x = tab.pos0[k] + tab.sweep[k] * t[:, None]
    da = tab.dang[k]
    a = tab.angle0[k] + da * t
    turned = torch.stack([torch.cos(a), torch.sin(a)], -1)
    return x, torch.where((da != 0.0)[:, None], turned, tab.cs0[k])


def swept_toi_2d_twin(swept, tab: SweptTables2D, n_bodies):
    """Plain PyTorch version; see ``swept_toi_2d``. Reproduces the
    reference's loop, every round of every pair with no early exit, with the
    two repairs the 3D sweep makes (``kernels/swept_toi.py``, ROADMAP 3b),
    so that the two engines sweep alike. Both are this package's own rules:

    - the reference drops every pair that touches at t = 0 (``sep0 <=
      1e-4``) and leaves it to the contact solver. Here such a pair advances
      toward a depth of ``touch_depth`` (``DEEPER`` x the smaller of the two
      inner radii) or 2e-4 past its depth at t = 0, where that is deeper
      already, and hits within 1e-4 of it, as the others hit within 1e-4 of
      0;
    - the reference returns 1 for a pair whose advancement has not hit within
      its 8 rounds, though every round's t is a time the pair is known not
      to have met by. Here such a pair returns its last t (1 once t >= 1).

    Pairs apart at t = 0 that hit, or pass t = 1, within the rounds advance
    and return exactly as in the reference."""
    m = tab.pos0.shape[0]
    dev = tab.pos0.device
    k_n = swept.shape[0]
    flat = torch.arange(k_n * m, device=dev)
    r = flat // m
    j = flat - r * m
    i = swept.long()[r]
    d_rel = tab.sweep[i] - tab.sweep[j]
    dist = norm2(d_rel)
    x_axis = torch.tensor([1.0, 0.0], device=dev).expand_as(d_rel)
    dirn = torch.where((dist > 1e-9)[:, None], d_rel / torch.clamp(dist, min=1e-9)[:, None],
                       x_axis)
    ang = tab.ang[i] + tab.ang[j]
    deeper = touch_depth(tab.inner[i], tab.inner[j])
    p = flat.numel()
    ca = torch.arange(p, device=dev)
    ij = torch.cat([i, j])
    shape = (tab.verts[ij], tab.count[ij], tab.radius[ij], tab.plane[ij])
    t = torch.zeros_like(dist)
    goal = t
    done = torch.zeros_like(dist, dtype=torch.bool)
    for k in range(ROUNDS):
        xi, csi = _pose_at(tab, i, t)
        xj, csj = _pose_at(tab, j, t)
        man = manifold_2d_twin(ca, ca + p, torch.cat([xi, xj]), torch.cat([csi, csj]), *shape)
        sep = man.separation.amin(1)
        if k == 0:
            goal = torch.where(sep <= 1e-4, torch.minimum(-deeper, sep - 2e-4), 0.0)
        approach = (dirn[:, 0] * man.normal[:, 0] + dirn[:, 1] * man.normal[:, 1]) * dist + ang
        hit = sep < goal + 1e-4
        step = torch.where(approach > 1e-6, (sep - goal) / torch.clamp(approach, min=1e-6), 2.0)
        new_t = torch.where(done | hit, t, t + torch.clamp(step, min=0.0))
        t = torch.clamp(new_t, max=1.5)
        done = done | hit
    layers_ok = ((tab.layer_m[i] & tab.layer_f[j]) != 0) & ((tab.layer_m[j] & tab.layer_f[i]) != 0)
    valid = (j != i) & tab.active[j] & (tab.body_idx[j] != tab.body_idx[i]) & layers_ok
    toi = torch.where(valid, torch.clamp(t, max=1.0), 1.0)
    body_toi = torch.ones((n_bodies,), dtype=torch.float32, device=dev)
    body_toi.scatter_reduce_(0, tab.body_idx[i].long(), toi, "amin")
    return toi, body_toi


def swept_toi_2d(swept, tab: SweptTables2D, n_bodies, rounds=None):
    """``(toi f32[K * M], body_toi f32[n_bodies])``: min(TOI, 1) of each pair
    of swept collider ``swept[r]`` (i32[K]) against collider ``j`` at
    ``toi[r * M + j]`` (1 where the pair is invalid or passes t = 1), and
    each body's least TOI over its swept colliders (1 for the others). With
    ``rounds`` (i32[K * M], the kernel only) each pair's rounds are written
    too, negated where a valid pair ran all ``ROUNDS`` without a hit and t
    stayed below 1 (it returns its last t): the data-dependent work of the
    launch, and how often the second repair of ``swept_toi_2d_twin`` acts."""
    dev = swept.device
    if dev.type == "cpu":
        if rounds is not None:
            raise ValueError("swept_toi_2d: the plain version counts no rounds")
        return swept_toi_2d_twin(swept, tab, n_bodies)
    if dev.type != "cuda":
        raise RuntimeError(f"swept_toi_2d: unsupported device {dev}")
    from avian_tpu_torch.kernels import build

    f32, i32, u8 = torch.float32, torch.int32, torch.bool
    m, k_n = tab.pos0.shape[0], swept.shape[0]
    build.require("swept_toi_2d", dev, [
        ("swept", swept, (k_n,), i32), ("pos0", tab.pos0, (m, 2), f32),
        ("cs0", tab.cs0, (m, 2), f32), ("angle0", tab.angle0, (m,), f32),
        ("sweep", tab.sweep, (m, 2), f32), ("dang", tab.dang, (m,), f32),
        ("ang", tab.ang, (m,), f32), ("inner", tab.inner, (m,), f32),
        ("verts", tab.verts, (m, 8, 2), f32), ("count", tab.count, (m,), i32),
        ("radius", tab.radius, (m,), f32), ("plane", tab.plane, (m,), u8),
        ("body_idx", tab.body_idx, (m,), i32), ("active", tab.active, (m,), u8),
        ("layer_m", tab.layer_m, (m,), i32), ("layer_f", tab.layer_f, (m,), i32),
    ] + ([] if rounds is None else [("rounds", rounds, (k_n * m,), i32)]))
    toi = torch.empty((k_n * m,), dtype=f32, device=dev)
    body_toi = torch.ones((n_bodies,), dtype=f32, device=dev)
    if k_n * m:
        build.launch("avian_swept_toi_2d", dev, k_n, m, swept, *tab, toi, rounds, body_toi)
        swept_toi_2d.launches += 1
    return toi, body_toi


swept_toi_2d.launches = 0
