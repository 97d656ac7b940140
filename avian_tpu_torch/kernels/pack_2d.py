"""Kernel X, ``pack_2d``: the 2D engine's packed, colour-bucketed contact rows.

Replaces ``avian_tpu/dim2/solver.py::prepare_constraints`` (:87) around the
colouring (Kernel G): the dominance rule (:106-116), the softness pair
(:117-124), normal and tangent effective masses, initial separation and
normal speed, the point mask, the 33-float row layout (:25-42) and the
overflow colour's relaxation ``1 / max per-body multiplicity`` (:181-190).

The reference builds a ``[C, 33]`` row per contact and gathers the rows into
bucket order. The kernel (``csrc/pack_2d.cu``) gives one thread to each
bucket slot, which reads its contact and both bodies and writes its row
straight in bucket order. Two launches: ``avian_pack_count_2d`` counts the
overflow colour's rows per dynamic body with an int32 ``atomicAdd`` (order
free, so reruns are bitwise equal), then ``avian_pack_rows_2d`` writes
``data``, ``imp``, ``bucket_a``/``bucket_b`` and ``relax``. A padded slot
packs its constraint (contact 0) with a zero point mask. Every sum is
spelled in the plain version's order and a zero ``k`` gives a zero mass. On
the H100 the rows launch is bound by bytes (about 120 read and 200 written a
slot).

The plain PyTorch version, ``pack_2d_twin``, runs on CPU tensors; on a CUDA
tensor the wrapper launches the kernels or raises.
"""

from typing import NamedTuple

import torch

from avian_tpu_torch.core import types
from avian_tpu_torch.kernels import solve_2d as ky


class Packed2D(NamedTuple):
    data: torch.Tensor      # f32[colors, cap, 33]
    imp: torch.Tensor       # f32[colors, cap, 6]
    bucket_a: torch.Tensor  # i32[colors, cap]
    bucket_b: torch.Tensor  # i32[colors, cap]
    relax: torch.Tensor     # f32[colors, cap]


def _cross(a, bx, by):
    return a[..., 0] * by - a[..., 1] * bx


def pack_2d_twin(bodies, contacts, state, inv_mass, inv_inertia, dyn_a, dyn_b, solve,
                 buckets, bucket_valid, dyn_soft, non_dyn_soft) -> Packed2D:
    """Plain PyTorch version; see ``pack_2d``."""
    b = bodies
    ba, bb = contacts.body_a.long(), contacts.body_b.long()
    c = contacts.capacity
    n_bodies = b.capacity
    dev = ba.device

    eff_dom = torch.where((b.body_type == types.BodyType.DYNAMIC) & ~b.sleeping,
                          b.dominance, 127)
    rel_dom = eff_dom[ba] - eff_dom[bb]
    a_static, b_static = rel_dom > 0, rel_dom < 0
    ima = torch.where(a_static[:, None], 0.0, inv_mass[ba])
    iia = torch.where(a_static, 0.0, inv_inertia[ba])
    imb = torch.where(b_static[:, None], 0.0, inv_mass[bb])
    iib = torch.where(b_static, 0.0, inv_inertia[bb])
    softness = torch.where(
        (rel_dom != 0)[:, None],
        torch.tensor(non_dyn_soft, dtype=torch.float32, device=dev)[None, :],
        torch.tensor(dyn_soft, dtype=torch.float32, device=dev)[None, :],
    )

    n = contacts.normal
    nx, ny = n[:, None, 0], n[:, None, 1]
    tx, ty = ny, -nx
    r1, r2 = contacts.anchor_a, contacts.anchor_b
    im_sum = ima + imb
    sx, sy = im_sum[:, None, 0], im_sum[:, None, 1]
    r1xn, r2xn = _cross(r1, nx, ny), _cross(r2, nx, ny)
    k_normal = ((nx * (sx * nx) + ny * (sy * ny))
                + iia[:, None] * r1xn * r1xn + iib[:, None] * r2xn * r2xn)
    normal_mass = torch.where(k_normal > 1e-12, 1.0 / k_normal, 0.0)
    r1xt, r2xt = _cross(r1, tx, ty), _cross(r2, tx, ty)
    k_tangent = ((tx * (sx * tx) + ty * (sy * ty))
                 + iia[:, None] * r1xt * r1xt + iib[:, None] * r2xt * r2xt)
    tangent_mass = torch.where(k_tangent > 1e-12, 1.0 / k_tangent, 0.0)

    dr = r2 - r1
    initial_separation = -contacts.penetration - (dr[..., 0] * nx + dr[..., 1] * ny)

    def pvel(body, r):
        v, w = state[body, 0:2], state[body, 2][:, None]
        return v[:, None, 0] + w * -r[..., 1], v[:, None, 1] + w * r[..., 0]

    vbx, vby = pvel(bb, r2)
    vax, vay = pvel(ba, r1)
    normal_speed = (vbx - vax) * nx + (vby - vay) * ny
    lanes = torch.arange(2, device=dev)[None, :]
    point_mask = ((lanes < contacts.num_points[:, None]) & solve[:, None]).float()

    last, lvalid = buckets[-1], bucket_valid[-1]
    la = torch.where(lvalid & dyn_a[last], ba[last], n_bodies)
    lb = torch.where(lvalid & dyn_b[last], bb[last], n_bodies)
    cnt = torch.zeros((n_bodies + 1,), dtype=torch.float32, device=dev)
    ones = torch.ones_like(la, dtype=torch.float32)
    cnt.index_add_(0, la, ones)
    cnt.index_add_(0, lb, ones)
    cnt[n_bodies] = 1.0
    relax = torch.ones(buckets.shape, dtype=torch.float32, device=dev)
    relax[-1] = 1.0 / torch.clamp(torch.maximum(cnt[la], cnt[lb]), min=1.0)

    data = torch.cat([
        n, contacts.friction[:, None], contacts.static_friction[:, None],
        contacts.restitution[:, None], softness, ima, imb, iia[:, None], iib[:, None],
        r1.reshape(c, 4), r2.reshape(c, 4), initial_separation, normal_mass, tangent_mass,
        normal_speed, point_mask, contacts.surface_speed[:, None],
    ], dim=-1)
    imp = torch.cat([contacts.normal_impulse, contacts.tangent_impulse,
                     torch.zeros((c, 2), device=dev)], dim=-1)
    data_b = data[buckets]
    data_b[:, :, ky.PM:ky.PM + 2] *= bucket_valid[:, :, None].float()
    return Packed2D(
        data=data_b.contiguous(), imp=imp[buckets].contiguous(),
        bucket_a=ba[buckets].to(torch.int32).contiguous(),
        bucket_b=bb[buckets].to(torch.int32).contiguous(), relax=relax,
    )


def pack_2d(bodies, contacts, state, inv_mass, inv_inertia, dyn_a, dyn_b, solve, buckets,
            bucket_valid, dyn_soft, non_dyn_soft) -> Packed2D:
    """The 2D constraint rows of every bucket slot, in bucket order.

    ``bodies``: the world's ``Bodies2D``; ``contacts``: this step's
    ``Contacts2D``; ``state`` f32[N, 6], ``inv_mass`` f32[N, 2],
    ``inv_inertia`` f32[N]: the solver bodies; ``dyn_a``/``dyn_b``/``solve``
    bool[C]: which ends respond and which contacts are solved; ``buckets``
    i64[colors, cap] and ``bucket_valid`` bool[colors, cap]: from Kernel G;
    ``dyn_soft``/``non_dyn_soft``: (bias, mass scale, impulse scale) between
    equals and against a dominant body."""
    dev = buckets.device
    if dev.type == "cpu":
        return pack_2d_twin(bodies, contacts, state, inv_mass, inv_inertia, dyn_a, dyn_b,
                            solve, buckets, bucket_valid, dyn_soft, non_dyn_soft)
    if dev.type != "cuda":
        raise RuntimeError(f"pack_2d: unsupported device {dev}")
    from avian_tpu_torch.kernels import build

    c, n = contacts.capacity, bodies.capacity
    colors, cap = buckets.shape
    f32, i32, u8 = torch.float32, torch.int32, torch.bool
    inputs = (
        ("buckets", buckets, (colors, cap), torch.int64),
        ("bucket_valid", bucket_valid, (colors, cap), u8),
        ("body_a", contacts.body_a, (c,), i32), ("body_b", contacts.body_b, (c,), i32),
        ("dyn_a", dyn_a, (c,), u8), ("dyn_b", dyn_b, (c,), u8), ("solve", solve, (c,), u8),
        ("normal", contacts.normal, (c, 2), f32),
        ("anchor_a", contacts.anchor_a, (c, 2, 2), f32),
        ("anchor_b", contacts.anchor_b, (c, 2, 2), f32),
        ("penetration", contacts.penetration, (c, 2), f32),
        ("num_points", contacts.num_points, (c,), i32),
        ("friction", contacts.friction, (c,), f32),
        ("static_friction", contacts.static_friction, (c,), f32),
        ("restitution", contacts.restitution, (c,), f32),
        ("surface_speed", contacts.surface_speed, (c,), f32),
        ("normal_impulse", contacts.normal_impulse, (c, 2), f32),
        ("tangent_impulse", contacts.tangent_impulse, (c, 2), f32),
        ("body_type", bodies.body_type, (n,), i32), ("sleeping", bodies.sleeping, (n,), u8),
        ("dominance", bodies.dominance, (n,), i32), ("state", state, (n, ky.STATE), f32),
        ("inv_mass", inv_mass, (n, 2), f32), ("inv_inertia", inv_inertia, (n,), f32),
    )
    build.require("pack_2d", dev, inputs)
    out = Packed2D(
        data=torch.empty((colors, cap, ky.D), dtype=f32, device=dev),
        imp=torch.empty((colors, cap, ky.IMP), dtype=f32, device=dev),
        bucket_a=torch.empty((colors, cap), dtype=i32, device=dev),
        bucket_b=torch.empty((colors, cap), dtype=i32, device=dev),
        relax=torch.empty((colors, cap), dtype=f32, device=dev),
    )
    cnt = torch.zeros((n,), dtype=i32, device=dev)
    build.launch("avian_pack_count_2d", dev, cap, buckets[-1], bucket_valid[-1],
                 contacts.body_a, contacts.body_b, dyn_a, dyn_b, cnt)
    pack_2d.launches += 1
    build.launch("avian_pack_rows_2d", dev, colors, cap, *(x for _, x, _, _ in inputs), cnt,
                 *out, *(float(x) for x in dyn_soft), *(float(x) for x in non_dyn_soft))
    pack_2d.launches += 1
    return out


pack_2d.launches = 0
