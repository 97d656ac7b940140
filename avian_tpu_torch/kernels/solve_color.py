"""Kernel D, ``solve_color``: one color of the contact solver.

Replaces, per color, ``avian_tpu/pipeline/solver.py::warm_start`` (:370),
``_solve_bucket`` (:451, modes ``BIAS`` and ``RELAX``) and
``_restitution_bucket`` (:616). The caller launches it once per color per
pass in the reference's color order, so a substep is ``3 * max_colors``
launches and the restitution pass ``max_colors`` more.

On the H100 each launch is small (one color's rows, each 88 + 16 floats of
constraint data and two 13-float body rows) and the substep is a chain of
such launches, so the solver is bound by launch latency and by the
dependent gathers of body state; the kernel's arithmetic (4 sequential
normal points, then 4 two-axis friction points) is cheap. The CUDA kernel
(``csrc/solve_color.cu``) gives one thread to each bucket row and keeps the
row's body velocities and accumulated deltas in registers. Rules that keep
it right and bitwise reproducible without any float atomics:

- a padded bucket slot (``bucket_valid`` false) points at constraint 0 and
  so at a real body; its thread writes nothing;
- an endpoint whose inverse mass and inertia are all zero (static ground,
  dominance) gets exactly zero deltas; the kernel skips that write, so the
  ground body shared by most rows of a color is never written;
- colors ``0 .. max_colors - 2`` share no dynamic body, so each thread adds
  its deltas to its bodies directly;
- the last color is the overflow color, whose rows may share dynamic
  bodies. As in the reference, every row reads body state before any
  write: phase 1 writes each row's deltas to a scratch buffer, phase 2
  gives one thread to each body and adds that body's deltas in a fixed
  order (the order of ``[a-sides..., b-sides...]``, the reference's
  scatter order), using the per-step ``overflow_order``/``overflow_key``.
- ``WARM`` runs per color through the same rules, so ``warm_start`` also
  touches each body once per launch.

Deltas touch only the velocity columns of the ``[N, 13]`` state (the
reference's ``z7`` padding). ``state`` and ``imp`` are updated in place:
the colors of a pass are sequential, and copying both per color would
double the memory traffic.

The plain PyTorch version, ``solve_color_twin``, runs on CPU tensors; on a
CUDA tensor the wrapper launches the kernel or raises.
"""

import ctypes
from typing import NamedTuple

import torch

from avian_tpu_torch.math import quat as quat_m

WARM, BIAS, RELAX, RESTITUTION = 0, 1, 2, 3

# Packed per-constraint row layout data[colors, cap, 88] (reference :46-67).
N_ = 0          # 0:3 normal
T1 = 3          # 3:6 tangent1
T2 = 6          # 6:9 tangent2
FRICTION = 9
RESTITUTION_COL = 10
SOFT = 11       # 11:14 (bias, mass_scale, impulse_scale)
IMA = 14        # 14:17 inv mass a (per axis)
IMB = 17
IIA = 20        # 20:26 inv inertia a (sym6)
IIB = 26
AA = 32         # 32:44 anchors a (4 x 3)
AB = 44         # 44:56 anchors b
SEP = 56        # 56:60 initial separation
NM = 60         # 60:64 normal effective mass
TK = 64         # 64:76 tangent k1, k2, k12 per point
NS = 76         # 76:80 initial normal speed
PM = 80         # 80:84 point mask
SV = 84         # 84:87 surface velocity
SF = 87         # static friction coefficient
D = 88
IMP = 16        # imp[.., 16]: 0:4 normal, 4:12 tangent (4 x 2), 12:16 total


class SolveParams(NamedTuple):
    h: float                   # substep dt
    max_overlap_speed: float
    stiction_t2: float         # squared stiction speed threshold
    warm_coefficient: float
    restitution_threshold: float


def _mv(m, v):
    """``m @ v`` for m [R, 3, 3], v [R, 3], each row summed left to right as
    the kernel does: ``(m0 * x + m1 * y) + m2 * z``."""
    t = m * v[:, None, :]
    return t[..., 0] + t[..., 1] + t[..., 2]


def _sym_mat(s):
    """sym6 [R, 6] -> [R, 3, 3]."""
    return torch.stack(
        [s[:, 0], s[:, 3], s[:, 4], s[:, 3], s[:, 1], s[:, 5], s[:, 4], s[:, 5], s[:, 2]],
        dim=-1,
    ).reshape(-1, 3, 3)


def _skew(a):
    """[..., 3] -> [..., 3, 3] with ``skew(a) @ b == cross(a, b)`` rounded
    as the kernel's ``a.y * b.z - a.z * b.y`` (up to the sign of a zero)."""
    z = torch.zeros_like(a[..., 0])
    x, y, w = a[..., 0], a[..., 1], a[..., 2]
    return torch.stack([z, -w, y, w, z, -x, -y, x, z], dim=-1).reshape(
        a.shape[:-1] + (3, 3)
    )


def _dot(a, b):
    t = a * b
    return t[..., 0] + t[..., 1] + t[..., 2]


def _row_update(mode, d, irows, sa, sb, rlx, p: SolveParams):
    """Deltas (d_va, d_wa, d_vb, d_wb) and new impulse rows for R rows.

    Every operation is the kernel's, in the kernel's order, so that the two
    agree to the bit: a resting contact sits at separation ~0, where the
    speculative and the soft branch give different impulses."""
    n = d[:, N_:N_ + 3]
    ima, imb = d[:, IMA:IMA + 3], d[:, IMB:IMB + 3]
    mia, mib = _sym_mat(d[:, IIA:IIA + 6]), _sym_mat(d[:, IIB:IIB + 6])
    r1 = d[:, AA:AA + 12].reshape(-1, 4, 3)
    r2 = d[:, AB:AB + 12].reshape(-1, 4, 3)
    k1s, k2s = _skew(r1), _skew(r2)
    pm = d[:, PM:PM + 4]
    va, wa, vb, wb = sa[:, 0:3], sa[:, 3:6], sb[:, 0:3], sb[:, 3:6]
    d_va = torch.zeros_like(va)
    d_wa = torch.zeros_like(wa)
    d_vb = torch.zeros_like(vb)
    d_wb = torch.zeros_like(wb)
    new = irows.clone()

    def apply(pvec, i):
        nonlocal d_va, d_wa, d_vb, d_wb
        d_va = d_va - pvec * ima
        d_wa = d_wa - _mv(mia, _mv(k1s[:, i], pvec))
        d_vb = d_vb + pvec * imb
        d_wb = d_wb + _mv(mib, _mv(k2s[:, i], pvec))

    def rel_vel(i):
        # cross(u, r) = -(skew(r) @ u)
        return (vb + d_vb - _mv(k2s[:, i], wb + d_wb)) - (
            va + d_va - _mv(k1s[:, i], wa + d_wa)
        )

    if mode == WARM:
        t1, t2 = d[:, T1:T1 + 3], d[:, T2:T2 + 3]
        p_sum, ca, cb = None, None, None
        for i in range(4):
            np_ = irows[:, i:i + 1] * pm[:, i:i + 1]
            tp0 = irows[:, 4 + 2 * i:5 + 2 * i] * pm[:, i:i + 1]
            tp1 = irows[:, 5 + 2 * i:6 + 2 * i] * pm[:, i:i + 1]
            pv = (n * np_ + t1 * tp0 + t2 * tp1) * p.warm_coefficient
            c1 = _mv(k1s[:, i], pv)
            c2 = _mv(k2s[:, i], pv)
            p_sum = pv if p_sum is None else p_sum + pv
            ca = c1 if ca is None else ca + c1
            cb = c2 if cb is None else cb + c2
        return -p_sum * ima, -_mv(mia, ca), p_sum * imb, _mv(mib, cb), new

    if mode == RESTITUTION:
        vmask = (d[:, RESTITUTION_COL] > 0.0).float()
        for i in range(4):
            ns = d[:, NS + i]
            active = (ns < -p.restitution_threshold) & (irows[:, 12 + i] > 0.0)
            pmi = pm[:, i] * vmask * active.float()
            vn = _dot(rel_vel(i), n)
            delta = -d[:, NM + i] * (vn + d[:, RESTITUTION_COL] * ns)
            acc = irows[:, i]
            new_acc = torch.clamp(acc + rlx * delta, min=0.0)
            applied = (new_acc - acc) * pmi
            new[:, i] = torch.where(pmi > 0, new_acc, acc)
            new[:, 12 + i] = irows[:, 12 + i] + applied
            apply(applied[:, None] * n, i)
        return d_va, d_wa, d_vb, d_wb, new

    use_bias = mode == BIAS
    h = p.h
    # Separation depends only on the delta poses, which a pass never
    # changes: all 4 points at once.
    dq_a = sa[:, None, 9:13]
    dq_b = sb[:, None, 9:13]
    delta_sep = (sb[:, None, 6:9] - sa[:, None, 6:9]) + (
        quat_m.rotate(dq_b, r2) - quat_m.rotate(dq_a, r1)
    )
    separation = _dot(delta_sep, n[:, None, :]) + d[:, SEP:SEP + 4]
    soft_bias, soft_mass, soft_imp = d[:, SOFT], d[:, SOFT + 1], d[:, SOFT + 2]
    for i in range(4):
        sep_i = separation[:, i]
        vn = _dot(rel_vel(i), n)
        m_eff = d[:, NM + i]
        acc = irows[:, i]
        spec = -m_eff * (vn + sep_i / h)
        if use_bias:
            sbias = torch.clamp(soft_bias * sep_i, min=-p.max_overlap_speed)
            inner = -m_eff * soft_mass * (vn + sbias) - soft_imp * acc
        else:
            inner = -m_eff * vn
        delta = torch.where(sep_i > 0.0, spec, inner)
        new_acc = torch.clamp(acc + rlx * delta, min=0.0)
        applied = (new_acc - acc) * pm[:, i]
        on = pm[:, i] > 0
        new[:, i] = torch.where(on, new_acc, acc)
        new[:, 12 + i] = irows[:, 12 + i] + torch.where(on, new_acc, 0.0)
        apply(applied[:, None] * n, i)

    t1, t2 = d[:, T1:T1 + 3], d[:, T2:T2 + 3]
    sv = d[:, SV:SV + 3]
    for i in range(4):
        rv = rel_vel(i) + sv
        vt1 = _dot(rv, t1)
        vt2 = _dot(rv, t2)
        k1, k2, k12 = d[:, TK + 3 * i], d[:, TK + 3 * i + 1], d[:, TK + 3 * i + 2]
        t11, t22, t12 = vt1 * vt1, vt2 * vt2, vt1 * vt2
        inv = t11 * k1 + t22 * k2 + t12 * k12
        recip = torch.where(inv != 0.0, 1.0 / torch.where(inv == 0.0, 1.0, inv), 0.0)
        m_eff = (t11 + t22) * recip
        m_eff = torch.where(torch.isfinite(m_eff), m_eff, 0.0)
        acc = irows[:, 4 + 2 * i:6 + 2 * i]
        mu = torch.where(t11 + t22 <= p.stiction_t2, d[:, SF], d[:, FRICTION])
        limit = mu * new[:, i]
        x = acc - rlx[:, None] * (m_eff[:, None] * torch.stack([vt1, vt2], -1))
        n2 = x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1]
        scale = torch.where(
            n2 > limit * limit, limit / torch.sqrt(torch.clamp(n2, min=1e-12)), 1.0
        )
        new_acc = x * scale[:, None]
        on = pm[:, i] > 0
        applied = (new_acc - acc) * pm[:, i, None]
        new[:, 4 + 2 * i:6 + 2 * i] = torch.where(on[:, None], new_acc, acc)
        apply(applied[:, 0:1] * t1 + applied[:, 1:2] * t2, i)
    return d_va, d_wa, d_vb, d_wb, new


def solve_color_twin(mode, color, state, data, imp, bucket_a, bucket_b,
                     bucket_valid, relax, params: SolveParams):
    """Plain PyTorch version of one launch: updates ``state`` and ``imp``
    in place. Every valid row reads body state before any row writes, and
    the deltas are then added in ``[a-sides..., b-sides...]`` order."""
    rows = torch.nonzero(bucket_valid[color], as_tuple=True)[0]
    if rows.numel() == 0:
        return
    a = bucket_a[color, rows].long()
    b = bucket_b[color, rows].long()
    d_va, d_wa, d_vb, d_wb, new = _row_update(
        mode, data[color, rows], imp[color, rows], state[a], state[b],
        relax[color, rows], params,
    )
    if mode != WARM:
        imp[color, rows] = new
    idx = torch.cat([a, b])
    delta = torch.cat(
        [torch.cat([d_va, d_wa], -1), torch.cat([d_vb, d_wb], -1)], dim=0
    )
    state[:, 0:6].index_add_(0, idx, delta)


def overflow_order(data_last, bucket_a_last, bucket_b_last, valid_last, n_bodies):
    """Per-step ordering of the overflow color's endpoint writes.

    Entry ``e`` is ``side * cap + row`` (side 0 = body a). Returns
    ``(order i32[2cap], key i32[2cap])``: the entries stably sorted by the
    body they write, and that body (``n_bodies`` for none: an invalid row or
    an endpoint with zero inverse mass and inertia)."""
    writes_a = (data_last[:, IMA:IMA + 3] != 0).any(-1) | (data_last[:, IIA:IIA + 6] != 0).any(-1)
    writes_b = (data_last[:, IMB:IMB + 3] != 0).any(-1) | (data_last[:, IIB:IIB + 6] != 0).any(-1)
    key = torch.cat(
        [
            torch.where(valid_last & writes_a, bucket_a_last.long(), n_bodies),
            torch.where(valid_last & writes_b, bucket_b_last.long(), n_bodies),
        ]
    )
    skey, order = torch.sort(key, stable=True)
    return order.to(torch.int32).contiguous(), skey.to(torch.int32).contiguous()


def solve_color(mode, color, state, data, imp, bucket_a, bucket_b,
                bucket_valid, relax, ovf_order, ovf_key, params: SolveParams):
    """Solve color ``color`` in ``mode`` (``WARM``, ``BIAS``, ``RELAX`` or
    ``RESTITUTION``), updating ``state`` f32[N, 13] and ``imp``
    f32[colors, cap, 16] in place. ``ovf_order``/``ovf_key`` come from
    ``overflow_order`` and are read for the last color only."""
    if state.device.type == "cpu":
        solve_color_twin(mode, color, state, data, imp, bucket_a, bucket_b,
                         bucket_valid, relax, params)
        return
    if state.device.type != "cuda":
        raise RuntimeError(f"solve_color: unsupported device {state.device}")
    n_bodies = state.shape[0]
    colors, cap = bucket_a.shape
    if mode not in (WARM, BIAS, RELAX, RESTITUTION):
        raise ValueError(f"unknown solve_color mode {mode}")
    if not 0 <= color < colors:
        raise ValueError(f"solve_color: color {color} outside 0..{colors - 1}")
    expect = (
        ("state", state, (n_bodies, 13), torch.float32),
        ("data", data, (colors, cap, D), torch.float32),
        ("imp", imp, (colors, cap, IMP), torch.float32),
        ("bucket_a", bucket_a, (colors, cap), torch.int32),
        ("bucket_b", bucket_b, (colors, cap), torch.int32),
        ("bucket_valid", bucket_valid, (colors, cap), torch.bool),
        ("relax", relax, (colors, cap), torch.float32),
        ("ovf_order", ovf_order, (2 * cap,), torch.int32),
        ("ovf_key", ovf_key, (2 * cap,), torch.int32),
    )
    for name, x, shape, dtype in expect:
        if x.device != state.device or x.dtype != dtype:
            raise TypeError(f"solve_color: {name} must be {dtype} on {state.device}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(
                f"solve_color: {name} must be contiguous {shape}, got {tuple(x.shape)}"
            )
    from avian_tpu_torch.kernels import build

    last = color == colors - 1
    scratch = torch.empty(
        (2 * cap if last else 1, 6), dtype=torch.float32, device=state.device
    )
    lib = build.library()
    with torch.cuda.device(state.device):
        err = lib.avian_solve_color(
            ctypes.c_int(mode), ctypes.c_int(color), ctypes.c_int(colors),
            ctypes.c_int(cap), ctypes.c_int(n_bodies),
            state.data_ptr(), data.data_ptr(), imp.data_ptr(),
            bucket_a.data_ptr(), bucket_b.data_ptr(), bucket_valid.data_ptr(),
            relax.data_ptr(), ovf_order.data_ptr(), ovf_key.data_ptr(),
            scratch.data_ptr(),
            ctypes.c_float(params.h), ctypes.c_float(params.max_overlap_speed),
            ctypes.c_float(params.stiction_t2),
            ctypes.c_float(params.warm_coefficient),
            ctypes.c_float(params.restitution_threshold),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, "solve_color")
    solve_color.launches += 1


solve_color.launches = 0
