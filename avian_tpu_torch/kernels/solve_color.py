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
    """``m @ v`` for m [..., 3, 3], v [..., 3], each row summed left to right
    as the kernel does: ``(m0 * x + m1 * y) + m2 * z``."""
    x, y, z = (m * v[..., None, :]).unbind(-1)
    return x + y + z


def _sym_mat(s):
    """sym6 [..., 6] -> [..., 3, 3]."""
    xx, yy, zz, xy, xz, yz = s.unbind(-1)
    return torch.stack([xx, xy, xz, xy, yy, yz, xz, yz, zz], dim=-1).reshape(
        s.shape[:-1] + (3, 3))


def _skew(a):
    """[..., 3] -> [..., 3, 3] with ``skew(a) @ b == cross(a, b)`` rounded
    as the kernel's ``a.y * b.z - a.z * b.y`` (up to the sign of a zero)."""
    x, y, w = a.unbind(-1)
    z = torch.zeros_like(x)
    return torch.stack([z, -w, y, w, z, -x, -y, x, z], dim=-1).reshape(
        a.shape[:-1] + (3, 3)
    )


def _dot(a, b):
    x, y, z = (a * b).unbind(-1)
    return x + y + z


def _row_update(mode, d, irows, sa, sb, rlx, p: SolveParams):
    """Deltas ``[2, R, 6]`` (side a, side b: linear then angular) and new
    impulse rows for R rows.

    Every operation is the kernel's, in the kernel's order, so that the two
    agree to the bit (up to the sign of a zero): a resting contact sits at
    separation ~0, where the speculative and the soft branch give different
    impulses. The two sides are one tensor ``[2, R, ...]``, side a's inverse
    mass and inertia negated, so that ``d - p * m`` is ``d + p * (-m)``: the
    same rounding in half the operations."""
    n = d[:, N_:N_ + 3]
    im = torch.stack([-d[:, IMA:IMA + 3], d[:, IMB:IMB + 3]])
    mi = torch.stack([-_sym_mat(d[:, IIA:IIA + 6]), _sym_mat(d[:, IIB:IIB + 6])])
    r = torch.stack([d[:, AA:AA + 12], d[:, AB:AB + 12]]).reshape(2, -1, 4, 3)
    ks = _skew(r)                                            # [2, R, 4, 3, 3]
    pm = d[:, PM:PM + 4]
    s = torch.stack([sa, sb])
    v, w = s[..., 0:3], s[..., 3:6]
    dv = torch.zeros_like(v)
    dw = torch.zeros_like(w)
    new = irows.clone()

    def apply(pvec, i):
        nonlocal dv, dw
        dv = dv + pvec * im
        dw = dw + _mv(mi, _mv(ks[:, :, i], pvec))

    def rel_vel(i):
        # cross(u, r) = -(skew(r) @ u)
        u = (v + dv) - _mv(ks[:, :, i], w + dw)
        return u[1] - u[0]

    def deltas():
        return torch.cat([dv, dw], -1)

    if mode == WARM:
        t1, t2 = d[:, T1:T1 + 3], d[:, T2:T2 + 3]
        p_sum, c = None, None
        for i in range(4):
            np_ = irows[:, i:i + 1] * pm[:, i:i + 1]
            tp0 = irows[:, 4 + 2 * i:5 + 2 * i] * pm[:, i:i + 1]
            tp1 = irows[:, 5 + 2 * i:6 + 2 * i] * pm[:, i:i + 1]
            pv = (n * np_ + t1 * tp0 + t2 * tp1) * p.warm_coefficient
            ci = _mv(ks[:, :, i], pv)
            p_sum = pv if p_sum is None else p_sum + pv
            c = ci if c is None else c + ci
        # Side a's angular delta is -(mia @ c), the sum negated, so that an
        # exact zero keeps the kernel's sign.
        sides = torch.tensor((-1.0, 1.0), dtype=d.dtype, device=d.device)
        ang = _mv(mi * sides[:, None, None, None], c) * sides[:, None, None]
        return torch.cat([p_sum * im, ang], -1), new

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
        return deltas(), new

    use_bias = mode == BIAS
    # Separation depends only on the delta poses, which a pass never
    # changes: all 4 points at once, and with it every per-point term that
    # does not depend on the velocities the points change.
    turned = quat_m.rotate(s[:, :, None, 9:13], r)
    delta_sep = (sb[:, None, 6:9] - sa[:, None, 6:9]) + (turned[1] - turned[0])
    separation = _dot(delta_sep, n[:, None, :]) + d[:, SEP:SEP + 4]
    neg_m = -d[:, NM:NM + 4]
    spec_sep = separation / p.h
    acc_n = irows[:, 0:4]
    if use_bias:
        soft_bias, soft_mass, soft_imp = d[:, SOFT, None], d[:, SOFT + 1, None], d[:, SOFT + 2, None]
        bias = torch.clamp(soft_bias * separation, min=-p.max_overlap_speed)
        soft_m = neg_m * soft_mass
        soft_acc = soft_imp * acc_n
    speculative = separation > 0.0
    new_n = []
    for i in range(4):
        vn = _dot(rel_vel(i), n)
        acc = acc_n[:, i]
        spec = neg_m[:, i] * (vn + spec_sep[:, i])
        if use_bias:
            inner = soft_m[:, i] * (vn + bias[:, i]) - soft_acc[:, i]
        else:
            inner = neg_m[:, i] * vn
        delta = torch.where(speculative[:, i], spec, inner)
        new_acc = torch.clamp(acc + rlx * delta, min=0.0)
        new_n.append(new_acc)
        apply(((new_acc - acc) * pm[:, i])[:, None] * n, i)
    on = pm > 0
    new_n = torch.stack(new_n, -1)
    normal = torch.where(on, new_n, acc_n)
    new[:, 0:4] = normal
    new[:, 12:16] = irows[:, 12:16] + torch.where(on, new_n, 0.0)

    tt = torch.stack([d[:, T1:T1 + 3], d[:, T2:T2 + 3]], 1)  # [R, 2, 3]: t1, t2
    sv = d[:, SV:SV + 3]
    mu_slow, mu_fast = d[:, SF], d[:, FRICTION]
    for i in range(4):
        vt = _mv(tt, rel_vel(i) + sv)                         # [R, 2]: vt1, vt2
        vt1, vt2 = vt.unbind(-1)
        k1, k2, k12 = d[:, TK + 3 * i:TK + 3 * i + 3].unbind(-1)
        t11, t22 = (vt * vt).unbind(-1)
        inv = t11 * k1 + t22 * k2 + (vt1 * vt2) * k12
        recip = torch.where(inv != 0.0, 1.0 / torch.where(inv == 0.0, 1.0, inv), 0.0)
        speed2 = t11 + t22
        m_eff = speed2 * recip
        m_eff = torch.where(torch.isfinite(m_eff), m_eff, 0.0)
        acc = irows[:, 4 + 2 * i:6 + 2 * i]
        limit = torch.where(speed2 <= p.stiction_t2, mu_slow, mu_fast) * normal[:, i]
        x = acc - rlx[:, None] * (m_eff[:, None] * vt)
        x0, x1 = x.unbind(-1)
        n2 = x0 * x0 + x1 * x1
        scale = torch.where(
            n2 > limit * limit, limit / torch.sqrt(torch.clamp(n2, min=1e-12)), 1.0
        )
        new_acc = x * scale[:, None]
        on = pm[:, i, None] > 0
        applied = (new_acc - acc) * pm[:, i, None]
        new[:, 4 + 2 * i:6 + 2 * i] = torch.where(on, new_acc, acc)
        a0, a1 = applied[:, None, :].unbind(-1)
        apply(a0 * tt[:, 0] + a1 * tt[:, 1], i)
    return deltas(), new


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
    delta, new = _row_update(
        mode, data[color, rows], imp[color, rows], state[a], state[b],
        relax[color, rows], params,
    )
    if mode != WARM:
        imp[color, rows] = new
    state[:, 0:6].index_add_(0, torch.cat([a, b]), delta.reshape(-1, 6))


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
