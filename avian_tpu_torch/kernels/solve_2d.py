"""Kernel Y, ``solve_2d``: one colour of the 2D engine's contact solver.

Replaces ``avian_tpu/dim2/solver.py::warm_start`` (:275, mode ``WARM``),
``solve_pass`` with ``_solve_bucket`` (:314, :344; modes ``BIAS`` and
``RELAX``) and ``solve_restitution`` with ``_restitution_bucket`` (:464, :483;
mode ``RESTITUTION``). Rows are the 33-float layout of
``prepare_constraints`` (Kernel X), impulses 6 floats a row (2 normal, 2
tangent, 2 total normal), body state ``[N, 6]`` = linear velocity (2),
angular velocity, delta position (2), delta angle. The caller launches it
once per colour per pass in colour order, so a substep is
``3 * max_colors`` launches and a restitution pass ``max_colors`` more.

Kernel D's rules (``kernels/solve_color.py``) keep it right and bitwise
reproducible without float atomics: one thread a bucket row; a padded row
writes nothing; an end with zero inverse mass and inertia is not written;
colours before the last share no dynamic body, so a thread adds its deltas
to its bodies directly; the last (overflow) colour writes each row's deltas
to scratch, and a second launch of the same entry point gives one thread to
each body, which adds them in ``[a-sides..., b-sides...]`` order
(``overflow_order``).

The reference's warm start is one scatter-add over every row of every
colour. Here it runs colour by colour through the same rules, so each
body's deltas are summed in this fixed order: colour 0, 1, ..., last, and
within the last colour its a-sides in row order, then its b-sides. The
warm-start deltas depend on the stored impulses alone, not on the state, so
the result differs from the reference's only in the order of the sum.

The bias and relax passes take the cosine and sine of each body's delta
angle in the kernel (``cosf``, ``sinf``); the plain version takes
``torch.cos``/``torch.sin``. On the H100 a launch is small (one colour's
rows, 33 + 6 floats each, and two 6-float body rows), so the solver is bound
by launch latency and by the dependent gathers of body state.

The plain PyTorch version, ``solve_2d_twin``, runs on CPU tensors; on a CUDA
tensor the wrapper launches the kernel or raises.
"""

from typing import NamedTuple

import torch

WARM, BIAS, RELAX, RESTITUTION = 0, 1, 2, 3

# Packed row layout data[colors, cap, 33] (reference solver.py:25-42).
N_ = 0            # 0:2 normal
FRICTION = 2
SF = 3            # static friction
RESTITUTION_COL = 4
SOFT = 5          # 5:8 (bias, mass_scale, impulse_scale)
IMA = 8           # 8:10 per-axis inv mass a
IMB = 10
IIA = 12          # scalar inv inertia a
IIB = 13
AA = 14           # 14:18 anchors a (2 x 2)
AB = 18           # 18:22 anchors b
SEP = 22          # 22:24 initial separation per point
NM = 24           # 24:26 normal effective mass per point
TM = 26           # 26:28 tangent effective mass per point
NS = 28           # 28:30 initial normal speed per point
PM = 30           # 30:32 point mask
SV = 32           # surface tangent speed
D = 33
IMP = 6           # imp[.., 6]: 0:2 normal, 2:4 tangent, 4:6 total normal
STATE = 6         # state[N, 6]: lin_vel(2), ang_vel, delta_pos(2), delta_angle


class SolveParams2D(NamedTuple):
    h: float                   # substep dt
    max_overlap_speed: float
    stiction_t2: float         # squared stiction speed threshold
    warm_coefficient: float
    restitution_threshold: float


def _cross(ax, ay, bx, by):
    return ax * by - ay * bx


def _row_update(mode, d, irows, sa, sb, rlx, p: SolveParams2D):
    """Deltas ``[2, R, 3]`` (side a, side b: linear x, y, angular) and new
    impulse rows [R, 6] of R rows, every operation in the reference's order.
    The two sides are one tensor ``[2, R]``, side a's inverse mass and
    inertia negated, so that ``d - p * m`` is ``d + p * (-m)``: the same
    rounding in half the operations."""
    nx, ny = d[:, N_], d[:, N_ + 1]
    tx, ty = ny, -nx  # the single 2D tangent, perp(n)
    imx = torch.stack([-d[:, IMA], d[:, IMB]])
    imy = torch.stack([-d[:, IMA + 1], d[:, IMB + 1]])
    ii = torch.stack([-d[:, IIA], d[:, IIB]])
    r = [(torch.stack([d[:, AA + 2 * i], d[:, AB + 2 * i]]),
          torch.stack([d[:, AA + 2 * i + 1], d[:, AB + 2 * i + 1]])) for i in range(2)]
    pm = [d[:, PM], d[:, PM + 1]]
    new = irows.clone()

    if mode == WARM:
        px, py, cr = None, None, None
        for i in range(2):
            np_ = irows[:, i] * pm[i]
            tp = irows[:, 2 + i] * pm[i]
            pxi = (np_ * nx + tp * tx) * p.warm_coefficient
            pyi = (np_ * ny + tp * ty) * p.warm_coefficient
            ci = _cross(r[i][0], r[i][1], pxi, pyi)
            if i == 0:
                px, py, cr = pxi, pyi, ci
            else:
                px, py, cr = px + pxi, py + pyi, cr + ci
        return torch.stack([px * imx, py * imy, ii * cr], -1), new

    s = torch.stack([sa, sb])
    vx, vy, w = s[..., 0], s[..., 1], s[..., 2]
    dvx = dvy = dw = torch.zeros_like(vx)

    def rel_vel(i):
        wt = w + dw
        ux = (vx + dvx) + wt * -r[i][1]
        uy = (vy + dvy) + wt * r[i][0]
        return ux[1] - ux[0], uy[1] - uy[0]

    def apply(applied, ux, uy, i):
        nonlocal dvx, dvy, dw
        pvx, pvy = applied * ux, applied * uy
        dvx, dvy = dvx + pvx * imx, dvy + pvy * imy
        dw = dw + ii * _cross(r[i][0], r[i][1], pvx, pvy)

    def deltas():
        return torch.stack([dvx, dvy, dw], -1)

    if mode == RESTITUTION:
        rest = d[:, RESTITUTION_COL]
        vmask = (rest > 0.0).float()
        for i in range(2):
            ns = d[:, NS + i]
            active = ((ns < -p.restitution_threshold) & (irows[:, 4 + i] > 0.0)).float()
            pmi = pm[i] * vmask * active
            rvx, rvy = rel_vel(i)
            vn = rvx * nx + rvy * ny
            delta = -d[:, NM + i] * (vn + rest * ns)
            acc = irows[:, i]
            new_acc = torch.clamp(acc + rlx * delta, min=0.0)
            applied = (new_acc - acc) * pmi
            new[:, i] = torch.where(pmi > 0, new_acc, acc)
            new[:, 4 + i] = irows[:, 4 + i] + applied
            apply(applied, nx, ny, i)
        return deltas(), new

    use_bias = mode == BIAS
    cos, sin = torch.cos(s[..., 5]), torch.sin(s[..., 5])
    dtx, dty = sb[:, 3] - sa[:, 3], sb[:, 4] - sa[:, 4]
    soft_bias, soft_mass, soft_imp = d[:, SOFT], d[:, SOFT + 1], d[:, SOFT + 2]
    for i in range(2):
        rx, ry = r[i]
        turned_x = cos * rx - sin * ry
        turned_y = sin * rx + cos * ry
        dsx = dtx + (turned_x[1] - turned_x[0])
        dsy = dty + (turned_y[1] - turned_y[0])
        sep = (dsx * nx + dsy * ny) + d[:, SEP + i]
        rvx, rvy = rel_vel(i)
        vn = rvx * nx + rvy * ny
        m_eff = d[:, NM + i]
        acc = irows[:, i]
        spec = -m_eff * (vn + sep / p.h)
        if use_bias:
            sbias = torch.clamp(soft_bias * sep, min=-p.max_overlap_speed)
            inner = -m_eff * soft_mass * (vn + sbias) - soft_imp * acc
        else:
            inner = -m_eff * vn
        delta = torch.where(sep > 0.0, spec, inner)
        new_acc = torch.clamp(acc + rlx * delta, min=0.0)
        applied = (new_acc - acc) * pm[i]
        on = pm[i] > 0
        new[:, i] = torch.where(on, new_acc, acc)
        new[:, 4 + i] = irows[:, 4 + i] + torch.where(on, new_acc, 0.0)
        apply(applied, nx, ny, i)

    sv = d[:, SV]
    for i in range(2):
        rvx, rvy = rel_vel(i)
        vt = (rvx * tx + rvy * ty) + sv
        delta = d[:, TM + i] * vt
        acc = irows[:, 2 + i]
        mu = torch.where(vt * vt <= p.stiction_t2, d[:, SF], d[:, FRICTION])
        limit = mu * new[:, i]
        new_acc = torch.minimum(torch.maximum(acc - rlx * delta, -limit), limit)
        applied = (new_acc - acc) * pm[i]
        new[:, 2 + i] = torch.where(pm[i] > 0, new_acc, acc)
        apply(applied, tx, ty, i)
    return deltas(), new


def solve_2d_twin(mode, color, state, data, imp, bucket_a, bucket_b, bucket_valid, relax,
                  params: SolveParams2D):
    """Plain PyTorch version of one launch: updates ``state`` and ``imp`` in
    place. Every valid row reads body state before any row writes; the
    deltas are then added in ``[a-sides..., b-sides...]`` order."""
    rows = torch.nonzero(bucket_valid[color], as_tuple=True)[0]
    if rows.numel() == 0:
        return
    a = bucket_a[color, rows].long()
    b = bucket_b[color, rows].long()
    delta, new = _row_update(
        mode, data[color, rows], imp[color, rows], state[a], state[b], relax[color, rows],
        params,
    )
    if mode != WARM:
        imp[color, rows] = new
    state[:, 0:3].index_add_(0, torch.cat([a, b]), delta.reshape(-1, 3))


def overflow_order(data_last, bucket_a_last, bucket_b_last, valid_last, n_bodies):
    """Per-step order of the overflow colour's endpoint writes: entry ``e`` is
    ``side * cap + row`` (side 0 = body a). Returns ``(order i32[2cap], key
    i32[2cap])``: the entries stably sorted by the body they write, and that
    body (``n_bodies`` for an invalid row or an end with zero inverse mass
    and inertia)."""
    writes_a = (data_last[:, IMA:IMA + 2] != 0).any(-1) | (data_last[:, IIA] != 0)
    writes_b = (data_last[:, IMB:IMB + 2] != 0).any(-1) | (data_last[:, IIB] != 0)
    key = torch.cat([
        torch.where(valid_last & writes_a, bucket_a_last.long(), n_bodies),
        torch.where(valid_last & writes_b, bucket_b_last.long(), n_bodies),
    ])
    skey, order = torch.sort(key, stable=True)
    return order.to(torch.int32).contiguous(), skey.to(torch.int32).contiguous()


def solve_2d(mode, color, state, data, imp, bucket_a, bucket_b, bucket_valid, relax,
             ovf_order, ovf_key, params: SolveParams2D):
    """Solve colour ``color`` in ``mode`` (``WARM``, ``BIAS``, ``RELAX`` or
    ``RESTITUTION``), updating ``state`` f32[N, 6] and ``imp``
    f32[colors, cap, 6] in place. ``ovf_order``/``ovf_key`` come from
    ``overflow_order`` and are read for the last colour only."""
    dev = state.device
    if dev.type == "cpu":
        solve_2d_twin(mode, color, state, data, imp, bucket_a, bucket_b, bucket_valid,
                      relax, params)
        return
    if dev.type != "cuda":
        raise RuntimeError(f"solve_2d: unsupported device {dev}")
    from avian_tpu_torch.kernels import build

    n_bodies = state.shape[0]
    colors, cap = bucket_a.shape
    if mode not in (WARM, BIAS, RELAX, RESTITUTION):
        raise ValueError(f"unknown solve_2d mode {mode}")
    if not 0 <= color < colors:
        raise ValueError(f"solve_2d: colour {color} outside 0..{colors - 1}")
    f32, i32 = torch.float32, torch.int32
    build.require("solve_2d", dev, (
        ("state", state, (n_bodies, STATE), f32), ("data", data, (colors, cap, D), f32),
        ("imp", imp, (colors, cap, IMP), f32), ("bucket_a", bucket_a, (colors, cap), i32),
        ("bucket_b", bucket_b, (colors, cap), i32),
        ("bucket_valid", bucket_valid, (colors, cap), torch.bool),
        ("relax", relax, (colors, cap), f32), ("ovf_order", ovf_order, (2 * cap,), i32),
        ("ovf_key", ovf_key, (2 * cap,), i32),
    ))
    last = color == colors - 1
    scratch = torch.empty((2 * cap if last else 1, 3), dtype=f32, device=dev)
    build.launch("avian_solve_2d", dev, mode, color, colors, cap, n_bodies, state, data, imp,
                 bucket_a, bucket_b, bucket_valid, relax, ovf_order, ovf_key, scratch,
                 float(params.h), float(params.max_overlap_speed), float(params.stiction_t2),
                 float(params.warm_coefficient), float(params.restitution_threshold))
    solve_2d.launches += 1


solve_2d.launches = 0
