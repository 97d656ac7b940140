"""Kernel AA, ``solve_joints_2d``: the 2D engine's XPBD joint solver of one
substep.

Replaces ``avian_tpu/dim2/xpbd.py::prepare_joints`` (:71), ``_solve_color``
(:197) with ``_angular_correction`` (:129) and ``_positional_correction``
(:140), the velocity projection of ``solve_position_constraints``
(:186-190) and ``_joint_damping`` (:313), for the four 2D joint types (fixed,
distance, revolute with its angle limit, prismatic with its axis limit).
``joint_rows_2d`` is one launch a step; the caller then launches
``joint_color_2d`` once per joint colour in colour order and
``joint_velocities_2d`` once: a substep is ``max_colors + 1`` launches.

- ``joint_rows_2d``: one thread per joint gathers its two bodies and writes
  its packed 26-float row (anchors from each centre of mass, centre
  difference, base angle, prismatic axis, compliance, limits, damping,
  effective masses and inertias) and whether it is solved. The cosines and
  sines of the body angles and of the joint axes come in (computed once a
  step), so no trigonometry differs between the kernel and its twin;
- ``joint_color_2d``: one thread per joint of the colour reads its row and
  the delta poses of both ends from the ``f32[N, 6]`` solver state and runs
  the reference's steps in order: the angle alignment (fixed, prismatic),
  the revolute limit where violated, the positional correction;
- ``joint_velocities_2d``: the velocity projection from the change of the
  delta pose since ``pre`` (a copy taken before the first colour, as the
  reference keeps ``pre_dp``/``pre_dth``; a custom joint's solve runs
  between the colours and this launch, so it stays its own launch), one
  thread per body; then joint damping, which reads every joint's two ends
  before any write.

Kernel I's rules keep it right and bitwise reproducible without float
atomics (``kernels/solve_joints.py``): an end with zero inverse mass and
inertia is not written; colours before the last share no dynamic body, so a
thread adds its increments to its ends directly; the overflow colour and the
damping write each joint's increments to scratch, and a second kernel gives
one thread to each body, which adds them in the ``[a-sides..., b-sides...]``
order of ``entry_order_2d`` (the reference's ``.at[body_a].add`` then
``.at[body_b].add``).

The kernel's cosines and sines of the delta angles and the revolute limit's
``atan2`` are libdevice's ``cosf``/``sinf``/``atan2f``; the plain version's
are PyTorch's, which round apart on the CPU. Every other operation is
spelled in the plain version's order (``-fmad=false``). On the H100 a launch
is one colour's joints, each a 26-float row and two 6-float body rows, with
some 150 flops in registers: bound by launch latency and the dependent
gathers, as Kernels I and Y are.

The plain PyTorch versions, ``joint_rows_2d_twin``, ``joint_color_2d_twin``
and ``joint_velocities_2d_twin``, run on CPU tensors; on a CUDA tensor the
wrappers launch the kernels or raise.
"""

import torch

from avian_tpu_torch.core.types import JointType

# Packed joint row layout data[J, JD] (the reference's JointConstraints2D).
R1, R2, CD = 0, 2, 4   # anchors from each COM at prepare; centre difference
BASE = 6               # angle_b - angle_a - reference angle at prepare
AXIS = 7               # 7:9 prismatic axis (world, on a)
COMP = 9               # 9:13 compliance (point, align, limit, unused)
LMIN, LMAX, LEN = 13, 14, 15
LDAMP, ADAMP = 16, 17
IMA, IMB = 18, 19      # the larger component of each end's inverse mass
IMVA, IMVB = 20, 22    # per-axis inverse mass
IIA, IIB = 24, 25      # inverse inertia
JD = 26
LAM = 3                # Lagrange totals lam[J, 3]: 0:2 positional, 2 rotational
STATE = 6              # state[N, 6]: lin_vel (2), ang_vel, delta_pos (2), delta_angle


def _rot(c, s, v):
    return torch.stack([c * v[..., 0] - s * v[..., 1], s * v[..., 0] + c * v[..., 1]], -1)


def _col(x):
    return x.float()[:, None]


def joint_rows_2d_twin(joints, bodies, body_cs, axis_cs, inv_mass, inv_inertia, solve_mask):
    """Plain PyTorch version; see ``joint_rows_2d``."""
    j, b = joints, bodies
    ba, bb = j.body_a.long(), j.body_b.long()
    dyn_a = solve_mask[ba] > 0
    dyn_b = solve_mask[bb] > 0
    mask = j.active & (dyn_a | dyn_b)
    ca, sa = body_cs[ba, 0], body_cs[ba, 1]
    cb, sb = body_cs[bb, 0], body_cs[bb, 1]
    com_a, com_b = b.com[ba], b.com[bb]
    ima, imb = inv_mass[ba], inv_mass[bb]
    data = torch.cat([
        _rot(ca, sa, j.anchor_a - com_a), _rot(cb, sb, j.anchor_b - com_b),
        (b.pos[bb] - b.pos[ba]) + (_rot(cb, sb, com_b) - _rot(ca, sa, com_a)),
        _col((b.angle[bb] - b.angle[ba]) - j.reference_angle), _rot(ca, sa, axis_cs),
        j.compliance, _col(j.limit_min), _col(j.limit_max), _col(j.limit_enabled),
        _col(j.lin_damping), _col(j.ang_damping), _col(ima.amax(-1)), _col(imb.amax(-1)),
        ima, imb, _col(inv_inertia[ba]), _col(inv_inertia[bb]),
    ], dim=-1).contiguous()
    return data, mask, dyn_a, dyn_b


def joint_rows_2d(joints, bodies, body_cs, axis_cs, inv_mass, inv_inertia, solve_mask):
    """``(data f32[J, JD], mask bool[J], dyn_a bool[J], dyn_b bool[J])``:
    each joint's packed row from the bodies' poses (``body_cs`` f32[N, 2]:
    the cosine and sine of each body's angle; ``axis_cs`` f32[J, 2]: of each
    joint's axis angle) and the solver's effective inverse masses f32[N, 2]
    and inertias f32[N], whether it is solved (active, a responding end) and
    which ends respond (``solve_mask`` f32[N] > 0)."""
    dev = inv_mass.device
    if dev.type == "cpu":
        return joint_rows_2d_twin(joints, bodies, body_cs, axis_cs, inv_mass, inv_inertia,
                                  solve_mask)
    if dev.type != "cuda":
        raise RuntimeError(f"joint_rows_2d: unsupported device {dev}")
    from avian_tpu_torch.kernels import build

    j, b = joints, bodies
    n, jn = b.capacity, j.capacity
    f32, i32, u8 = torch.float32, torch.int32, torch.bool
    build.require("joint_rows_2d", dev, [(name, getattr(j, name), (jn,), dt) for name, dt in (
        ("body_a", i32), ("body_b", i32), ("active", u8), ("reference_angle", f32),
        ("limit_min", f32), ("limit_max", f32), ("limit_enabled", u8), ("lin_damping", f32),
        ("ang_damping", f32))] + [
        ("anchor_a", j.anchor_a, (jn, 2), f32), ("anchor_b", j.anchor_b, (jn, 2), f32),
        ("axis_cs", axis_cs, (jn, 2), f32), ("compliance", j.compliance, (jn, 4), f32),
        ("pos", b.pos, (n, 2), f32), ("angle", b.angle, (n,), f32), ("com", b.com, (n, 2), f32),
        ("body_cs", body_cs, (n, 2), f32), ("inv_mass", inv_mass, (n, 2), f32),
        ("inv_inertia", inv_inertia, (n,), f32), ("solve_mask", solve_mask, (n,), f32),
    ])
    data = torch.empty((jn, JD), dtype=f32, device=dev)
    mask = torch.empty((jn,), dtype=u8, device=dev)
    dyn_a = torch.empty((jn,), dtype=u8, device=dev)
    dyn_b = torch.empty((jn,), dtype=u8, device=dev)
    if jn == 0:
        return data, mask, dyn_a, dyn_b
    build.launch("avian_joint_rows_2d", dev, jn, j.body_a, j.body_b, j.active, j.anchor_a,
                 j.anchor_b, axis_cs, j.reference_angle, j.compliance, j.limit_min, j.limit_max,
                 j.limit_enabled, j.lin_damping, j.ang_damping, b.pos, b.angle, b.com, body_cs,
                 inv_mass, inv_inertia, solve_mask, data, mask, dyn_a, dyn_b)
    joint_rows_2d.launches += 1
    return data, mask, dyn_a, dyn_b


joint_rows_2d.launches = 0


def _cross(a, b):
    return a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]


def joint_increments_2d(d, jtype, dp_a, dp_b, th_a0, th_b0, lam, hh):
    """One colour's work for R joint rows: ``(dpos_a, dpos_b, dangle_a,
    dangle_b, new lam)`` from the rows ``d`` f32[R, JD], types, the ends'
    delta positions and angles, the Lagrange totals f32[R, 3] and ``hh = h *
    h``. Every joint in ``d`` is solved (reference ``_solve_color`` for the
    rows of one colour)."""
    is_distance = jtype == JointType.DISTANCE
    is_revolute = jtype == JointType.REVOLUTE
    is_prismatic = jtype == JointType.PRISMATIC
    zero = torch.zeros_like(th_a0)
    acc_dp_a = acc_dp_b = torch.zeros_like(dp_a)
    acc_th_a = acc_th_b = zero
    tot_pos, tot_rot = lam[:, 0:2], lam[:, 2]
    lmin, lmax, len_ = d[:, LMIN], d[:, LMAX], d[:, LEN] > 0.0
    iia, iib = d[:, IIA], d[:, IIB]

    def angular(c_err, compliance, on):
        w_sum = iia + iib
        tilde = compliance / hh
        dl = torch.where(on & (w_sum > 1e-12), -c_err / torch.clamp(w_sum + tilde, min=1e-12),
                         0.0)
        return -iia * dl, iib * dl, dl

    def add(on, da, db, dl):
        nonlocal acc_th_a, acc_th_b, tot_rot
        acc_th_a = acc_th_a + torch.where(on, da, 0.0)
        acc_th_b = acc_th_b + torch.where(on, db, 0.0)
        tot_rot = tot_rot + torch.where(on, dl, 0.0)

    # 1. Angle alignment (fixed, prismatic), then the revolute limit where
    #    violated.
    align = (jtype == JointType.FIXED) | is_prismatic
    cur = (d[:, BASE] + (th_b0 + acc_th_b)) - (th_a0 + acc_th_a)
    add(align, *angular(cur, d[:, COMP + 1], align))
    cur = (d[:, BASE] + (th_b0 + acc_th_b)) - (th_a0 + acc_th_a)
    wrapped = torch.atan2(torch.sin(cur), torch.cos(cur))
    lim = is_revolute & len_ & ((wrapped < lmin) | (wrapped > lmax))
    err = torch.where(lim, wrapped - torch.minimum(torch.maximum(wrapped, lmin), lmax), 0.0)
    add(lim, *angular(err, d[:, COMP + 2], lim))

    # 2. Positional constraint.
    ang_a, ang_b = th_a0 + acc_th_a, th_b0 + acc_th_b
    ca, sa, cb, sb = torch.cos(ang_a), torch.sin(ang_a), torch.cos(ang_b), torch.sin(ang_b)
    r1 = _rot(ca, sa, d[:, R1:R1 + 2])
    r2 = _rot(cb, sb, d[:, R2:R2 + 2])
    sep = (((dp_b + acc_dp_b) - (dp_a + acc_dp_a)) + (r2 - r1)) + d[:, CD:CD + 2]
    dist = torch.sqrt(sep[:, 0] * sep[:, 0] + sep[:, 1] * sep[:, 1])
    dir_ = sep / torch.clamp(dist, min=1e-9)[:, None]
    dist_corr = torch.where(
        (dist < lmin)[:, None], -dir_ * (lmin - dist)[:, None],
        torch.where((dist > lmax)[:, None], dir_ * (dist - lmax)[:, None], 0.0))
    axis = _rot(ca, sa, d[:, AXIS:AXIS + 2])
    along = sep[:, 0] * axis[:, 0] + sep[:, 1] * axis[:, 1]
    perp = sep - axis * along[:, None]
    along_corr = torch.where(len_ & (along < lmin), along - lmin,
                             torch.where(len_ & (along > lmax), along - lmax, 0.0))
    pris = perp + axis * along_corr[:, None]
    corr = torch.where(is_distance[:, None], dist_corr,
                       torch.where(is_prismatic[:, None], pris, sep))

    c = torch.sqrt(corr[:, 0] * corr[:, 0] + corr[:, 1] * corr[:, 1])
    n = -corr / torch.clamp(c, min=1e-9)[:, None]
    r1xn, r2xn = _cross(r1, n), _cross(r2, n)
    w1 = d[:, IMA] + iia * r1xn * r1xn
    w2 = d[:, IMB] + iib * r2xn * r2xn
    w_sum = w1 + w2
    tilde = d[:, COMP] / hh
    dl = torch.where((c > 1e-9) & (w_sum > 1e-12), -c / torch.clamp(w_sum + tilde, min=1e-12),
                     0.0)
    imp = dl[:, None] * n
    acc_dp_a = acc_dp_a + imp * d[:, IMVA:IMVA + 2]
    acc_dp_b = acc_dp_b + -imp * d[:, IMVB:IMVB + 2]
    acc_th_a = acc_th_a + iia * _cross(r1, imp)
    acc_th_b = acc_th_b + -iib * _cross(r2, imp)
    tot_pos = tot_pos + imp
    return acc_dp_a, acc_dp_b, acc_th_a, acc_th_b, torch.cat([tot_pos, tot_rot[:, None]], -1)


def ordered_add(target, idx, inc):
    """``target[idx[k]] += inc[k]`` for k in order, one add at a time per
    row, as ``index_add_`` adds on the CPU: the k-th entries of all rows in
    one indexed add each, so that the sums are bitwise the same on any
    device."""
    if idx.numel() == 0:
        return
    sidx, order = torch.sort(idx, stable=True)
    lanes = torch.arange(sidx.numel(), device=idx.device)
    first = torch.ones_like(sidx, dtype=torch.bool)
    first[1:] = sidx[1:] != sidx[:-1]
    rank = lanes - torch.cummax(torch.where(first, lanes, 0), 0).values
    for r in range(int(rank.max()) + 1):
        at = rank == r
        target[sidx[at]] += inc[order[at]]


def joint_color_2d_twin(color, state, data, lam, jtype, body_a, body_b, jcolor, mask, hh):
    """Plain PyTorch version of one launch: updates ``state`` and ``lam`` in
    place. Every joint of the colour reads the delta poses before any write;
    the increments are then added in ``[a-sides..., b-sides...]`` order
    (``ordered_add``)."""
    rows = torch.nonzero((jcolor == color) & (mask > 0.0), as_tuple=True)[0]
    if rows.numel() == 0:
        return
    a, b = body_a[rows].long(), body_b[rows].long()
    dp_a, dp_b, th_a, th_b, new_lam = joint_increments_2d(
        data[rows], jtype[rows], state[a, 3:5], state[b, 3:5], state[a, 5], state[b, 5],
        lam[rows], hh)
    lam[rows] = new_lam
    inc = torch.cat([torch.cat([dp_a, th_a[:, None]], -1), torch.cat([dp_b, th_b[:, None]], -1)])
    pose = state[:, 3:6].clone()
    ordered_add(pose, torch.cat([a, b]), inc)
    state[:, 3:6] = pose


def joint_velocities_2d_twin(state, pre, data, body_a, body_b, mask, h):
    """Plain PyTorch version of ``joint_velocities_2d``: updates ``state``."""
    state[:, 0:3] = state[:, 0:3] + (state[:, 3:6] - pre) / h
    rows = torch.nonzero(mask > 0.0, as_tuple=True)[0]
    if rows.numel() == 0:
        return
    d = data[rows]
    a, b = body_a[rows].long(), body_b[rows].long()
    va, vb, wa, wb = state[a, 0:2], state[b, 0:2], state[a, 2], state[b, 2]
    delta_omega = (wb - wa) * torch.clamp(d[:, ADAMP] * h, max=1.0)
    delta_v = (vb - va) * torch.clamp(d[:, LDAMP] * h, max=1.0)[:, None]
    w1, w2 = d[:, IMA], d[:, IMB]
    wsum = w1 + w2
    p = delta_v * torch.where(wsum > 1e-12, 1.0 / torch.clamp(wsum, min=1e-12), 0.0)[:, None]
    inc = torch.cat([
        torch.cat([p * w1[:, None], torch.where(d[:, IIA] > 0.0, delta_omega, 0.0)[:, None]], -1),
        torch.cat([-p * w2[:, None], torch.where(d[:, IIB] > 0.0, -delta_omega, 0.0)[:, None]],
                  -1),
    ])
    vel = state[:, 0:3].clone()
    ordered_add(vel, torch.cat([a, b]), inc)
    state[:, 0:3] = vel


def entry_order_2d(body_a, body_b, data, on, n_bodies):
    """Per-step order of the shared-body writes of the joints ``on`` bool[J].
    Entry ``e`` is ``side * J + joint`` (side 0 = body a). Returns ``(order
    i32[2J], key i32[2J])``: the entries stably sorted by the body they
    write, and that body (``n_bodies`` for none: a joint not in ``on`` or an
    end with zero inverse mass and inertia)."""
    writes_a = (data[:, IMVA:IMVA + 2] != 0).any(-1) | (data[:, IIA] != 0)
    writes_b = (data[:, IMVB:IMVB + 2] != 0).any(-1) | (data[:, IIB] != 0)
    key = torch.cat([
        torch.where(on & writes_a, body_a.long(), n_bodies),
        torch.where(on & writes_b, body_b.long(), n_bodies),
    ])
    skey, order = torch.sort(key, stable=True)
    return order.to(torch.int32).contiguous(), skey.to(torch.int32).contiguous()


def joint_color_2d(color, last, state, data, lam, jtype, body_a, body_b, jcolor, mask,
                   ovf_order, ovf_key, hh):
    """Solve the joints of colour ``color`` (the overflow colour if ``last``),
    updating ``state`` f32[N, 6] and ``lam`` f32[J, 3] in place.
    ``ovf_order``/``ovf_key`` (``entry_order_2d`` of the overflow colour's
    joints) are read when ``last``; ``hh`` is ``h * h``."""
    dev = state.device
    if dev.type == "cpu":
        joint_color_2d_twin(color, state, data, lam, jtype, body_a, body_b, jcolor, mask, hh)
        return
    if dev.type != "cuda":
        raise RuntimeError(f"joint_color_2d: unsupported device {dev}")
    from avian_tpu_torch.kernels import build

    n, j = state.shape[0], data.shape[0]
    f32, i32 = torch.float32, torch.int32
    build.require("joint_color_2d", dev, (
        ("state", state, (n, STATE), f32), ("data", data, (j, JD), f32),
        ("lam", lam, (j, LAM), f32), ("jtype", jtype, (j,), i32),
        ("body_a", body_a, (j,), i32), ("body_b", body_b, (j,), i32),
        ("jcolor", jcolor, (j,), i32), ("mask", mask, (j,), f32),
        ("ovf_order", ovf_order, (2 * j,), i32), ("ovf_key", ovf_key, (2 * j,), i32),
    ))
    if j == 0:
        return
    scratch = torch.empty((2 * j if last else 1, 3), dtype=f32, device=dev)
    build.launch("avian_joint_color_2d", dev, int(color), int(bool(last)), j, n, state, data,
                 lam, jtype, body_a, body_b, jcolor, mask, ovf_order, ovf_key, scratch,
                 float(hh))
    joint_color_2d.launches += 1


joint_color_2d.launches = 0


def joint_velocities_2d(state, pre, data, body_a, body_b, mask, damp_order, damp_key, h):
    """The velocity projection from the delta pose's change since ``pre``
    f32[N, 3] (delta position and angle before the first colour), then joint
    damping, updating ``state`` in place. ``damp_order``/``damp_key`` are
    ``entry_order_2d`` of the joints with ``mask > 0``."""
    dev = state.device
    if dev.type == "cpu":
        joint_velocities_2d_twin(state, pre, data, body_a, body_b, mask, h)
        return
    if dev.type != "cuda":
        raise RuntimeError(f"joint_velocities_2d: unsupported device {dev}")
    from avian_tpu_torch.kernels import build

    n, j = state.shape[0], data.shape[0]
    f32, i32 = torch.float32, torch.int32
    build.require("joint_velocities_2d", dev, (
        ("state", state, (n, STATE), f32), ("pre", pre, (n, 3), f32),
        ("data", data, (j, JD), f32), ("body_a", body_a, (j,), i32),
        ("body_b", body_b, (j,), i32), ("mask", mask, (j,), f32),
        ("damp_order", damp_order, (2 * j,), i32), ("damp_key", damp_key, (2 * j,), i32),
    ))
    if n == 0:
        return
    scratch = torch.empty((max(2 * j, 1), 3), dtype=f32, device=dev)
    build.launch("avian_joint_velocities_2d", dev, j, n, state, pre, data, body_a, body_b, mask,
                 damp_order, damp_key, scratch, float(h))
    joint_velocities_2d.launches += 1


joint_velocities_2d.launches = 0
