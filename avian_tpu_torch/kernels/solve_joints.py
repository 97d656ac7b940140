"""Kernel I, ``solve_joints``: the XPBD joint solver of one substep.

Replaces ``avian_tpu/pipeline/xpbd.py::solve_position_constraints`` (:229)
with ``_solve_color`` (:283) and ``_joint_damping`` (:464), and the row
building of ``prepare_joints`` (:89). ``joint_rows`` is one launch a step;
the caller then launches ``joint_color`` once per joint colour in colour
order and ``joint_velocities`` once: a substep is ``max_colors + 1``
launches.

- ``joint_rows``: one thread per joint gathers its two bodies and writes its
  packed 57-float row (world anchors, centre difference, axes, rotation
  difference, limits, compliance, damping, effective masses and inertias)
  and whether it is solved;

- ``joint_color``: one thread per joint of the colour. The thread reads its
  packed joint row and the delta pose of both bodies from the ``f32[N, 13]``
  solver state and runs the reference's steps in order (hinge or full
  alignment, angle limit or swing, twist, then the positional correction,
  for all five joint types), accumulating delta positions and rotation
  vectors per end and the Lagrange totals of its row.
- ``joint_velocities``: the velocity projection from the change of the delta
  pose since ``pre`` (a copy taken before the first colour, as the
  reference keeps ``pre_delta_pos``/``pre_delta_quat``), one thread per
  body; then joint damping, which reads every joint's two bodies before any
  write.

Rules that keep it right and bitwise reproducible without float atomics:

- an end whose inverse mass and inertia are all zero (static, sleeping or
  kinematic; the chain anchor of a pendulum) gets exactly zero deltas and is
  not written, so a static body shared by many joints never serialises;
- colours ``0 .. max_colors - 2`` share no dynamic body: each thread writes
  its ends directly, ``dq <- from_scaled_axis(0 + rv) * dq``;
- the overflow colour and the damping may share bodies. As in the reference
  (``.at[].add`` of every joint's increments, then one ``from_scaled_axis``
  of the summed rotation vector), phase 1 writes each joint's increments to
  scratch and phase 2 gives one thread to each body, which adds them in the
  fixed ``[a-sides..., b-sides...]`` order given by ``entry_order``.

On the H100 a launch is one colour's joints, each a 57-float row and two
13-float body rows, with about 1,500 flops of quaternion and limit algebra
in registers: bound by launch latency and the dependent gathers, as
Kernel D is. Every operation is spelled in the plain version's order, and
``arcsin``, ``sin``, ``cos`` and square roots are libdevice's precise ones,
so the two agree to the bit where every body has one writer.

The plain PyTorch versions, ``joint_color_twin`` and
``joint_velocities_twin``, run on CPU tensors; on a CUDA tensor the
wrappers launch the kernels or raise.
"""

import torch

from avian_tpu_torch.core.types import JointType
from avian_tpu_torch.math import quat as quat_m
from avian_tpu_torch.math import sym3, vec

_PI = 3.14159265358979

# Packed joint row layout data[J, JD] (the reference's JointConstraints).
R1, R2, CD = 0, 3, 6                # world anchors from each COM; centre difference
AXA, AXB, SECA, SECB = 9, 12, 15, 18  # primary (basis Z) and secondary (X) axes
ROTD = 21                           # 21:25 (qa*basis_a)(qb*basis_b)^-1
COMP = 25                           # 25:29 compliance (point, align, limit, twist)
LMIN, LMAX, LEN = 29, 30, 31        # limit and whether it is enabled (1.0)
TMIN, TMAX, TEN = 32, 33, 34        # twist limit
LDAMP, ADAMP = 35, 36
IMA, IMB = 37, 38                   # largest component of the inverse mass
IMVA, IMVB = 39, 42                 # per-axis inverse mass
IIA, IIB = 45, 51                   # world inverse inertia (sym6)
JD = 57
# Lagrange totals lam[J, 6]: 0:3 positional, 3:6 rotational.
LAM = 6


def joint_rows_twin(joints, bodies, inv_mass, inv_inertia, solve_mask):
    """Plain PyTorch version; see ``joint_rows``."""
    j, b = joints, bodies
    ba, bb = j.body_a.long(), j.body_b.long()
    dyn_a = solve_mask[ba] > 0
    dyn_b = solve_mask[bb] > 0
    mask = j.active & (dyn_a | dyn_b)
    qa, qb = b.quat[ba], b.quat[bb]
    com_a = quat_m.rotate(qa, b.com[ba])
    com_b = quat_m.rotate(qb, b.com[bb])
    world_r1 = quat_m.rotate(qa, j.frame_pos_a - b.com[ba])
    world_r2 = quat_m.rotate(qb, j.frame_pos_b - b.com[bb])
    center_difference = (b.pos[bb] - b.pos[ba]) + (com_b - com_a)
    basis_a = quat_m.mul(qa, j.frame_quat_a)
    basis_b = quat_m.mul(qb, j.frame_quat_b)
    z_axis = torch.zeros_like(world_r1)
    z_axis[:, 2] = 1.0
    x_axis = torch.zeros_like(world_r1)
    x_axis[:, 0] = 1.0
    ima, imb = inv_mass[ba], inv_mass[bb]

    def col(x):
        return x.float()[:, None]

    data = torch.cat([
        world_r1, world_r2, center_difference,
        quat_m.rotate(basis_a, z_axis), quat_m.rotate(basis_b, z_axis),
        quat_m.rotate(basis_a, x_axis), quat_m.rotate(basis_b, x_axis),
        quat_m.mul(basis_a, quat_m.conj(basis_b)), j.compliance,
        col(j.limit_min), col(j.limit_max), col(j.limit_enabled),
        col(j.twist_min), col(j.twist_max), col(j.twist_enabled),
        col(j.lin_damping), col(j.ang_damping),
        col(ima.amax(dim=-1)), col(imb.amax(dim=-1)), ima, imb,
        inv_inertia[ba], inv_inertia[bb],
    ], dim=-1).contiguous()
    return data, mask, dyn_a, dyn_b


def joint_rows(joints, bodies, inv_mass, inv_inertia, solve_mask):
    """``(data f32[J, JD], mask bool[J], dyn_a bool[J], dyn_b bool[J])``:
    each joint's packed row from the bodies' poses and the solver's
    effective inverse masses f32[N, 3] and inertias f32[N, 6], whether it is
    solved (active, a responding end) and which ends respond
    (``solve_mask`` f32[N] > 0)."""
    dev = inv_mass.device
    if dev.type == "cpu":
        return joint_rows_twin(joints, bodies, inv_mass, inv_inertia, solve_mask)
    if dev.type != "cuda":
        raise RuntimeError(f"joint_rows: unsupported device {dev}")
    from avian_tpu_torch.kernels import build

    j, b = joints, bodies
    n, jn = b.capacity, j.capacity
    f32, i32, u8 = torch.float32, torch.int32, torch.bool
    rows = [(name, getattr(j, name), (jn,), dt) for name, dt in (
        ("body_a", i32), ("body_b", i32), ("active", u8), ("limit_min", f32),
        ("limit_max", f32), ("limit_enabled", u8), ("twist_min", f32), ("twist_max", f32),
        ("twist_enabled", u8), ("lin_damping", f32), ("ang_damping", f32))]
    build.require("joint_rows", dev, rows + [
        ("frame_pos_a", j.frame_pos_a, (jn, 3), f32), ("frame_pos_b", j.frame_pos_b, (jn, 3), f32),
        ("frame_quat_a", j.frame_quat_a, (jn, 4), f32),
        ("frame_quat_b", j.frame_quat_b, (jn, 4), f32),
        ("compliance", j.compliance, (jn, 4), f32), ("pos", b.pos, (n, 3), f32),
        ("quat", b.quat, (n, 4), f32), ("com", b.com, (n, 3), f32),
        ("inv_mass", inv_mass, (n, 3), f32), ("inv_inertia", inv_inertia, (n, 6), f32),
        ("solve_mask", solve_mask, (n,), f32),
    ])
    data = torch.empty((jn, JD), dtype=f32, device=dev)
    mask = torch.empty((jn,), dtype=u8, device=dev)
    dyn_a = torch.empty((jn,), dtype=u8, device=dev)
    dyn_b = torch.empty((jn,), dtype=u8, device=dev)
    if jn == 0:
        return data, mask, dyn_a, dyn_b
    build.launch("avian_joint_rows", dev, jn, j.body_a, j.body_b, j.active, j.frame_pos_a,
                 j.frame_pos_b, j.frame_quat_a, j.frame_quat_b, j.compliance, j.limit_min,
                 j.limit_max, j.limit_enabled, j.twist_min, j.twist_max, j.twist_enabled,
                 j.lin_damping, j.ang_damping, b.pos, b.quat, b.com, inv_mass, inv_inertia,
                 solve_mask, data, mask, dyn_a, dyn_b)
    joint_rows.launches += 1
    return data, mask, dyn_a, dyn_b


joint_rows.launches = 0


_SIDES = (1.0, -1.0)  # side a's and side b's sign of a shared impulse


def _pair(d, col, width):
    """``[2, R, width]``: the a-side and b-side columns of ``d`` that start at
    ``col[0]`` and ``col[1]``."""
    return torch.stack([d[:, col[0]:col[0] + width], d[:, col[1]:col[1] + width]])


def _angular_correction(ii, diff, compliance, hh, active):
    """(rotvec f32[2, R, 3] of the two ends, impulse) of one angular
    constraint; ``ii`` the ends' world inverse inertia [2, R, 6]."""
    angle = vec.length(diff)
    ok = active & (angle > 1e-9)
    axis = diff / torch.clamp(angle, min=1e-9)[:, None]
    w = vec.dot(axis, sym3.mv(ii, axis))
    w_sum = w[0] + w[1]
    tilde = compliance / hh
    dl = torch.where(ok & (w_sum > 1e-12), -angle / torch.clamp(w_sum + tilde, min=1e-12), 0.0)
    impulse = -dl[:, None] * axis
    sides = torch.tensor(_SIDES, dtype=ii.dtype, device=ii.device)[:, None, None]
    return sym3.mv(ii, impulse) * sides, impulse


def _angle_limit(limit_axis, axis1, axis2, lo, hi, enabled):
    """3D ``AngleLimit::compute_correction``: (correction, violated); the
    axes may carry leading axes ahead of the rows."""
    sphi = torch.clamp(vec.dot(vec.cross(axis1, axis2), limit_axis), -1.0, 1.0)
    phi = torch.asin(sphi)
    phi = torch.where(vec.dot(axis1, axis2) < 0.0, _PI - phi, phi)
    phi = torch.where(phi > _PI, phi - 2.0 * _PI, phi)
    violated = enabled & ((phi < lo) | (phi > hi))
    phi_t = torch.minimum(torch.maximum(phi, lo), hi)
    rot = quat_m.from_axis_angle(limit_axis, phi_t)
    corr = vec.clamp_length_max(vec.cross(quat_m.rotate(rot, axis1), axis2), _PI)
    return torch.where(violated[..., None], corr, 0.0), violated


def joint_increments(d, jtype, dp_a, dp_b, dq_a, dq_b, lam, hh):
    """One colour's work for R joint rows: ``(dpos_a, dpos_b, rotvec_a,
    rotvec_b, new lam)`` from the rows ``d`` f32[R, JD], types, the ends'
    delta positions and rotations, the Lagrange totals f32[R, 6] and
    ``hh = h * h``. Every joint in ``d`` is active (reference ``_solve_color``
    for the rows of one colour). The two ends are one tensor ``[2, R, ...]``
    wherever they do the same operations: half the operations, the same
    rounding."""
    r = d.shape[0]
    is_fixed = jtype == JointType.FIXED
    is_distance = jtype == JointType.DISTANCE
    is_revolute = jtype == JointType.REVOLUTE
    is_prismatic = jtype == JointType.PRISMATIC
    is_spherical = jtype == JointType.SPHERICAL
    x_axis = torch.zeros((r, 3), dtype=d.dtype, device=d.device)
    x_axis[:, 0] = 1.0
    acc_rv = torch.zeros((2, r, 3), dtype=d.dtype, device=d.device)
    tot_pos, tot_rot = lam[:, 0:3], lam[:, 3:6]
    lmin, lmax, len_ = d[:, LMIN], d[:, LMAX], d[:, LEN] > 0.0
    comp = d[:, COMP:COMP + 4]
    dq = torch.stack([dq_a, dq_b])
    ii = _pair(d, (IIA, IIB), 6)
    axes = torch.stack([_pair(d, (AXA, AXB), 3), _pair(d, (SECA, SECB), 3)], 2)  # [2, R, 2, 3]

    def cur():
        return quat_m.mul(quat_m.from_scaled_axis(acc_rv), dq)

    def add(cond, rv, imp):
        nonlocal acc_rv, tot_rot
        c = cond[:, None]
        acc_rv = acc_rv + torch.where(c, rv, 0.0)
        tot_rot = tot_rot + torch.where(c, imp, 0.0)

    # 1. Alignment: full orientation lock (fixed, prismatic), hinge axes
    #    (revolute).
    qd = cur()
    full = quat_m.mul(quat_m.mul(d[:, ROTD:ROTD + 4], qd[0]), quat_m.conj(qd[1]))[:, :3] * -2.0
    a = quat_m.rotate(qd, axes[:, :, 0])
    hinge = vec.cross(a[0], a[1])
    diff = torch.where((is_fixed | is_prismatic)[:, None], full,
                       torch.where(is_revolute[:, None], hinge, 0.0))
    on = is_fixed | is_prismatic | is_revolute
    add(on, *_angular_correction(ii, diff, comp[:, 1], hh, on))

    # 2. Angle limits: about the hinge (revolute), swing (spherical), one
    #    call for both.
    qd = cur()
    ab = quat_m.rotate(qd[:, :, None], axes)
    (a1, b1), (a2, b2) = ab[0].unbind(1), ab[1].unbind(1)
    n_sw = vec.normalize_or(vec.cross(a1, a2), x_axis)
    corr, viol = _angle_limit(torch.stack([a1, n_sw]), torch.stack([b1, a1]),
                              torch.stack([b2, a2]), lmin, lmax, len_)
    corr = torch.where(is_revolute[:, None], corr[0],
                       torch.where(is_spherical[:, None], corr[1], 0.0))
    on = (is_revolute & viol[0]) | (is_spherical & viol[1])
    add(on, *_angular_correction(ii, corr, comp[:, 2], hh, on))

    # 2b. Spherical twist about n = normalize(a1 + a2).
    qd = cur()
    ab = quat_m.rotate(qd[:, :, None], axes)
    a, b = ab[:, :, 0], ab[:, :, 1]
    n_tw = vec.normalize_or(a[0] + a[1], x_axis)
    n12 = vec.normalize_or(b - n_tw * vec.dot(n_tw, b)[..., None], x_axis)
    corr_tw, viol_tw = _angle_limit(n_tw, n12[0], n12[1], d[:, TMIN], d[:, TMAX],
                                    d[:, TEN] > 0.0)
    on = is_spherical & viol_tw
    add(on, *_angular_correction(ii, torch.where(on[:, None], corr_tw, 0.0), comp[:, 3], hh, on))

    # 3. Positional correction at the anchors.
    qd = cur()
    anchors = _pair(d, (R1, R2), 3)
    ra = quat_m.rotate(qd[:, :, None], torch.stack([anchors, axes[:, :, 0]], 2))
    r_, axis1 = ra[:, :, 0], ra[0, :, 1]
    zero3 = torch.zeros_like(dp_a)  # the positional deltas so far, as the reference adds them
    sep = ((dp_b + zero3) - (dp_a + zero3)) + (r_[1] - r_[0]) + d[:, CD:CD + 3]
    dist = vec.length(sep)
    dir_ = sep / torch.clamp(dist, min=1e-9)[:, None]
    dist_corr = torch.where(
        (dist < lmin)[:, None], -dir_ * (lmin - dist)[:, None],
        torch.where((dist > lmax)[:, None], dir_ * (dist - lmax)[:, None], 0.0),
    )
    along = vec.dot(sep, axis1)
    perp = sep - axis1 * along[:, None]
    along_corr = torch.where(
        len_ & (along < lmin), along - lmin,
        torch.where(len_ & (along > lmax), along - lmax, 0.0),
    )
    pris_corr = perp + axis1 * along_corr[:, None]
    correction = torch.where(is_distance[:, None], dist_corr,
                             torch.where(is_prismatic[:, None], pris_corr, sep))
    # The reference turns the anchors by the accumulated rotation and then
    # by the current delta rotation, which already holds it.
    r_ = quat_m.rotate(qd, quat_m.rotate(quat_m.from_scaled_axis(acc_rv), anchors))
    c = vec.length(correction)
    ok = c > 1e-9
    dir_ = -correction / torch.clamp(c, min=1e-9)[:, None]
    rxn = vec.cross(r_, dir_)
    w = _pair(d, (IMA, IMB), 1)[..., 0] + vec.dot(rxn, sym3.mv(ii, rxn))
    w_sum = w[0] + w[1]
    tilde = comp[:, 0] / hh
    dl = torch.where(ok & (w_sum > 1e-12), -c / torch.clamp(w_sum + tilde, min=1e-12), 0.0)
    impulse = dl[:, None] * dir_
    acc_dp = zero3 + torch.stack([impulse, -impulse]) * _pair(d, (IMVA, IMVB), 3)
    sides = torch.tensor(_SIDES, dtype=d.dtype, device=d.device)[:, None, None]
    acc_rv = acc_rv + sym3.mv(ii, vec.cross(r_, impulse)) * sides
    tot_pos = tot_pos + impulse
    return acc_dp[0], acc_dp[1], acc_rv[0], acc_rv[1], torch.cat([tot_pos, tot_rot], dim=-1)


def joint_color_twin(color, state, data, lam, jtype, body_a, body_b, jcolor, mask, hh):
    """Plain PyTorch version of one launch: updates ``state`` and ``lam`` in
    place. Every joint of the colour reads the delta poses before any write;
    the increments are then added in ``[a-sides..., b-sides...]`` order and
    each body's summed rotation vector is applied once."""
    rows = torch.nonzero((jcolor == color) & (mask > 0.0), as_tuple=True)[0]
    if rows.numel() == 0:
        return
    a, b = body_a[rows].long(), body_b[rows].long()
    dp_a, dp_b, rv_a, rv_b, new_lam = joint_increments(
        data[rows], jtype[rows], state[a, 6:9], state[b, 6:9], state[a, 9:13],
        state[b, 9:13], lam[rows], hh,
    )
    lam[rows] = new_lam
    idx = torch.cat([a, b])
    dpos = state[:, 6:9].clone()
    dpos.index_add_(0, idx, torch.cat([dp_a, dp_b]))
    rot = torch.zeros_like(dpos)
    rot.index_add_(0, idx, torch.cat([rv_a, rv_b]))
    state[:, 6:9] = dpos
    state[:, 9:13] = quat_m.mul(quat_m.from_scaled_axis(rot), state[:, 9:13])


def joint_velocities_twin(state, pre, data, body_a, body_b, mask, h):
    """Plain PyTorch version of ``joint_velocities``: updates ``state``."""
    new_lin = (state[:, 6:9] - pre[:, 0:3]) / h
    dq = quat_m.mul(state[:, 9:13], quat_m.conj(pre[:, 3:7]))
    new_ang = dq[:, :3] * 2.0 / h
    new_ang = torch.where(dq[:, 3:4] < 0.0, -new_ang, new_ang)
    state[:, 0:3] = state[:, 0:3] + new_lin
    state[:, 3:6] = state[:, 3:6] + new_ang

    rows = torch.nonzero(mask > 0.0, as_tuple=True)[0]
    if rows.numel() == 0:
        return
    d = data[rows]
    a, b = body_a[rows].long(), body_b[rows].long()
    va, vb, wa, wb = state[a, 0:3], state[b, 0:3], state[a, 3:6], state[b, 3:6]
    delta_omega = (wb - wa) * torch.clamp(d[:, ADAMP] * h, max=1.0)[:, None]
    delta_v = (vb - va) * torch.clamp(d[:, LDAMP] * h, max=1.0)[:, None]
    w1, w2 = d[:, IMA], d[:, IMB]
    p = delta_v * vec.safe_recip(w1 + w2)[:, None]
    resp_a = (d[:, IIA:IIA + 6] != 0.0).any(-1)[:, None]
    resp_b = (d[:, IIB:IIB + 6] != 0.0).any(-1)[:, None]
    idx = torch.cat([a, b])
    lin = state[:, 0:3].clone()
    lin.index_add_(0, idx, torch.cat([p * w1[:, None], -p * w2[:, None]]))
    ang = state[:, 3:6].clone()
    ang.index_add_(0, idx, torch.cat([torch.where(resp_a, delta_omega, 0.0),
                                      torch.where(resp_b, -delta_omega, 0.0)]))
    state[:, 0:3] = lin
    state[:, 3:6] = ang


def entry_order(body_a, body_b, data, on, n_bodies):
    """Per-step order of the shared-body writes of the joints ``on`` bool[J].
    Entry ``e`` is ``side * J + joint`` (side 0 = body a). Returns ``(order
    i32[2J], key i32[2J])``: the entries stably sorted by the body they
    write, and that body (``n_bodies`` for none: a joint not in ``on`` or an
    end with zero inverse mass and inertia)."""
    writes_a = (data[:, IMVA:IMVA + 3] != 0).any(-1) | (data[:, IIA:IIA + 6] != 0).any(-1)
    writes_b = (data[:, IMVB:IMVB + 3] != 0).any(-1) | (data[:, IIB:IIB + 6] != 0).any(-1)
    key = torch.cat([
        torch.where(on & writes_a, body_a.long(), n_bodies),
        torch.where(on & writes_b, body_b.long(), n_bodies),
    ])
    skey, order = torch.sort(key, stable=True)
    return order.to(torch.int32).contiguous(), skey.to(torch.int32).contiguous()


def joint_color(color, last, state, data, lam, jtype, body_a, body_b, jcolor, mask,
                ovf_order, ovf_key, hh):
    """Solve the joints of colour ``color`` (the overflow colour if ``last``),
    updating ``state`` f32[N, 13] and ``lam`` f32[J, 6] in place.
    ``ovf_order``/``ovf_key`` (``entry_order`` of the overflow colour's
    joints) are read when ``last``; ``hh`` is ``h * h``."""
    dev = state.device
    if dev.type == "cpu":
        joint_color_twin(color, state, data, lam, jtype, body_a, body_b, jcolor, mask, hh)
        return
    if dev.type != "cuda":
        raise RuntimeError(f"joint_color: unsupported device {dev}")
    from avian_tpu_torch.kernels import build

    n, j = state.shape[0], data.shape[0]
    f32, i32 = torch.float32, torch.int32
    build.require("joint_color", dev, (
        ("state", state, (n, 13), f32), ("data", data, (j, JD), f32),
        ("lam", lam, (j, LAM), f32), ("jtype", jtype, (j,), i32),
        ("body_a", body_a, (j,), i32), ("body_b", body_b, (j,), i32),
        ("jcolor", jcolor, (j,), i32), ("mask", mask, (j,), f32),
        ("ovf_order", ovf_order, (2 * j,), i32), ("ovf_key", ovf_key, (2 * j,), i32),
    ))
    scratch = torch.empty((2 * j if last else 1, 6), dtype=f32, device=dev)
    if j == 0:
        return
    build.launch("avian_joint_color", dev, int(color), int(bool(last)), j, n, state, data, lam,
                 jtype, body_a, body_b, jcolor, mask, ovf_order, ovf_key, scratch, float(hh))
    joint_color.launches += 1


joint_color.launches = 0


def joint_velocities(state, pre, data, body_a, body_b, mask, damp_order, damp_key, h):
    """The velocity projection from the delta pose's change since ``pre``
    f32[N, 7] (delta position and rotation before the first colour), then
    joint damping, updating ``state`` in place. ``damp_order``/``damp_key``
    are ``entry_order`` of the joints with ``mask > 0``."""
    dev = state.device
    if dev.type == "cpu":
        joint_velocities_twin(state, pre, data, body_a, body_b, mask, h)
        return
    if dev.type != "cuda":
        raise RuntimeError(f"joint_velocities: unsupported device {dev}")
    from avian_tpu_torch.kernels import build

    n, j = state.shape[0], data.shape[0]
    f32, i32 = torch.float32, torch.int32
    build.require("joint_velocities", dev, (
        ("state", state, (n, 13), f32), ("pre", pre, (n, 7), f32),
        ("data", data, (j, JD), f32), ("body_a", body_a, (j,), i32),
        ("body_b", body_b, (j,), i32), ("mask", mask, (j,), f32),
        ("damp_order", damp_order, (2 * j,), i32), ("damp_key", damp_key, (2 * j,), i32),
    ))
    scratch = torch.empty((max(2 * j, 1), 6), dtype=f32, device=dev)
    build.launch("avian_joint_velocities", dev, j, n, state, pre, data, body_a, body_b, mask,
                 damp_order, damp_key, scratch, float(h))
    joint_velocities.launches += 1


joint_velocities.launches = 0
