"""The plain versions of Kernels D, Y and I one end of a row at a time.

``kernels/solve_color.py::_row_update`` (D), ``kernels/solve_2d.py::_row_update``
(Y) and ``kernels/solve_joints.py::joint_increments`` (I) compute both ends
of a row as one ``[2, R, ...]`` tensor, side a's inverse mass and inertia
negated so that ``d - p * m`` is ``d + p * (-m)``. These are the same
functions with each end computed on its own, every operation in the
kernels' order. ``cases_solver.py``, ``cases_dim2.py`` and
``cases_joints.py`` hold the current plain versions to them bit for bit,
zero signs included, on seeded rows: the plain versions are what the card
holds its kernels against.
"""

import torch

from avian_tpu_torch.core.types import JointType
from avian_tpu_torch.kernels import solve_2d as ky
from avian_tpu_torch.kernels import solve_color as kd
from avian_tpu_torch.kernels import solve_joints as ki
from avian_tpu_torch.kernels.solve_color import SolveParams
from avian_tpu_torch.kernels.solve_2d import SolveParams2D
from avian_tpu_torch.math import quat as quat_m
from avian_tpu_torch.math import sym3, vec


def assert_same_bits(got, want, what):
    """``got`` equals ``want`` bit for bit: zero signs and NaNs included."""
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if got.is_floating_point():
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got, want), what


# Kernel: its module, contact points a row, state columns a body, inverse
# mass and inverse inertia columns an end.
_LAYOUT = {"D": (kd, 4, 13, 3, 6), "Y": (ky, 2, 6, 2, 1)}


def random_rows(kernel, rows, g):
    """Seeded rows of Kernel ``kernel`` ("D" or "Y"): constraint data with a
    point mask and restitution on some rows and side a static on a quarter
    of them, impulse rows, both ends' state rows and the relaxation."""
    mod, points, state_cols, mass, inertia = _LAYOUT[kernel]
    d = torch.randn(rows, mod.D, generator=g)
    d[:, mod.PM:mod.PM + points] = (torch.rand(rows, points, generator=g) > 0.3).float()
    d[:, mod.RESTITUTION_COL] = torch.where(torch.rand(rows, generator=g) > 0.5,
                                            torch.rand(rows, generator=g), 0.0)
    d[:rows // 4, mod.IMA:mod.IMA + mass] = 0.0
    d[:rows // 4, mod.IIA:mod.IIA + inertia] = 0.0
    irows = torch.randn(rows, mod.IMP, generator=g).abs()
    sa = torch.randn(rows, state_cols, generator=g)
    sb = torch.randn(rows, state_cols, generator=g)
    return d, irows, sa, sb, torch.rand(rows, generator=g)


# ---- Kernel D ---------------------------------------------------------

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


def _row_update_3d(mode, d, irows, sa, sb, rlx, p: SolveParams):
    """Deltas (d_va, d_wa, d_vb, d_wb) and new impulse rows for R rows.

    Every operation is the kernel's, in the kernel's order, so that the two
    agree to the bit: a resting contact sits at separation ~0, where the
    speculative and the soft branch give different impulses."""
    n = d[:, kd.N_:kd.N_ + 3]
    ima, imb = d[:, kd.IMA:kd.IMA + 3], d[:, kd.IMB:kd.IMB + 3]
    mia, mib = _sym_mat(d[:, kd.IIA:kd.IIA + 6]), _sym_mat(d[:, kd.IIB:kd.IIB + 6])
    r1 = d[:, kd.AA:kd.AA + 12].reshape(-1, 4, 3)
    r2 = d[:, kd.AB:kd.AB + 12].reshape(-1, 4, 3)
    k1s, k2s = _skew(r1), _skew(r2)
    pm = d[:, kd.PM:kd.PM + 4]
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

    if mode == kd.WARM:
        t1, t2 = d[:, kd.T1:kd.T1 + 3], d[:, kd.T2:kd.T2 + 3]
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

    if mode == kd.RESTITUTION:
        vmask = (d[:, kd.RESTITUTION_COL] > 0.0).float()
        for i in range(4):
            ns = d[:, kd.NS + i]
            active = (ns < -p.restitution_threshold) & (irows[:, 12 + i] > 0.0)
            pmi = pm[:, i] * vmask * active.float()
            vn = _dot(rel_vel(i), n)
            delta = -d[:, kd.NM + i] * (vn + d[:, kd.RESTITUTION_COL] * ns)
            acc = irows[:, i]
            new_acc = torch.clamp(acc + rlx * delta, min=0.0)
            applied = (new_acc - acc) * pmi
            new[:, i] = torch.where(pmi > 0, new_acc, acc)
            new[:, 12 + i] = irows[:, 12 + i] + applied
            apply(applied[:, None] * n, i)
        return d_va, d_wa, d_vb, d_wb, new

    use_bias = mode == kd.BIAS
    h = p.h
    # Separation depends only on the delta poses, which a pass never
    # changes: all 4 points at once.
    dq_a = sa[:, None, 9:13]
    dq_b = sb[:, None, 9:13]
    delta_sep = (sb[:, None, 6:9] - sa[:, None, 6:9]) + (
        quat_m.rotate(dq_b, r2) - quat_m.rotate(dq_a, r1)
    )
    separation = _dot(delta_sep, n[:, None, :]) + d[:, kd.SEP:kd.SEP + 4]
    soft_bias, soft_mass, soft_imp = d[:, kd.SOFT], d[:, kd.SOFT + 1], d[:, kd.SOFT + 2]
    for i in range(4):
        sep_i = separation[:, i]
        vn = _dot(rel_vel(i), n)
        m_eff = d[:, kd.NM + i]
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

    t1, t2 = d[:, kd.T1:kd.T1 + 3], d[:, kd.T2:kd.T2 + 3]
    sv = d[:, kd.SV:kd.SV + 3]
    for i in range(4):
        rv = rel_vel(i) + sv
        vt1 = _dot(rv, t1)
        vt2 = _dot(rv, t2)
        k1, k2, k12 = d[:, kd.TK + 3 * i], d[:, kd.TK + 3 * i + 1], d[:, kd.TK + 3 * i + 2]
        t11, t22, t12 = vt1 * vt1, vt2 * vt2, vt1 * vt2
        inv = t11 * k1 + t22 * k2 + t12 * k12
        recip = torch.where(inv != 0.0, 1.0 / torch.where(inv == 0.0, 1.0, inv), 0.0)
        m_eff = (t11 + t22) * recip
        m_eff = torch.where(torch.isfinite(m_eff), m_eff, 0.0)
        acc = irows[:, 4 + 2 * i:6 + 2 * i]
        mu = torch.where(t11 + t22 <= p.stiction_t2, d[:, kd.SF], d[:, kd.FRICTION])
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


# ---- Kernel Y ---------------------------------------------------------

def _cross_2d(ax, ay, bx, by):
    return ax * by - ay * bx


def _row_update_2d(mode, d, irows, sa, sb, rlx, p: SolveParams2D):
    """Deltas (d_va [R, 2], d_wa [R], d_vb, d_wb) and new impulse rows [R, 6]
    of R rows, every operation in the reference's order."""
    nx, ny = d[:, ky.N_], d[:, ky.N_ + 1]
    tx, ty = ny, -nx  # the single 2D tangent, perp(n)
    imax, imay, imbx, imby = d[:, ky.IMA], d[:, ky.IMA + 1], d[:, ky.IMB], d[:, ky.IMB + 1]
    iia, iib = d[:, ky.IIA], d[:, ky.IIB]
    r1 = [(d[:, ky.AA + 2 * i], d[:, ky.AA + 2 * i + 1]) for i in range(2)]
    r2 = [(d[:, ky.AB + 2 * i], d[:, ky.AB + 2 * i + 1]) for i in range(2)]
    pm = [d[:, ky.PM], d[:, ky.PM + 1]]
    new = irows.clone()

    if mode == ky.WARM:
        px, py, cra, crb = None, None, None, None
        for i in range(2):
            np_ = irows[:, i] * pm[i]
            tp = irows[:, 2 + i] * pm[i]
            pxi = (np_ * nx + tp * tx) * p.warm_coefficient
            pyi = (np_ * ny + tp * ty) * p.warm_coefficient
            ca = _cross_2d(r1[i][0], r1[i][1], pxi, pyi)
            cb = _cross_2d(r2[i][0], r2[i][1], pxi, pyi)
            if i == 0:
                px, py, cra, crb = pxi, pyi, ca, cb
            else:
                px, py, cra, crb = px + pxi, py + pyi, cra + ca, crb + cb
        d_va = torch.stack([-px * imax, -py * imay], -1)
        d_vb = torch.stack([px * imbx, py * imby], -1)
        return d_va, -(iia * cra), d_vb, iib * crb, new

    vax, vay, wa = sa[:, 0], sa[:, 1], sa[:, 2]
    vbx, vby, wb = sb[:, 0], sb[:, 1], sb[:, 2]
    z = torch.zeros_like(vax)
    dvax, dvay, dwa, dvbx, dvby, dwb = z, z, z, z, z, z

    def rel_vel(i):
        wbt, wat = wb + dwb, wa + dwa
        rvx = ((vbx + dvbx) + wbt * -r2[i][1]) - ((vax + dvax) + wat * -r1[i][1])
        rvy = ((vby + dvby) + wbt * r2[i][0]) - ((vay + dvay) + wat * r1[i][0])
        return rvx, rvy

    def apply(applied, ux, uy, i):
        nonlocal dvax, dvay, dwa, dvbx, dvby, dwb
        pvx, pvy = applied * ux, applied * uy
        dvax, dvay = dvax - pvx * imax, dvay - pvy * imay
        dwa = dwa - iia * _cross_2d(r1[i][0], r1[i][1], pvx, pvy)
        dvbx, dvby = dvbx + pvx * imbx, dvby + pvy * imby
        dwb = dwb + iib * _cross_2d(r2[i][0], r2[i][1], pvx, pvy)

    def deltas():
        return torch.stack([dvax, dvay], -1), dwa, torch.stack([dvbx, dvby], -1), dwb

    if mode == ky.RESTITUTION:
        rest = d[:, ky.RESTITUTION_COL]
        vmask = (rest > 0.0).float()
        for i in range(2):
            ns = d[:, ky.NS + i]
            active = ((ns < -p.restitution_threshold) & (irows[:, 4 + i] > 0.0)).float()
            pmi = pm[i] * vmask * active
            rvx, rvy = rel_vel(i)
            vn = rvx * nx + rvy * ny
            delta = -d[:, ky.NM + i] * (vn + rest * ns)
            acc = irows[:, i]
            new_acc = torch.clamp(acc + rlx * delta, min=0.0)
            applied = (new_acc - acc) * pmi
            new[:, i] = torch.where(pmi > 0, new_acc, acc)
            new[:, 4 + i] = irows[:, 4 + i] + applied
            apply(applied, nx, ny, i)
        return (*deltas(), new)

    use_bias = mode == ky.BIAS
    ca, sa_ = torch.cos(sa[:, 5]), torch.sin(sa[:, 5])
    cb, sb_ = torch.cos(sb[:, 5]), torch.sin(sb[:, 5])
    dtx, dty = sb[:, 3] - sa[:, 3], sb[:, 4] - sa[:, 4]
    soft_bias, soft_mass, soft_imp = d[:, ky.SOFT], d[:, ky.SOFT + 1], d[:, ky.SOFT + 2]
    for i in range(2):
        (r1x, r1y), (r2x, r2y) = r1[i], r2[i]
        dsx = dtx + ((cb * r2x - sb_ * r2y) - (ca * r1x - sa_ * r1y))
        dsy = dty + ((sb_ * r2x + cb * r2y) - (sa_ * r1x + ca * r1y))
        sep = (dsx * nx + dsy * ny) + d[:, ky.SEP + i]
        rvx, rvy = rel_vel(i)
        vn = rvx * nx + rvy * ny
        m_eff = d[:, ky.NM + i]
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

    sv = d[:, ky.SV]
    for i in range(2):
        rvx, rvy = rel_vel(i)
        vt = (rvx * tx + rvy * ty) + sv
        delta = d[:, ky.TM + i] * vt
        acc = irows[:, 2 + i]
        mu = torch.where(vt * vt <= p.stiction_t2, d[:, ky.SF], d[:, ky.FRICTION])
        limit = mu * new[:, i]
        new_acc = torch.minimum(torch.maximum(acc - rlx * delta, -limit), limit)
        applied = (new_acc - acc) * pm[i]
        new[:, 2 + i] = torch.where(pm[i] > 0, new_acc, acc)
        apply(applied, tx, ty, i)
    return (*deltas(), new)


# ---- Kernel I ---------------------------------------------------------

def _angular_correction(d, diff, compliance, hh, active):
    """(rotvec_a, rotvec_b, impulse) of one angular constraint."""
    iia, iib = d[:, ki.IIA:ki.IIA + 6], d[:, ki.IIB:ki.IIB + 6]
    angle = vec.length(diff)
    ok = active & (angle > 1e-9)
    axis = diff / torch.clamp(angle, min=1e-9)[:, None]
    w1 = vec.dot(axis, sym3.mv(iia, axis))
    w2 = vec.dot(axis, sym3.mv(iib, axis))
    w_sum = w1 + w2
    tilde = compliance / hh
    dl = torch.where(ok & (w_sum > 1e-12), -angle / torch.clamp(w_sum + tilde, min=1e-12), 0.0)
    impulse = -dl[:, None] * axis
    return sym3.mv(iia, impulse), -sym3.mv(iib, impulse), impulse


def _angle_limit(limit_axis, axis1, axis2, lo, hi, enabled):
    """3D ``AngleLimit::compute_correction``: (correction, violated)."""
    sphi = torch.clamp(vec.dot(vec.cross(axis1, axis2), limit_axis), -1.0, 1.0)
    phi = torch.asin(sphi)
    phi = torch.where(vec.dot(axis1, axis2) < 0.0, ki._PI - phi, phi)
    phi = torch.where(phi > ki._PI, phi - 2.0 * ki._PI, phi)
    violated = enabled & ((phi < lo) | (phi > hi))
    phi_t = torch.minimum(torch.maximum(phi, lo), hi)
    rot = quat_m.from_axis_angle(limit_axis, phi_t)
    corr = vec.clamp_length_max(vec.cross(quat_m.rotate(rot, axis1), axis2), ki._PI)
    return torch.where(violated[:, None], corr, 0.0), violated


def joint_increments(d, jtype, dp_a, dp_b, dq_a, dq_b, lam, hh):
    """One colour's work for R joint rows: ``(dpos_a, dpos_b, rotvec_a,
    rotvec_b, new lam)`` from the rows ``d`` f32[R, JD], types, the ends'
    delta positions and rotations, the Lagrange totals f32[R, 6] and
    ``hh = h * h``. Every joint in ``d`` is active (reference ``_solve_color``
    for the rows of one colour)."""
    r = d.shape[0]
    is_fixed = jtype == JointType.FIXED
    is_distance = jtype == JointType.DISTANCE
    is_revolute = jtype == JointType.REVOLUTE
    is_prismatic = jtype == JointType.PRISMATIC
    is_spherical = jtype == JointType.SPHERICAL
    x_axis = torch.zeros((r, 3), dtype=d.dtype, device=d.device)
    x_axis[:, 0] = 1.0
    zero3 = torch.zeros((r, 3), dtype=d.dtype, device=d.device)
    acc_dp_a, acc_dp_b, acc_rv_a, acc_rv_b = zero3, zero3, zero3, zero3
    tot_pos, tot_rot = lam[:, 0:3], lam[:, 3:6]
    lmin, lmax, len_ = d[:, ki.LMIN], d[:, ki.LMAX], d[:, ki.LEN] > 0.0
    comp = d[:, ki.COMP:ki.COMP + 4]

    def cur():
        return (quat_m.mul(quat_m.from_scaled_axis(acc_rv_a), dq_a),
                quat_m.mul(quat_m.from_scaled_axis(acc_rv_b), dq_b))

    def add(cond, rv_a, rv_b, imp):
        nonlocal acc_rv_a, acc_rv_b, tot_rot
        c = cond[:, None]
        acc_rv_a = acc_rv_a + torch.where(c, rv_a, 0.0)
        acc_rv_b = acc_rv_b + torch.where(c, rv_b, 0.0)
        tot_rot = tot_rot + torch.where(c, imp, 0.0)

    # 1. Alignment: full orientation lock (fixed, prismatic), hinge axes
    #    (revolute).
    qd_a, qd_b = cur()
    full = quat_m.mul(quat_m.mul(d[:, ki.ROTD:ki.ROTD + 4], qd_a), quat_m.conj(qd_b))[:, :3] * -2.0
    a1 = quat_m.rotate(qd_a, d[:, ki.AXA:ki.AXA + 3])
    a2 = quat_m.rotate(qd_b, d[:, ki.AXB:ki.AXB + 3])
    hinge = vec.cross(a1, a2)
    diff = torch.where((is_fixed | is_prismatic)[:, None], full,
                       torch.where(is_revolute[:, None], hinge, 0.0))
    on = is_fixed | is_prismatic | is_revolute
    add(on, *_angular_correction(d, diff, comp[:, 1], hh, on))

    # 2. Angle limits: about the hinge (revolute), swing (spherical).
    qd_a, qd_b = cur()
    a1 = quat_m.rotate(qd_a, d[:, ki.AXA:ki.AXA + 3])
    a2 = quat_m.rotate(qd_b, d[:, ki.AXB:ki.AXB + 3])
    b1 = quat_m.rotate(qd_a, d[:, ki.SECA:ki.SECA + 3])
    b2 = quat_m.rotate(qd_b, d[:, ki.SECB:ki.SECB + 3])
    corr_rev, viol_rev = _angle_limit(a1, b1, b2, lmin, lmax, len_)
    n_sw = vec.normalize_or(vec.cross(a1, a2), x_axis)
    corr_sph, viol_sph = _angle_limit(n_sw, a1, a2, lmin, lmax, len_)
    corr = torch.where(is_revolute[:, None], corr_rev,
                       torch.where(is_spherical[:, None], corr_sph, 0.0))
    on = (is_revolute & viol_rev) | (is_spherical & viol_sph)
    add(on, *_angular_correction(d, corr, comp[:, 2], hh, on))

    # 2b. Spherical twist about n = normalize(a1 + a2).
    qd_a, qd_b = cur()
    a1 = quat_m.rotate(qd_a, d[:, ki.AXA:ki.AXA + 3])
    a2 = quat_m.rotate(qd_b, d[:, ki.AXB:ki.AXB + 3])
    b1 = quat_m.rotate(qd_a, d[:, ki.SECA:ki.SECA + 3])
    b2 = quat_m.rotate(qd_b, d[:, ki.SECB:ki.SECB + 3])
    n_tw = vec.normalize_or(a1 + a2, x_axis)
    n1 = vec.normalize_or(b1 - n_tw * vec.dot(n_tw, b1)[:, None], x_axis)
    n2 = vec.normalize_or(b2 - n_tw * vec.dot(n_tw, b2)[:, None], x_axis)
    corr_tw, viol_tw = _angle_limit(n_tw, n1, n2, d[:, ki.TMIN], d[:, ki.TMAX], d[:, ki.TEN] > 0.0)
    on = is_spherical & viol_tw
    add(on, *_angular_correction(d, torch.where(on[:, None], corr_tw, 0.0), comp[:, 3], hh, on))

    # 3. Positional correction at the anchors.
    qd_a, qd_b = cur()
    r1 = quat_m.rotate(qd_a, d[:, ki.R1:ki.R1 + 3])
    r2 = quat_m.rotate(qd_b, d[:, ki.R2:ki.R2 + 3])
    sep = ((dp_b + acc_dp_b) - (dp_a + acc_dp_a)) + (r2 - r1) + d[:, ki.CD:ki.CD + 3]
    dist = vec.length(sep)
    dir_ = sep / torch.clamp(dist, min=1e-9)[:, None]
    dist_corr = torch.where(
        (dist < lmin)[:, None], -dir_ * (lmin - dist)[:, None],
        torch.where((dist > lmax)[:, None], dir_ * (dist - lmax)[:, None], 0.0),
    )
    axis1 = quat_m.rotate(qd_a, d[:, ki.AXA:ki.AXA + 3])
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
    w_r1 = quat_m.rotate(quat_m.from_scaled_axis(acc_rv_a), d[:, ki.R1:ki.R1 + 3])
    w_r2 = quat_m.rotate(quat_m.from_scaled_axis(acc_rv_b), d[:, ki.R2:ki.R2 + 3])
    c = vec.length(correction)
    ok = c > 1e-9
    dir_ = -correction / torch.clamp(c, min=1e-9)[:, None]
    r1 = quat_m.rotate(qd_a, w_r1)
    r2 = quat_m.rotate(qd_b, w_r2)
    iia, iib = d[:, ki.IIA:ki.IIA + 6], d[:, ki.IIB:ki.IIB + 6]
    r1xn = vec.cross(r1, dir_)
    r2xn = vec.cross(r2, dir_)
    w1 = d[:, ki.IMA] + vec.dot(r1xn, sym3.mv(iia, r1xn))
    w2 = d[:, ki.IMB] + vec.dot(r2xn, sym3.mv(iib, r2xn))
    w_sum = w1 + w2
    tilde = comp[:, 0] / hh
    dl = torch.where(ok & (w_sum > 1e-12), -c / torch.clamp(w_sum + tilde, min=1e-12), 0.0)
    impulse = dl[:, None] * dir_
    acc_dp_a = acc_dp_a + impulse * d[:, ki.IMVA:ki.IMVA + 3]
    acc_dp_b = acc_dp_b + -impulse * d[:, ki.IMVB:ki.IMVB + 3]
    acc_rv_a = acc_rv_a + sym3.mv(iia, vec.cross(r1, impulse))
    acc_rv_b = acc_rv_b + -sym3.mv(iib, vec.cross(r2, impulse))
    tot_pos = tot_pos + impulse
    return acc_dp_a, acc_dp_b, acc_rv_a, acc_rv_b, torch.cat([tot_pos, tot_rot], dim=-1)
