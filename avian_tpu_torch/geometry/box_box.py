"""Box-box contact manifolds: SAT over 15 axes + incident-face clipping
(port of ``avian_tpu/geometry/box_box.py``).

This is the plain PyTorch form, batched over K pairs: the oracle of Kernel
A (``csrc/box_manifold.cu``), which computes the same thing one thread per
pair. Every argmax/argmin takes the first extremum (as ``jnp.argmax``
does), the epsilons are the reference's (``abs(rb) + 1e-6``, edge bias
0.05 / 1e-4, ``len_e > 1e-6``), and sums are written out in the order the
kernel uses.
"""

import torch

from avian_tpu_torch.math import quat as quat_m
from avian_tpu_torch.math import vec

_EDGE_BIAS_REL = 0.05
_EDGE_BIAS_ABS = 1e-4
P = 8  # polygon slots of the clipper


def _signp(x):
    return torch.where(x >= 0.0, 1.0, -1.0)


def _take(x, idx):
    """x[..., idx] per row: x [K, n], idx [K] -> [K]."""
    return x.gather(-1, idx[:, None]).squeeze(-1)


def _take_rows(x, idx):
    """x[k, idx[k], :] for x [K, n, d], idx [K] -> [K, d]."""
    return x.gather(1, idx[:, None, None].expand(-1, 1, x.shape[-1])).squeeze(1)


def _column(m, j):
    """m[k, :, j[k]] for m [K, 3, 3]."""
    return m.gather(2, j[:, None, None].expand(-1, 3, 1)).squeeze(-1)


def _onehot(i, dev):
    return torch.eye(3, dtype=torch.float32, device=dev)[i]


def _closest_segment_segment(pa, ua, ha, pb, ub, hb):
    """Parameters (s, t) of the closest points between ``pa + ua*s`` and
    ``pb + ub*t`` with s in [-ha, ha], t in [-hb, hb] (Ericson 5.1.9)."""
    r = pa - pb
    b = vec.dot(ua, ub)
    c = vec.dot(ua, r)
    f = vec.dot(ub, r)
    denom = 1.0 - b * b
    s = torch.where(
        denom > 1e-9,
        torch.minimum(
            torch.maximum((b * f - c) / torch.clamp(denom, min=1e-9), -ha), ha
        ),
        0.0,
    )
    t = b * s + f
    t_cl = torch.minimum(torch.maximum(t, -hb), hb)
    s = torch.minimum(torch.maximum(b * t_cl - c, -ha), ha)
    return s, t_cl


def _clip_axis(q, fids, count, axis2, s2, lim, fid_base):
    """Sutherland-Hodgman clip of the [K, P, 3] (u, v, w) polygons against
    ``s2 * q[axis2] <= lim``, emitting in ring order (reference :258)."""
    k_n = q.shape[0]
    dev = q.device
    idx = torch.arange(P, device=dev).expand(k_n, P)
    nxt = torch.where(idx + 1 >= count[:, None], 0, idx + 1)
    cur = q
    nxt_q = q.gather(1, nxt[..., None].expand(-1, -1, 3))
    d_cur = s2 * cur[..., axis2] - lim[:, None]
    d_nxt = s2 * nxt_q[..., axis2] - lim[:, None]
    in_cur = d_cur <= 0.0
    edge_valid = idx < count[:, None]
    crossing = edge_valid & (in_cur != (d_nxt <= 0.0))
    diff = d_cur - d_nxt
    t = d_cur / torch.where(torch.abs(diff) > 1e-12, diff, 1e-12)
    inter = cur + (nxt_q - cur) * torch.clamp(t, 0.0, 1.0)[..., None]

    emit_q = torch.cat([cur, inter], dim=1)
    emit_f = torch.cat([fids, fid_base + idx.to(torch.int32)], dim=1)
    emit_ok = torch.cat([edge_valid & in_cur, crossing], dim=1)
    order_key = torch.cat([2 * idx, 2 * idx + 1], dim=1)
    key = torch.where(emit_ok, order_key, 2 * P + order_key)
    order = torch.argsort(key, dim=1, stable=True)
    out_q = emit_q.gather(1, order[..., None].expand(-1, -1, 3))[:, :P]
    out_f = emit_f.gather(1, order)[:, :P]
    out_count = torch.clamp(emit_ok.sum(dim=1), max=P).to(torch.int32)
    pad = idx >= out_count[:, None]
    out_q = torch.where(pad[..., None], out_q[:, 0:1], out_q)
    return out_q, out_f, out_count


def _face_manifold(r_inc, t_inc, h_ref, h_inc, axis_idx):
    """Clip the incident box's face against the reference box's face
    ``axis_idx`` (reference :154); all in the reference box's frame."""
    k_n = r_inc.shape[0]
    dev = r_inc.device
    sign = _signp(_take(t_inc, axis_idx))
    n_ref = _onehot(axis_idx, dev) * sign[:, None]
    h_axis = _take(h_ref, axis_idx)
    u_r = (axis_idx + 1) % 3
    v_r = (axis_idx + 2) % 3
    hu_r = _take(h_ref, u_r)
    hv_r = _take(h_ref, v_r)

    dots = vec.mtv3(r_inc, n_ref)
    j = torch.argmax(torch.abs(dots), dim=-1)
    sj = -_signp(_take(dots, j))
    ju = (j + 1) % 3
    jv = (j + 2) % 3
    face_center = t_inc + (sj * _take(h_inc, j))[:, None] * _column(r_inc, j)
    b_u = _column(r_inc, ju) * _take(h_inc, ju)[:, None]
    b_v = _column(r_inc, jv) * _take(h_inc, jv)[:, None]
    quad = torch.tensor(
        [[1.0, 1.0], [-1.0, 1.0], [-1.0, -1.0], [1.0, -1.0]], device=dev
    )
    verts4 = (
        face_center[:, None, :]
        + quad[None, :, 0:1] * b_u[:, None, :]
        + quad[None, :, 1:2] * b_v[:, None, :]
    )

    def comp(i):
        return verts4.gather(2, i[:, None, None].expand(-1, 4, 1)).squeeze(-1)

    q4 = torch.stack(
        [comp(u_r), comp(v_r), comp(axis_idx) * sign[:, None]], dim=-1
    )
    q = torch.cat([q4, q4[:, 0:1].expand(-1, 4, -1)], dim=1)
    fids = torch.zeros((k_n, P), dtype=torch.int32, device=dev)
    fids[:, :4] = (
        torch.arange(4, dtype=torch.int32, device=dev)[None, :]
        + 4 * j.to(torch.int32)[:, None]
    )
    count = torch.full((k_n,), 4, dtype=torch.int32, device=dev)
    for k, (axis2, s2, lim) in enumerate(
        [(0, 1.0, hu_r), (0, -1.0, hu_r), (1, 1.0, hv_r), (1, -1.0, hv_r)]
    ):
        q, fids, count = _clip_axis(q, fids, count, axis2, s2, lim, 32 + 8 * k)

    rows = torch.arange(k_n, device=dev)
    valid = torch.arange(P, device=dev)[None, :] < count[:, None]
    seps = torch.where(valid, q[..., 2] - h_axis[:, None], 1e9)
    uv = q[..., :2]
    idx0 = torch.argmin(seps, dim=1)
    p0 = uv[rows, idx0]
    du = uv - p0[:, None, :]
    d2 = torch.where(valid, du[..., 0] * du[..., 0] + du[..., 1] * du[..., 1], -1.0)
    d2[rows, idx0] = -1.0
    idx1 = torch.argmax(d2, dim=1)
    e1 = uv[rows, idx1] - p0
    cr = e1[:, 0:1] * (uv[..., 1] - p0[:, 1:2]) - e1[:, 1:2] * (uv[..., 0] - p0[:, 0:1])
    cr_mask = torch.where(valid, cr, 0.0)
    cr_mask[rows, idx0] = 0.0
    cr_mask[rows, idx1] = 0.0
    idx2 = torch.argmax(cr_mask, dim=1)
    idx3 = torch.argmin(cr_mask, dim=1)

    sel = torch.stack([idx0, idx1, idx2, idx3], dim=1)
    first = torch.stack(
        [
            torch.ones_like(idx0, dtype=torch.bool),
            idx1 != idx0,
            (idx2 != idx0) & (idx2 != idx1),
            (idx3 != idx0) & (idx3 != idx1) & (idx3 != idx2),
        ],
        dim=1,
    )
    ok = first & valid.gather(1, sel)
    out_q = q.gather(1, sel[..., None].expand(-1, -1, 3))
    out_seps = torch.where(ok, seps.gather(1, sel), 1e9)
    out_fids = torch.where(ok, fids.gather(1, sel), 0)
    out_count = ok.sum(dim=1).to(torch.int32)

    out_pts = (
        out_q[..., 0:1] * _onehot(u_r, dev)[:, None, :]
        + out_q[..., 1:2] * _onehot(v_r, dev)[:, None, :]
        + (out_q[..., 2:3] * sign[:, None, None]) * _onehot(axis_idx, dev)[:, None, :]
    )
    ref_pts = out_pts - n_ref[:, None, :] * torch.clamp(out_seps, -1e8, 1e8)[..., None]
    return out_pts, ref_pts, out_seps, out_fids, out_count, n_ref


def box_box(pa, qa, ha, pb, qb, hb):
    """Manifolds of K box pairs, box A (pose pa, qa, half extents ha) vs
    box B. Returns (normal [K,3], point_a [K,4,3], point_b [K,4,3],
    separation [K,4], feature_id i32[K,4], count i32[K])."""
    k_n = pa.shape[0]
    dev = pa.device
    q_rel = quat_m.mul(quat_m.conj(qa), qb)
    rb = quat_m.to_mat3(q_rel)
    t = quat_m.rotate_inv(qa, pb - pa)
    abs_rb = torch.abs(rb) + 1e-6

    sep_a = torch.abs(t) - (ha + vec.mv3(abs_rb, hb))
    t_b = vec.mtv3(rb, t)
    sep_b = torch.abs(t_b) - (vec.mtv3(abs_rb, ha) + hb)

    eye = torch.eye(3, dtype=torch.float32, device=dev)
    rb_t = rb.transpose(1, 2)
    axes_e = vec.cross(eye[None, :, None, :], rb_t[:, None, :, :]).reshape(k_n, 9, 3)
    len_e = vec.length(axes_e)
    valid_e = len_e > 1e-6
    axes_en = axes_e / torch.clamp(len_e, min=1e-6)[..., None]
    proj_a = vec.dot(torch.abs(axes_en), ha[:, None, :])
    axes_dot_b = vec.mtv3(rb[:, None, :, :], axes_en)
    proj_b = vec.dot(torch.abs(axes_dot_b), hb[:, None, :])
    sep_e = torch.abs(vec.dot(axes_en, t[:, None, :])) - (proj_a + proj_b)
    sep_e = torch.where(valid_e, sep_e, -1e9)

    best_face_a = sep_a.amax(dim=-1)
    best_face_b = sep_b.amax(dim=-1)
    best_face = torch.maximum(best_face_a, best_face_b)
    best_edge = sep_e.amax(dim=-1)
    use_edge = best_edge > best_face + torch.clamp(
        _EDGE_BIAS_REL * torch.abs(best_face), min=_EDGE_BIAS_ABS
    )
    ref_on_a = best_face_a >= best_face_b - 1e-6

    # ---- face manifold ------------------------------------------------
    t_in_b = -vec.mtv3(rb, t)
    r1 = ref_on_a[:, None]
    r2 = ref_on_a[:, None, None]
    r_in = torch.where(r2, rb, rb_t)
    t_in = torch.where(r1, t, t_in_b)
    h_ref = torch.where(r1, ha, hb)
    h_inc = torch.where(r1, hb, ha)
    axis_idx = torch.where(
        ref_on_a, torch.argmax(sep_a, dim=-1), torch.argmax(sep_b, dim=-1)
    )
    pts, ref_pts, seps, fids, count, n_local = _face_manifold(
        r_in, t_in, h_ref, h_inc, axis_idx
    )
    rot_q = torch.where(r1, qa, qb)
    origin = torch.where(r1, pa, pb)
    pts_w = origin[:, None, :] + quat_m.rotate(rot_q[:, None, :], pts)
    ref_w = origin[:, None, :] + quat_m.rotate(rot_q[:, None, :], ref_pts)
    n_w = quat_m.rotate(rot_q, n_local)
    normal_face = torch.where(r1, n_w, -n_w)
    point_a_face = torch.where(r2, ref_w, pts_w)
    point_b_face = torch.where(r2, pts_w, ref_w)
    fid_face = torch.where(r1, fids, fids + 64)

    # ---- edge manifold ------------------------------------------------
    e_idx = torch.argmax(sep_e, dim=-1)
    i_idx = e_idx // 3
    j_idx = e_idx % 3
    axis = _take_rows(axes_en, e_idx)
    n_e = axis * _signp(vec.dot(axis, t))[:, None]
    s_a = _signp(n_e) * ha
    lanes = torch.arange(3, device=dev)[None, :]
    ca = torch.where(lanes == i_idx[:, None], 0.0, s_a)
    da = eye[i_idx]
    ha_i = _take(ha, i_idx)
    n_in_b = vec.mtv3(rb, n_e)
    s_b = -_signp(n_in_b) * hb
    cb_local = torch.where(lanes == j_idx[:, None], 0.0, s_b)
    cb = t + vec.mv3(rb, cb_local)
    db = _column(rb, j_idx)
    hb_j = _take(hb, j_idx)
    s_par, t_par = _closest_segment_segment(ca, da, ha_i, cb, db, hb_j)
    pa_e = ca + da * s_par[:, None]
    pb_e = cb + db * t_par[:, None]
    sep_edge_pt = vec.dot(pb_e - pa_e, n_e)

    edge_pa = torch.zeros((k_n, 4, 3), device=dev)
    edge_pb = torch.zeros((k_n, 4, 3), device=dev)
    edge_pa[:, 0] = pa + quat_m.rotate(qa, pa_e)
    edge_pb[:, 0] = pa + quat_m.rotate(qa, pb_e)
    edge_sep = torch.full((k_n, 4), 1e9, device=dev)
    edge_sep[:, 0] = sep_edge_pt
    edge_fid = torch.zeros((k_n, 4), dtype=torch.int32, device=dev)
    edge_fid[:, 0] = 128 + e_idx.to(torch.int32)

    u1 = use_edge[:, None]
    u2 = use_edge[:, None, None]
    return (
        torch.where(u1, quat_m.rotate(qa, n_e), normal_face),
        torch.where(u2, edge_pa, point_a_face),
        torch.where(u2, edge_pb, point_b_face),
        torch.where(u1, edge_sep, seps),
        torch.where(u1, edge_fid, fid_face),
        torch.where(use_edge, 1, count).to(torch.int32),
    )
