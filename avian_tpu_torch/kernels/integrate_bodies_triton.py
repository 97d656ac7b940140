"""Triton source of Kernel C (see ``integrate_bodies.py`` for what it
replaces and why it is built this way). This module imports ``triton`` at
the top, so only the launching function imports it, on a machine with a
CUDA card."""

import triton
import triton.language as tl
from triton.language.extra import libdevice


@triton.jit
def _cross(ax, ay, az, bx, by, bz):
    return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx


@triton.jit
def _rotate(ux, uy, uz, w, vx, vy, vz):
    # v + w * t + cross(u, t), t = 2 * cross(u, v)
    tx, ty, tz = _cross(ux, uy, uz, vx, vy, vz)
    tx = tx * 2.0
    ty = ty * 2.0
    tz = tz * 2.0
    cx, cy, cz = _cross(ux, uy, uz, tx, ty, tz)
    return vx + w * tx + cx, vy + w * ty + cy, vz + w * tz + cz


@triton.jit
def _qmul(x1, y1, z1, w1, x2, y2, z2, w2):
    return (
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    )


@triton.jit
def _sym_mv(xx, yy, zz, xy, xz, yz, x, y, z):
    return (
        xx * x + xy * y + xz * z,
        xy * x + yy * y + yz * z,
        xz * x + yz * y + zz * z,
    )


@triton.jit
def _clamp_len(x, y, z, max_len):
    n2 = x * x + y * y + z * z
    scale = tl.where(
        n2 > max_len * max_len,
        tl.div_rn(max_len, tl.sqrt_rn(tl.maximum(n2, 1e-12))),
        1.0,
    )
    return x * scale, y * scale, z * scale


@triton.jit
def integrate_bodies_kernel(
    state_ptr, table_ptr, out_ptr, n, h,
    MODE: tl.constexpr, BLOCK: tl.constexpr,
):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    m = offs < n
    sp = state_ptr + offs * 13
    op = out_ptr + offs * 13
    vx = tl.load(sp + 0, mask=m, other=0.0)
    vy = tl.load(sp + 1, mask=m, other=0.0)
    vz = tl.load(sp + 2, mask=m, other=0.0)
    wx = tl.load(sp + 3, mask=m, other=0.0)
    wy = tl.load(sp + 4, mask=m, other=0.0)
    wz = tl.load(sp + 5, mask=m, other=0.0)
    px = tl.load(sp + 6, mask=m, other=0.0)
    py = tl.load(sp + 7, mask=m, other=0.0)
    pz = tl.load(sp + 8, mask=m, other=0.0)
    qx = tl.load(sp + 9, mask=m, other=0.0)
    qy = tl.load(sp + 10, mask=m, other=0.0)
    qz = tl.load(sp + 11, mask=m, other=0.0)
    qw = tl.load(sp + 12, mask=m, other=1.0)

    if MODE == 0:
        tp = table_ptr + offs * 22
        dyn = tl.load(tp + 8, mask=m, other=0.0) > 0.0
        gyro = dyn & (tl.load(tp + 9, mask=m, other=0.0) > 0.0)
        ld = tl.load(tp + 6, mask=m, other=1.0)
        ad = tl.load(tp + 7, mask=m, other=1.0)
        vx = tl.where(dyn, vx * ld + tl.load(tp + 0, mask=m, other=0.0), vx)
        vy = tl.where(dyn, vy * ld + tl.load(tp + 1, mask=m, other=0.0), vy)
        vz = tl.where(dyn, vz * ld + tl.load(tp + 2, mask=m, other=0.0), vz)
        wx = tl.where(dyn, wx * ad + tl.load(tp + 3, mask=m, other=0.0), wx)
        wy = tl.where(dyn, wy * ad + tl.load(tp + 4, mask=m, other=0.0), wy)
        wz = tl.where(dyn, wz * ad + tl.load(tp + 5, mask=m, other=0.0), wz)

        # Gyroscopic torque in the body frame of rot = dq * body_quat.
        bx = tl.load(tp + 10, mask=m, other=0.0)
        by = tl.load(tp + 11, mask=m, other=0.0)
        bz = tl.load(tp + 12, mask=m, other=0.0)
        bw = tl.load(tp + 13, mask=m, other=1.0)
        rx, ry, rz, rw = _qmul(qx, qy, qz, qw, bx, by, bz, bw)
        ixx = tl.load(tp + 14, mask=m, other=0.0)
        iyy = tl.load(tp + 15, mask=m, other=0.0)
        izz = tl.load(tp + 16, mask=m, other=0.0)
        ixy = tl.load(tp + 17, mask=m, other=0.0)
        ixz = tl.load(tp + 18, mask=m, other=0.0)
        iyz = tl.load(tp + 19, mask=m, other=0.0)
        lwx, lwy, lwz = _rotate(-rx, -ry, -rz, rw, wx, wy, wz)
        ca = iyy * izz - iyz * iyz
        cb = ixx * izz - ixz * ixz
        cc = ixx * iyy - ixy * ixy
        cd = ixz * iyz - ixy * izz
        ce = ixy * iyz - ixz * iyy
        cf = ixy * ixz - ixx * iyz
        det = ixx * ca + ixy * cd + ixz * ce
        inv_det = tl.where(det != 0.0, tl.div_rn(1.0 + 0.0 * det, tl.where(det == 0.0, 1.0, det)), 0.0)
        lmx, lmy, lmz = _sym_mv(
            ca * inv_det, cb * inv_det, cc * inv_det,
            cd * inv_det, ce * inv_det, cf * inv_det, lwx, lwy, lwz,
        )
        cx, cy, cz = _cross(lwx, lwy, lwz, lmx, lmy, lmz)
        nmx = lmx - h * cx
        nmy = lmy - h * cy
        nmz = lmz - h * cz
        new_sq = nmx * nmx + nmy * nmy + nmz * nmz
        old_sq = lmx * lmx + lmy * lmy + lmz * lmz
        scale = tl.where(
            new_sq > 0.0,
            tl.sqrt_rn(tl.div_rn(old_sq, tl.maximum(new_sq, 1e-30))),
            0.0,
        )
        nwx, nwy, nwz = _sym_mv(
            ixx, iyy, izz, ixy, ixz, iyz, nmx * scale, nmy * scale, nmz * scale
        )
        gx, gy, gz = _rotate(rx, ry, rz, rw, nwx, nwy, nwz)
        wx = tl.where(gyro, gx, wx)
        wy = tl.where(gyro, gy, wy)
        wz = tl.where(gyro, gz, wz)

        vx, vy, vz = _clamp_len(vx, vy, vz, tl.load(tp + 20, mask=m, other=1.0))
        wx, wy, wz = _clamp_len(wx, wy, wz, tl.load(tp + 21, mask=m, other=1.0))
    else:
        px = px + vx * h
        py = py + vy * h
        pz = pz + vz * h
        sx = wx * h
        sy = wy * h
        sz = wz * h
        angle_sq = sx * sx + sy * sy + sz * sz
        angle = tl.sqrt_rn(tl.maximum(angle_sq, 1e-30))
        small = angle_sq < 1e-12
        half = 0.5 * angle
        s = tl.where(
            small,
            0.5 - tl.div_rn(angle_sq, angle_sq * 0.0 + 48.0),
            tl.div_rn(libdevice.sin(half), angle),
        )
        w = tl.where(small, 1.0 - angle_sq * 0.125, libdevice.cos(half))
        qx, qy, qz, qw = _qmul(sx * s, sy * s, sz * s, w, qx, qy, qz, qw)

    tl.store(op + 0, vx, mask=m)
    tl.store(op + 1, vy, mask=m)
    tl.store(op + 2, vz, mask=m)
    tl.store(op + 3, wx, mask=m)
    tl.store(op + 4, wy, mask=m)
    tl.store(op + 5, wz, mask=m)
    tl.store(op + 6, px, mask=m)
    tl.store(op + 7, py, mask=m)
    tl.store(op + 8, pz, mask=m)
    tl.store(op + 9, qx, mask=m)
    tl.store(op + 10, qy, mask=m)
    tl.store(op + 11, qz, mask=m)
    tl.store(op + 12, qw, mask=m)
