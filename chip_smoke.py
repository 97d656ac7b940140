"""Smoke run of the PyTorch/CUDA port (``avian_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written kernels from ``avian_tpu_torch/csrc``, holds each
kernel against its plain PyTorch twin at the main path's shapes, steps the
``stack3`` golden scene against ``tests/golden/stack3.npz``, drives the main
path (a 10,000-cube pile with 160,000 contact slots) for 180 steps through
``physics_step`` and checks that every kernel carried it, and checks that
two runs are bitwise equal. Each phase prints one line; the line before the
last is a JSON object with each kernel's launches, error and times, and the
last line is ``{"ok": true, "device": {...}}``. Any failure raises, and the
script exits non-zero without that line. It needs a CUDA card; it imports
nothing of JAX.
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from avian_tpu_torch import kernels, scenes
from avian_tpu_torch.core.config import PhysicsConfig
from avian_tpu_torch.core.types import BodyType, ShapeType
from avian_tpu_torch.kernels import box_manifold as ka
from avian_tpu_torch.kernels import build
from avian_tpu_torch.kernels import grid_sweep as kb
from avian_tpu_torch.kernels import integrate_bodies as kc
from avian_tpu_torch.kernels import solve_color as kd
from avian_tpu_torch.pipeline import broadphase as bp_m
from avian_tpu_torch.pipeline import solver as sol_m
from avian_tpu_torch.pipeline.step import physics_step, prepare_step
from avian_tpu_torch.geometry.narrowphase import manifold_buckets
from avian_tpu_torch.pipeline.broadphase import update_collider_poses

ROOT = os.path.dirname(os.path.abspath(__file__))
N_CUBES = 10_000
CONTACTS_PER_CUBE = 16
SETTLE_STEPS = 60
TIMED_STEPS = 120
DETERMINISM_CUBES, DETERMINISM_STEPS = 1000, 60
PILE_CONFIG = PhysicsConfig(
    substeps=4, shape_pairs=((ShapeType.BOX, ShapeType.BOX), (ShapeType.BOX, ShapeType.PLANE))
)
GOLDEN_CONFIG = PhysicsConfig(dt=1.0 / 64.0, max_colors=8)
GOLDEN_STEPS, GOLDEN_STRIDE, GOLDEN_TOL = 500, 10, 1e-3
TOL_A, TOL_C_REL, TOL_D = 1e-5, 1e-6, 1e-5

REPLACES = {
    "box_manifold": ("cuda", "avian_tpu_torch/csrc/box_manifold.cu",
                     "avian_tpu/geometry/box_box.py:28"),
    "grid_sweep": ("cuda", "avian_tpu_torch/csrc/grid_sweep.cu",
                   "avian_tpu/pipeline/broadphase.py:179"),
    "integrate_bodies": ("triton", "avian_tpu_torch/kernels/integrate_bodies_triton.py",
                         "avian_tpu/pipeline/integrator.py:97"),
    "solve_color": ("cuda", "avian_tpu_torch/csrc/solve_color.cu",
                    "avian_tpu/pipeline/solver.py:451"),
}


def say(phase, text):
    print(f"[{phase}] {text}", flush=True)


def cuda_ms(fn, reps=10):
    """Mean milliseconds of ``fn()`` on the card, by CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def pile(n_cubes, device):
    world, _ = scenes.cube_pile(
        n_cubes, max_contacts=CONTACTS_PER_CUBE * n_cubes, device=device
    )
    return world


def bouncing(world):
    """The same world with restitution 0.7 on every collider and every
    dynamic body awake and moving down at 3 m/s, so that Kernel D's
    restitution mode acts (the pile's colliders have restitution 0)."""
    b = world.bodies
    down = torch.tensor([0.0, -3.0, 0.0], device=b.lin_vel.device)
    dyn = (b.body_type == BodyType.DYNAMIC)[:, None]
    return world.replace(
        bodies=b.replace(lin_vel=b.lin_vel + down * dyn, sleeping=torch.zeros_like(b.sleeping)),
        colliders=world.colliders.replace(
            restitution=torch.full_like(world.colliders.restitution, 0.7)
        ),
    )


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("device", f"{smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    return smi


def phase_build():
    t0 = time.perf_counter()
    build.library()
    seconds = time.perf_counter() - t0
    log = build.lib_path().with_suffix(".log")
    regs = [ln.split(":", 1)[1].strip() for ln in log.read_text().splitlines()
            if "registers" in ln] if log.exists() else []
    say("build", f"{seconds:.1f} s, {build.lib_path().name}; ptxas: {' | '.join(regs)}")


def solve_all_modes(p, config):
    """Kernel D and its twin through one pass of every color in each mode,
    each mode from the same state; returns the max abs difference and the
    kernel's impulses before and after the restitution pass."""
    con = p.con
    params = sol_m.solve_params(config)
    state_k = kc.integrate_bodies(p.s.state, p.table, config.substep_dt, kc.VELOCITIES).clone()
    imp_k = con.imp.clone()
    err = 0.0
    for mode in (kd.WARM, kd.BIAS, kd.RELAX, kd.RESTITUTION):
        state_t, imp_t, before = state_k.clone(), imp_k.clone(), imp_k.clone()
        for c in range(con.data.shape[0]):
            kd.solve_color(mode, c, state_k, con.data, imp_k, con.bucket_a, con.bucket_b,
                           con.bucket_valid, con.relax, con.ovf_order, con.ovf_key, params)
            kd.solve_color_twin(mode, c, state_t, con.data, imp_t, con.bucket_a,
                                con.bucket_b, con.bucket_valid, con.relax, params)
        err = max(err, float((state_k[:, :6] - state_t[:, :6]).abs().max()),
                  float((imp_k - imp_t).abs().max()))
    return err, before, imp_k


def phase_kernels(device):
    """Each kernel against its twin on the same inputs, taken from the pile
    after ``SETTLE_STEPS`` steps. Returns {name: {max_abs_err, ms, plain_ms}}."""
    config = PILE_CONFIG
    world = pile(N_CUBES, device)
    for _ in range(SETTLE_STEPS):
        world = physics_step(world, config)
    torch.cuda.synchronize()
    out = {}

    # --- B: grid sweep ----------------------------------------------------
    w2 = bp_m.update_aabbs(world, config)
    g = bp_m.grid_entries(w2, config)
    args = (g.skey, g.sf, g.si, g.window)
    bk, rk = kb.grid_sweep(*args)
    bt, rt = kb.grid_sweep_twin(*args)
    if not (torch.equal(bk, bt) and torch.equal(rk, rt)):
        raise AssertionError("grid_sweep: bitmask or run rank differs from the twin")
    out["grid_sweep"] = dict(
        max_abs_err=0.0,
        ms=cuda_ms(lambda: kb.grid_sweep(*args)),
        plain_ms=cuda_ms(lambda: kb.grid_sweep_twin(*args)),
    )

    # --- A: box manifolds -------------------------------------------------
    bp = bp_m.broad_phase(w2, config)
    col = w2.colliders
    pos, quat = update_collider_poses(w2)
    buckets = manifold_buckets(col.shape_type, col.params, pos, quat,
                               bp.collider_a, bp.collider_b, bp.valid,
                               config.shape_pairs)
    err_a = 0.0
    for bkt in buckets:
        rk_ = ka.box_manifold(bkt.kind, *bkt.inputs)
        rt_ = ka.box_manifold_twin(bkt.kind, *bkt.inputs)
        if not (torch.equal(rk_[4], rt_[4]) and torch.equal(rk_[5], rt_[5])):
            raise AssertionError(f"box_manifold kind {bkt.kind}: feature ids or counts differ")
        for x, y in zip(rk_[:4], rt_[:4]):
            err_a = max(err_a, float((x - y).abs().max()))
    if err_a > TOL_A:
        raise AssertionError(f"box_manifold: max abs err {err_a} > {TOL_A}")

    def run_a(fn):
        for bkt in buckets:
            fn(bkt.kind, *bkt.inputs)

    out["box_manifold"] = dict(
        max_abs_err=err_a,
        ms=cuda_ms(lambda: run_a(ka.box_manifold)),
        plain_ms=cuda_ms(lambda: run_a(ka.box_manifold_twin)),
    )

    # --- C and D on this step's prepared solver inputs --------------------
    p = prepare_step(world, config)
    h = config.substep_dt
    st = p.s.state
    err_c = rel_c = 0.0
    for mode in (kc.VELOCITIES, kc.POSITIONS):
        k_out = kc.integrate_bodies(st, p.table, h, mode)
        t_out = kc.integrate_bodies_twin(st, p.table, h, mode)
        # Relative to the largest magnitude of each quantity (velocities,
        # angular velocities, delta positions, delta rotations).
        for lo, hi in ((0, 3), (3, 6), (6, 9), (9, 13)):
            ref = t_out[:, lo:hi]
            diff = float((k_out[:, lo:hi] - ref).abs().max())
            err_c = max(err_c, diff)
            rel_c = max(rel_c, diff / max(float(ref.abs().max()), 1e-30))
        st = k_out
    if rel_c > TOL_C_REL:
        raise AssertionError(f"integrate_bodies: relative err {rel_c} > {TOL_C_REL}")

    def run_c(fn):
        s1 = fn(p.s.state, p.table, h, kc.VELOCITIES)
        fn(s1, p.table, h, kc.POSITIONS)

    out["integrate_bodies"] = dict(
        max_abs_err=err_c,
        ms=cuda_ms(lambda: run_c(kc.integrate_bodies)),
        plain_ms=cuda_ms(lambda: run_c(kc.integrate_bodies_twin)),
    )

    err_d, _, _ = solve_all_modes(p, config)
    # Restitution acts only where it is on and contacts approach fast.
    err_bounce, before, after = solve_all_modes(prepare_step(bouncing(world), config), config)
    bounced = int((after[..., :4] != before[..., :4]).any(-1).sum())
    if bounced == 0:
        raise AssertionError("solve_color: restitution changed no impulse on the bouncing pile")
    err_d = max(err_d, err_bounce)
    if err_d > TOL_D:
        raise AssertionError(f"solve_color: max abs err {err_d} > {TOL_D}")

    con = p.con
    params = sol_m.solve_params(config)
    colors = con.data.shape[0]
    state_k = kc.integrate_bodies(p.s.state, p.table, h, kc.VELOCITIES)
    imp_k = con.imp

    def run_d(fn, twin):
        s1, i1 = state_k.clone(), imp_k.clone()

        def go():
            for c in range(colors):
                if twin:
                    fn(kd.BIAS, c, s1, con.data, i1, con.bucket_a, con.bucket_b,
                       con.bucket_valid, con.relax, params)
                else:
                    fn(kd.BIAS, c, s1, con.data, i1, con.bucket_a, con.bucket_b,
                       con.bucket_valid, con.relax, con.ovf_order, con.ovf_key, params)
        return go

    out["solve_color"] = dict(
        max_abs_err=err_d,
        ms=cuda_ms(run_d(kd.solve_color, False)),
        plain_ms=cuda_ms(run_d(kd.solve_color_twin, True)),
    )
    torch.cuda.synchronize()
    say("kernels", "; ".join(
        f"{k} err {v['max_abs_err']:.3g} kernel {v['ms']:.4f} ms twin {v['plain_ms']:.4f} ms"
        for k, v in out.items()
    ) + f" (pile {N_CUBES} after {SETTLE_STEPS} steps, {int(bp.num_pairs)} pairs; "
        f"restitution changed {bounced} rows of the bouncing pile)")
    return out


def phase_golden(device):
    golden = np.load(os.path.join(ROOT, "tests", "golden", "stack3.npz"))
    world, _ = scenes.stack3(device=device)
    frames = []
    for i in range(GOLDEN_STEPS):
        world = physics_step(world, GOLDEN_CONFIG)
        if (i + 1) % GOLDEN_STRIDE == 0:
            frames.append(world.bodies.pos.cpu().numpy())
    got = np.stack(frames)
    ref = golden["pos"][: got.shape[0]]
    drift = float(np.abs(got - ref).max())
    if not drift <= GOLDEN_TOL:
        raise AssertionError(f"stack3: drift {drift} > {GOLDEN_TOL} from the golden")
    say("golden", f"stack3 {GOLDEN_STEPS} steps, {got.shape[0]} frames, max drift {drift:.3g} "
        f"(limit {GOLDEN_TOL})")


def phase_main_path(device, smi):
    """The main path through ``physics_step``; returns the launch counts."""
    config, n_cubes, settle, timed = PILE_CONFIG, N_CUBES, SETTLE_STEPS, TIMED_STEPS
    world = pile(n_cubes, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0_sim = float(world.time)
    max_dropped = max_overflow = 0
    expect = dict.fromkeys(kernels.WRAPPERS, 0)
    colors = config.max_colors
    full_s, timed_s, timed_full = [], [], 0
    for i in range(settle + timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        world, diag = physics_step(world, config, return_diagnostics=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if diag["stepped"]:
            full_s.append(dt)
        if i >= settle:
            timed_s.append(dt)
            timed_full += int(diag["stepped"])
        max_dropped = max(max_dropped, int(diag["dropped_pairs"]))
        max_overflow = max(max_overflow, int(diag["overflow_dropped"]))
        if diag["stepped"]:
            expect["box_manifold"] += sum(1 for n in diag["manifold_pairs"].values() if n)
            expect["grid_sweep"] += 1
            expect["integrate_bodies"] += 2 * config.substeps
            expect["solve_color"] += (
                config.substeps * 3 * colors + config.solver.restitution_iterations * colors
            )
    got = kernels.launches()
    peak = torch.cuda.max_memory_allocated()

    b = world.bodies
    for name in ("pos", "quat", "lin_vel", "ang_vel"):
        if not bool(torch.isfinite(getattr(b, name)).all()):
            raise AssertionError(f"main path: non-finite {name}")
    if bool(world.diverged):
        raise AssertionError("main path: world diverged")
    if max_dropped or max_overflow:
        raise AssertionError(
            f"main path: dropped pairs {max_dropped}, overflow drops {max_overflow}"
        )
    steps = settle + timed
    sim = float(world.time) - t0_sim
    if not math.isclose(sim, steps * config.dt, rel_tol=1e-4):
        raise AssertionError(f"main path: sim time {sim} != {steps} * dt")
    if got != expect:
        raise AssertionError(f"main path: launches {got} != expected {expect}")
    if min(got.values()) == 0:
        raise AssertionError(f"main path: a kernel never launched: {got}")
    # A full step runs the whole pipeline; once the pile sleeps the
    # early-out skips the rest, so both rates are reported.
    full_ms = 1e3 * sum(full_s) / len(full_s)
    timed_ms = 1e3 * sum(timed_s) / len(timed_s)
    say("main", f"pile {n_cubes} cubes, {CONTACTS_PER_CUBE * n_cubes} contact slots, "
        f"{steps} steps: {len(full_s)} full steps at {full_ms:.2f} ms/step "
        f"(median {1e3 * sorted(full_s)[len(full_s) // 2]:.2f}), "
        f"{1e3 * n_cubes / full_ms:.0f} body-steps/s per full step; last {timed} steps "
        f"({timed_full} full): {timed_ms:.2f} ms/step, "
        f"{1e3 * n_cubes / timed_ms:.0f} body-steps/s; peak {peak / 2**20:.0f} MiB; "
        f"end: {int(diag['num_sleeping'])} asleep; dropped 0, overflow drops 0; "
        f"launches {got} [{smi}]")
    return got


def phase_determinism(device):
    n_cubes, steps = DETERMINISM_CUBES, DETERMINISM_STEPS
    finals = []
    for _ in range(2):
        world = pile(n_cubes, device)
        for _ in range(steps):
            world = physics_step(world, PILE_CONFIG)
        b = world.bodies
        finals.append([getattr(b, k).cpu() for k in ("pos", "quat", "lin_vel", "ang_vel")])
    for x, y in zip(*finals):
        if not torch.equal(x, y):
            raise AssertionError("determinism: two runs differ")
    say("determinism", f"pile {n_cubes} x {steps} steps twice: pos, quat, lin_vel, "
        "ang_vel bitwise equal")


def main():
    smi = phase_device()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    phase_build()
    measured = phase_kernels(device)
    phase_golden(device)
    launches = phase_main_path(device, smi)
    phase_determinism(device)
    rows = []
    for name, (route, source, replaces) in REPLACES.items():
        rows.append(dict(name=name, route=route, source=source, replaces=replaces,
                         launches=launches[name], **measured[name]))
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
