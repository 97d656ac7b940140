"""Build and load the CUDA kernels of ``avian_tpu_torch/csrc``.

At first use, ``library()`` compiles every ``csrc/*.cu`` with ``nvcc`` for
Hopper (``sm_90a``), one ``nvcc`` process per source and all at once, links
the objects into one shared library with a plain C interface under
``build/avian_tpu_torch/`` at the root of the checkout, and loads it with
``ctypes``. The file name carries a hash of the sources and flags, so a
change to a source rebuilds. A failed build raises; there is no fallback.

``launch`` calls one entry point on PyTorch's current stream, ``require``
is the wrappers' check of device, dtype, shape and contiguity, and
``launch_manifold`` is the common launch of the narrowphase's pair kernels
(A, M, N, O, P, Q). Kernels R, S and AI instantiate the device code of all
of those for every canonical pair (``csrc/pair_dispatch.cuh``), split over
three translation units each so that no one ``nvcc`` holds up the build;
S's overlap and manifold modes are a flag of the same instances.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "avian_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "avian_box_manifold": [_I, _I] + [_P] * 12 + [_P],
    # Kernels N, M, O
    "avian_round_manifold": [_I, _I] + [_P] * 12 + [_P],
    "avian_convex_manifold": [_I, _I] + [_P] * 13 + [_P],
    "avian_plane_patch_manifold": [_I, _I] + [_P] * 13 + [_P],
    # Kernels P, Q
    "avian_hull_manifold": [_I, _I] + [_P] * 14 + [_P],
    "avian_plane_hull_manifold": [_I, _I] + [_P] * 13 + [_P],
    # Kernels R, S (one entry point per group of canonical pairs) and T
    **{f"avian_swept_toi_{g}": [_I] * 3 + [_P] * 18 + [_P]
       for g in ("analytic", "generic", "hull")},
    **{f"avian_shape_cast_{g}": [_I] * 4 + [_P] * 14 + [_P]
       for g in ("analytic", "generic", "hull")},
    # Kernel AI (one entry point per group of canonical pairs)
    **{f"avian_toi_pair_{g}": [_I] * 3 + [_P] * 16 + [_P]
       for g in ("analytic", "generic", "hull")},
    "avian_ray_cast": [_I] * 4 + [_P] * 2 + [_I] + [_P] * 6 + [_P],
    "avian_grid_sweep": [_P] * 5 + [_I, _I, _P],
    "avian_solve_color": [_I] * 5 + [_P] * 10 + [_F] * 5 + [_P],
    # Kernel E
    "avian_collider_aabbs": [_I] + [_P] * 10 + [_F] * 3 + [_P] * 4 + [_P],
    "avian_cell_keys": [_I, _I] + [_P] * 12 + [_P],
    # Kernel F
    "avian_contact_join": [_I] + [_P] * 4 + [_P],
    "avian_contact_rows": [_I] + [_P] * 35 + [_F] * 4 + [_I] + [_P] * 21 + [_P],
    # Kernel G
    "avian_run_rank": [_I] + [_P] * 2 + [_P],
    "avian_color_keys": [_I, _I] + [_P] * 6 + [_P],
    "avian_color_rows": [_I] * 4 + [_P] * 5 + [_P],
    "avian_color_init": [_I, _I, _I] + [_P] * 8 + [_P],
    "avian_color_propose": [_I, _I] + [_P] * 8 + [_P],
    "avian_color_win": [_I, _I] + [_P] * 8 + [_P],
    "avian_color_finish": [_I, _I] + [_P] * 4 + [_P],
    "avian_bucket_slots": [_I] * 3 + [_P] * 5 + [_P],
    # Kernel H
    "avian_pack_flags": [_I] + [_P] * 12 + [_P],
    "avian_pack_count": [_I] + [_P] * 7 + [_P],
    "avian_pack_rows": [_I] * 2 + [_P] * 30 + [_F] * 6 + [_P],
    # Kernel I
    "avian_joint_color": [_I] * 4 + [_P] * 11 + [_F] + [_P],
    "avian_joint_velocities": [_I] * 2 + [_P] * 9 + [_F] + [_P],
    "avian_joint_rows": [_I] + [_P] * 26 + [_P],
    # Kernel J
    "avian_island_table": [_I] * 2 + [_P] * 6 + [_P],
    "avian_island_labels": [_I] * 2 + [_P] * 3 + [_P],
    "avian_sleep_update": [_I] + [_P] * 20 + [_F] * 4 + [_P],
    "avian_sleep_update_2d": [_I] + [_P] * 14 + [_F] * 4 + [_P],
    # Kernel K
    "avian_prepare_bodies": [_I, _I] + [_P] * 31 + [_F] + [_P],
    "avian_writeback_bodies": [_I] + [_P] * 15 + [_P],
    "avian_writeback_2d": [_I] + [_P] * 15 + [_P],
    # Kernel L
    "avian_pair_counts": [_I] * 5 + [_P] * 16 + [_P],
    "avian_pair_slots": [_I] * 5 + [_P] * 9 + [_P],
    "avian_pair_finish": [_I] * 7 + [_P] * 14 + [_P],
    # Kernels U-Z of the 2D engine
    "avian_grid_counts_2d": [_I] * 4 + [_P] * 17 + [_P],
    "avian_manifold_2d": [_I] + [_P] * 14 + [_P],
    "avian_contact_rows_2d": [_I] + [_P] * 36 + [_F] * 4 + [_I] + [_P] * 21 + [_P],
    "avian_pack_count_2d": [_I] + [_P] * 7 + [_P],
    "avian_pack_rows_2d": [_I] * 2 + [_P] * 24 + [_P] * 6 + [_F] * 6 + [_P],
    "avian_solve_2d": [_I] * 5 + [_P] * 10 + [_F] * 5 + [_P],
    "avian_integrate_2d": [_I] * 2 + [_P] * 3 + [_F] + [_P],
    "avian_prepare_2d": [_I] + [_P] * 23 + [_F] + [_P],
    # Kernels AA and AB of the 2D engine
    "avian_joint_rows_2d": [_I] + [_P] * 24 + [_P],
    "avian_joint_color_2d": [_I] * 4 + [_P] * 11 + [_F] + [_P],
    "avian_joint_velocities_2d": [_I] * 2 + [_P] * 9 + [_F] + [_P],
    "avian_swept_toi_2d": [_I] * 2 + [_P] * 19 + [_P],
    # Kernels AC, AD and AE of the 2D queries
    "avian_ray_cast_2d": [_I, _I, _P, _I] + [_P] * 8 + [_P],
    "avian_point_2d": [_I, _I] + [_P] * 9 + [_P],
    "avian_shape_cast_2d": [_I, _I] + [_P] * 18 + [_P],
    # Kernels AF, AG and AH of the 3D queries
    "avian_point_3d": [_I] * 4 + [_P] * 10 + [_P],
    "avian_ray_cast_grid": [_I] * 5 + [_P] * 18 + [_P],
    "avian_aabb_overlap": [_I] * 2 + [_P] * 6 + [_P],
}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def lib_path() -> Path:
    """Where the library for the current sources lives; the ``nvcc`` log
    of its build (registers, spills) is beside it with suffix ``.log``."""
    return BUILD_DIR / f"libavian_kernels_{_digest()}.so"


def _run_all(cmds) -> str:
    """Run the commands at once; returns their output, raises on a failure."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    log = ""
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            for other in procs:
                if other.poll() is None:
                    other.kill()
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
        log += out
    return log


def _build(path: Path) -> None:
    nvcc = _nvcc()
    tag = f"{path.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    log = _run_all([
        [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        for obj, src in zip(objs, sources())
    ])
    tmp = BUILD_DIR / f"{tag}.tmp"
    log += _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    for obj in objs:
        obj.unlink()
    path.with_suffix(".log").write_text(log)
    os.replace(tmp, path)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = lib_path()
    if not path.exists():
        _build(path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def require(what: str, device: torch.device, rows) -> None:
    """Raise unless every ``(name, tensor, shape, dtype)`` of ``rows`` is a
    contiguous tensor of that shape and dtype on ``device``."""
    for name, x, shape, dtype in rows:
        if x.device != device or x.dtype != dtype:
            raise TypeError(
                f"{what}: {name} must be {dtype} on {device}, got {x.dtype} on {x.device}"
            )
        if tuple(x.shape) != tuple(shape) or not x.is_contiguous():
            raise ValueError(
                f"{what}: {name} must be contiguous {tuple(shape)}, got {tuple(x.shape)}"
            )


def launch(name: str, device: torch.device, *args) -> None:
    """Call entry point ``name`` (which launches one kernel) on the current
    stream of ``device``. Tensors pass as device pointers, Python ints and
    floats as C ``int`` and ``float``; a launch the card refuses raises."""
    fn = getattr(library(), name)
    if len(args) + 1 != len(fn.argtypes):
        raise TypeError(f"{name}: {len(args)} arguments for {len(fn.argtypes) - 1}")
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]  # None: NULL
    with torch.cuda.device(device):
        err = fn(*conv, torch.cuda.current_stream().cuda_stream)
    check(err, name)


def launch_manifold(name, kind, inputs, *tables, prm_width=3):
    """Launch pair kernel ``name`` of ``kind`` on the K pairs ``inputs`` =
    (pa, qa, prm_a, pb, qb, prm_b), contiguous f32 [K, 3] / [K, 4] (params
    [K, ``prm_width``]) on one card; ``tables`` are extra f32 device arrays
    passed after the outputs. Returns
    (normal f32[K,3], point_a f32[K,4,3], point_b f32[K,4,3], separation
    f32[K,4], feature_id i32[K,4], count i32[K])."""
    pa = inputs[0]
    dev, k_n = pa.device, pa.shape[0]
    f32 = torch.float32
    w = prm_width
    require(name, dev, [(n, x, (k_n, c), f32) for n, x, c in zip(
        ("pa", "qa", "prm_a", "pb", "qb", "prm_b"), inputs, (3, 4, w, 3, 4, w))])
    out = (
        torch.empty((k_n, 3), dtype=f32, device=dev),
        torch.empty((k_n, 4, 3), dtype=f32, device=dev),
        torch.empty((k_n, 4, 3), dtype=f32, device=dev),
        torch.empty((k_n, 4), dtype=f32, device=dev),
        torch.empty((k_n, 4), dtype=torch.int32, device=dev),
        torch.empty((k_n,), dtype=torch.int32, device=dev),
    )
    if k_n:
        launch(name, dev, kind, k_n, *inputs, *out, *tables)
    return out
