"""Build and load the CUDA kernels of ``avian_tpu_torch/csrc``.

At first use, ``library()`` compiles every ``csrc/*.cu`` with ``nvcc`` for
Hopper (``sm_90a``) into one shared library with a plain C interface, under
``build/avian_tpu_torch/`` at the root of the checkout, and loads it with
``ctypes``. The file name carries a hash of the sources and flags, so a
change to a source rebuilds. A failed build raises; there is no fallback.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "avian_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "avian_box_manifold": [_I, _I] + [_P] * 12 + [_P],
    "avian_grid_sweep": [_P] * 5 + [_I, _I, _P],
    "avian_solve_color": [_I] * 5 + [_P] * 10 + [_F] * 5 + [_P],
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


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = lib_path()
    if not path.exists():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, path)
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
