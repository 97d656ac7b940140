"""Build and load the kernels of a world's custom shapes.

On first use of a tuple of ``CustomShape``s on the card, ``library(shapes)``
writes two translation units that include ``csrc/custom_shape.cuh``, wrap
each shape's ``cuda`` source in a namespace of its own and specialise the
device support, AABB and patch on the shape's code ``16 + i``; it compiles
them with ``build.py``'s ``NVCC_FLAGS`` (``sm_90a``, ``-fmad=false``), one
``nvcc`` each and both at once, links them into one shared library under
``build/avian_tpu_torch/`` whose file name hashes the sources, and loads it
with ``ctypes``:

- ``builtin``: Kernel M's instances of each custom shape against the
  built-in support shapes (sphere, capsule, box, cylinder, cone, segment);
- ``other``: M's custom-custom instances, P's (a pool-backed convex shape
  against a custom shape), O's (a half-space against one), Kernel E's custom
  pass, Kernel AJ and Kernel AF's custom instance.

A shape without ``cuda`` source, and a failed build, raise naming the
shapes; there is no fallback to the plain versions.
"""

import ctypes
import hashlib
import os
from pathlib import Path

import torch

from avian_tpu_torch.core.types import CUSTOM_SHAPE_BASE, ShapeType
from avian_tpu_torch.geometry import narrowphase
from avian_tpu_torch.kernels import build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PAIR = [_I] * 3 + [_P] * 14 + [_P]
_SIGNATURES = {
    "avian_custom_pair_builtin": _PAIR,
    "avian_custom_pair_other": _PAIR,
    "avian_custom_plane": [_I] * 2 + [_P] * 14 + [_P],
    "avian_custom_aabbs": [_I] * 2 + [_P] * 8 + [_F] * 3 + [_P] * 2 + [_P],
    "avian_ray_support": [_I] * 4 + [_P] * 2 + [_I] + [_P] * 6 + [_P],
    "avian_custom_point": [_I] * 4 + [_P] * 8 + [_P],
}

_PAIR_ARGS = ("int n, const float* pa, const float* qa, const float* prm_a, const float* pb, "
              "const float* qb, const float* prm_b, float* normal, float* point_a, "
              "float* point_b, float* sep, int* fid, int* count, const float* disc, "
              "const float* pool, void* stream")
_PAIR_CALL = ("n, pa, qa, prm_a, pb, qb, prm_b, normal, point_a, point_b, sep, fid, count, "
              "disc, pool")


def pair_instances(shapes):
    """{unit: the canonical pairs (type_a, type_b) of Kernel M and P's custom
    instances it instantiates}: ``narrowphase.pair_kernels``' custom pairs,
    those of a built-in support shape in ``builtin`` and the rest in
    ``other``; O's (a half-space) have an entry of their own."""
    table = narrowphase.pair_kernels(shapes)
    pairs = [p for p in table if p[1] >= CUSTOM_SHAPE_BASE and p[0] != int(ShapeType.PLANE)]
    builtin = [p for p in pairs if table[p][1] == "custom_convex_manifold"
               and p[0] < CUSTOM_SHAPE_BASE]
    return {"builtin": builtin, "other": [p for p in pairs if p not in builtin]}


def _cases(kernel, keys, call, key_of):
    return "\n".join(
        f"    case {key_of(k)}: return launch_1d({kernel(k)}, total, 64, stream, {call});"
        for k in keys)


def unit_source(shapes, unit):
    """The CUDA source of generated unit ``unit`` for ``shapes``."""
    codes = [CUSTOM_SHAPE_BASE + i for i in range(len(shapes))]
    parts = [
        f"// Generated by avian_tpu_torch/kernels/custom_build.py, unit '{unit}', for the "
        f"custom shapes {', '.join(repr(s.name) for s in shapes)}.",
        f"#define AVIAN_CUSTOM_SHAPE_BASE {CUSTOM_SHAPE_BASE}",
        '#include "custom_shape.cuh"',
    ]
    for code, s in zip(codes, shapes):
        ns = f"avian_user_{code - CUSTOM_SHAPE_BASE}"
        parts.append(f"namespace {{\nnamespace {ns} {{\n// ---- {s.name}\n{s.cuda}\n}}\n}}")
        patch = f"{ns}::patch" if s.patch is not None else f"point_patch<{code}>"
        parts.append(f"AVIAN_CUSTOM_SHAPE({code}, {ns}, {patch})")
    pairs = pair_instances(shapes)[unit]
    parts.append(f"""
extern "C" int avian_custom_pair_{unit}(int ta, int tb, {_PAIR_ARGS}) {{
  long long total = n;
  switch (ta * 256 + tb) {{
{_cases(lambda p: f"custom_pair_kernel<{p[0]}, {p[1]}>", pairs, _PAIR_CALL,
        lambda p: p[0] * 256 + p[1])}
    default: return (int)cudaErrorInvalidValue;
  }}
}}""")
    if unit == "other":
        plane = _cases(lambda c: f"custom_plane_kernel<{c}>", codes, _PAIR_CALL, lambda c: c)
        aabbs = _cases(lambda c: f"custom_aabb_kernel<{c}>", codes,
                       "n, cols, body_idx, params, spec_margin, coll_margin, lin_vel, pos, quat, "
                       "dt, spec_default, tol, aabb_min, aabb_max", lambda c: c)
        rays = _cases(lambda c: f"ray_support_kernel<{c}>", codes,
                      "n, n_rays, m, cols, rays, solid, pos, quat, params, t_out, n_out, work",
                      lambda c: c)
        points = _cases(lambda c: f"custom_point_kernel<{c}>", codes,
                        "n, p_n, m, cols, points, pos, quat, params, dist, closest, inside",
                        lambda c: c)
        parts.append(f"""
extern "C" int avian_custom_plane(int code, {_PAIR_ARGS}) {{
  long long total = n;
  switch (code) {{
{plane}
    default: return (int)cudaErrorInvalidValue;
  }}
}}

extern "C" int avian_custom_aabbs(int code, int n, const int* cols, const int* body_idx,
                                  const float* params, const float* spec_margin,
                                  const float* coll_margin, const float* lin_vel,
                                  const float* pos, const float* quat, float dt,
                                  float spec_default, float tol, float* aabb_min,
                                  float* aabb_max, void* stream) {{
  long long total = n;
  switch (code) {{
{aabbs}
    default: return (int)cudaErrorInvalidValue;
  }}
}}

extern "C" int avian_ray_support(int code, int n, int n_rays, int m, const int* cols,
                                 const float* rays, int solid, const float* pos,
                                 const float* quat, const float* params, float* t_out,
                                 float* n_out, unsigned long long* work, void* stream) {{
  long long total = (long long)n * n_rays;
  switch (code) {{
{rays}
    default: return (int)cudaErrorInvalidValue;
  }}
}}

extern "C" int avian_custom_point(int code, int n, int p_n, int m, const int* cols,
                                  const float* points, const float* pos, const float* quat,
                                  const float* params, float* dist, float* closest,
                                  unsigned char* inside, void* stream) {{
  long long total = (long long)n * p_n;
  switch (code) {{
{points}
    default: return (int)cudaErrorInvalidValue;
  }}
}}""")
    return "\n\n".join(parts) + "\n"


def check_sources(shapes):
    """Raise, naming the shapes, unless every one has a CUDA source."""
    missing = [s.name for s in shapes if not s.cuda]
    if missing:
        raise NotImplementedError(
            f"custom shapes {missing} have no CUDA source (CustomShape(cuda=...)): a custom "
            "shape runs on the card only through its device functions")


class Library:
    """The loaded generated library of one tuple of custom shapes."""

    def __init__(self, shapes, lib, path, build_s):
        self.shapes, self.lib, self.path, self.build_s = shapes, lib, path, build_s
        self.pairs = pair_instances(shapes)

    def launch(self, name, device, *args):
        fn = getattr(self.lib, name)
        conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        with torch.cuda.device(device):
            err = fn(*conv, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            names = [s.name for s in self.shapes]
            raise RuntimeError(f"{name} for custom shapes {names}: CUDA error {err} at launch")

    def launch_manifold(self, pair, inputs, disc, pool):
        """The manifolds of the K pairs ``inputs`` (params [K, 7]) of custom
        pair ``pair``: O's instance against a half-space, else M or P's in
        the unit that holds it; same returns as ``build.launch_manifold``."""
        pa = inputs[0]
        dev, k_n = pa.device, pa.shape[0]
        f32 = torch.float32
        build.require("custom manifold", dev, [(n, x, (k_n, c), f32) for n, x, c in zip(
            ("pa", "qa", "prm_a", "pb", "qb", "prm_b"), inputs, (3, 4, 7, 3, 4, 7))]
            + [("pool", pool, pool.shape, f32)])
        out = (
            torch.empty((k_n, 3), dtype=f32, device=dev),
            torch.empty((k_n, 4, 3), dtype=f32, device=dev),
            torch.empty((k_n, 4, 3), dtype=f32, device=dev),
            torch.empty((k_n, 4), dtype=f32, device=dev),
            torch.empty((k_n, 4), dtype=torch.int32, device=dev),
            torch.empty((k_n,), dtype=torch.int32, device=dev),
        )
        if k_n:
            if pair[0] == int(ShapeType.PLANE):
                self.launch("avian_custom_plane", dev, pair[1], k_n, *inputs, *out, disc, pool)
            else:
                unit = next(u for u, pairs in self.pairs.items() if pair in pairs)
                self.launch(f"avian_custom_pair_{unit}", dev, pair[0], pair[1], k_n, *inputs,
                            *out, disc, pool)
        return out


_LOADED = {}


def library(shapes) -> Library:
    """The generated library of ``shapes`` (a tuple of ``CustomShape``),
    built at first use."""
    shapes = tuple(shapes)
    key = tuple(id(s) for s in shapes)
    if key in _LOADED:
        return _LOADED[key][1]
    check_sources(shapes)
    units = {u: unit_source(shapes, u) for u in ("builtin", "other")}
    h = hashlib.sha256(" ".join(build.NVCC_FLAGS).encode())
    for name in sorted(p.name for p in build.CSRC.glob("*.cuh")):
        h.update(name.encode())
        h.update((build.CSRC / name).read_bytes())
    for u in sorted(units):
        h.update(units[u].encode())
    digest = h.hexdigest()[:16]
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = build.BUILD_DIR / f"libavian_custom_{digest}.so"
    import time

    t0 = time.perf_counter()
    if not path.exists():
        _build(shapes, units, path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    out = Library(shapes, lib, path, time.perf_counter() - t0)
    _LOADED[key] = (shapes, out)  # the shapes stay alive, so their ids stay theirs
    return out


def _build(shapes, units, path: Path) -> None:
    tag = f"{path.stem}.{os.getpid()}"
    srcs, objs = [], []
    for u, text in units.items():
        src = build.BUILD_DIR / f"{tag}.{u}.cu"
        src.write_text(text)
        srcs.append(src)
        objs.append(build.BUILD_DIR / f"{tag}.{u}.o")
    try:
        nvcc = build._nvcc()
        log = build._run_all([
            [nvcc, *build.NVCC_FLAGS, "-I", str(build.CSRC), "-c", "-o", str(obj), str(src)]
            for obj, src in zip(objs, srcs)
        ])
        tmp = build.BUILD_DIR / f"{tag}.tmp"
        log += build._run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    except RuntimeError as e:
        raise RuntimeError(
            f"the kernels of custom shapes {[s.name for s in shapes]} did not build:\n{e}"
        ) from None
    finally:
        for f in srcs + objs:
            f.unlink(missing_ok=True)
    path.with_suffix(".log").write_text(log)
    os.replace(tmp, path)
