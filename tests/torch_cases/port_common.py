"""Shared helpers of the PyTorch-port parity cases (``cases_*.py``).

Worlds pass between the two packages as numpy arrays: ``World.from_numpy``
takes the JAX world mapped through ``np.asarray``, and ``to_jax`` rebuilds a
JAX world from the port's ``to_numpy`` on a template of the same scene.
This module holds no tests.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from avian_tpu.core.config import PhysicsConfig as JConfig
from avian_tpu_torch.core.config import PhysicsConfig as TConfig
from avian_tpu_torch.core.state import World as TWorld
from avian_tpu_torch.pipeline.step import physics_step as t_step

PAIRS = ((2, 2), (2, 3))  # box/box, box/plane
# The canonical pairs of spheres (0), capsules (1), boxes (2), half-spaces
# (3), cylinders (4) and cones (5), half-space pairs aside.
SHAPE_PAIRS = tuple((a, b) for a in range(6) for b in range(a, 6) if (a, b) != (3, 3))


def ieee_reference():
    """Make XLA:CPU compile the reference one IEEE operation at a time.

    Under an ISA with fused multiply-adds XLA:CPU contracts ``a*b - c*d``
    into an FMA and computes ``1 / sqrt`` with an approximate reciprocal
    square root, so the reference's results depend on what a program fuses
    around an expression. The support-map pipeline (Frank-Wolfe on a
    degenerate first triangle ``(x, s, s)``, where ``d1*d4 - d3*d2`` is
    exactly 0 without contraction) amplifies those last bits to 1e-3.
    Capping the ISA at SSE4.2 leaves every operation correctly rounded, as
    the port's plain versions are. Call before the first JAX computation of
    the process; the case files that call it run in a child of their own."""
    import os

    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_cpu_max_isa" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_cpu_max_isa=SSE4_2").strip()

# The port's CPU tensors here are tiny: one intra-op thread is fastest, and
# leaves the cores to the other test workers.
torch.set_num_threads(1)


def pile_configs(**kw):
    """The cube-pile slice's config in both packages."""
    return (
        JConfig(substeps=4, shape_pairs=PAIRS, **kw),
        TConfig(substeps=4, shape_pairs=PAIRS, **kw),
    )


def to_torch(jax_world) -> TWorld:
    return TWorld.from_numpy(jax.tree.map(np.asarray, jax_world), device="cpu")


def to_jax(port_world: TWorld, template):
    """A JAX world with the port world's leaves and the template's static
    metadata."""
    tn = port_world.to_numpy()

    def group(obj, leaves):
        return obj.replace(**{k: jnp.asarray(v) for k, v in leaves.items()})

    return template.replace(
        bodies=group(template.bodies, tn["bodies"]),
        colliders=group(template.colliders, tn["colliders"]),
        contacts=group(template.contacts, tn["contacts"]),
        joints=group(template.joints, tn["joints"]),
        gravity=jnp.asarray(tn["gravity"]),
        time=jnp.asarray(tn["time"]),
        diverged=jnp.asarray(tn["diverged"]),
        convex_verts=jnp.asarray(tn["convex_verts"]),
    )


def _resting_pile(builder, side, layers, seed, **finalize_kw):
    """Unit cubes stacked in columns, resting face on face on the ground
    and on each other, with a seeded sideways jitter that makes the columns
    touch."""
    rng = np.random.default_rng(seed)
    g = builder.add_body(body_type=0)
    builder.half_space(g, normal=(0, 1, 0))
    for layer in range(layers):
        for i in range(side):
            for j in range(side):
                jx, jz = rng.uniform(-0.02, 0.02, size=2)
                body = builder.add_body(
                    pos=(i * 1.0 + jx, 0.5 + layer * 1.0 + 1e-3, j * 1.0 + jz)
                )
                builder.box(body, 0.5, 0.5, 0.5, friction=0.5)
    n = side * side * layers
    return builder.finalize(
        max_bodies=n + 1, max_colliders=n + 1, max_contacts=16 * n, **finalize_kw
    )


def settled_pile(side=4, layers=4, steps=6, seed=0):
    """A resting pile of ``side * side * layers`` (64) cubes stepped
    ``steps`` times by the port on CPU; returns (port world, JAX template of
    the same scene). Contacts, colors and warm-start impulses are populated."""
    from avian_tpu.core.builder import SceneBuilder as JBuilder
    from avian_tpu_torch.core.builder import SceneBuilder as TBuilder

    template = _resting_pile(JBuilder(), side, layers, seed)
    world = _resting_pile(TBuilder(), side, layers, seed, device="cpu")
    _, tcfg = pile_configs()
    for _ in range(steps):
        world = t_step(world, tcfg)
    return world, template


def settled_pyramid(base=6, steps=6, dim3_depth=False):
    """A ``box_pyramid(base)`` stepped ``steps`` times by the port on CPU;
    returns (port world, JAX template of the same scene)."""
    from avian_tpu import scenes as jscenes
    from avian_tpu_torch import scenes as tscenes

    template, _ = jscenes.box_pyramid(base, dim3_depth=dim3_depth)
    world, _ = tscenes.box_pyramid(base, dim3_depth=dim3_depth, device="cpu")
    _, tcfg = pile_configs()
    for _ in range(steps):
        world = t_step(world, tcfg)
    return world, template


def example_many_shapes():
    """The JAX world of ``examples/many_shapes.py``, built as the example
    builds it (150 mixed shapes, seed 7)."""
    from avian_tpu import BodyType, SceneBuilder

    rng = np.random.default_rng(7)
    b = SceneBuilder()
    g = b.add_body(body_type=BodyType.STATIC)
    b.half_space(g, normal=(0, 1, 0))
    n = 150
    for k in range(n):
        x = (k % 12) * 1.1 - 6.5 + rng.uniform(-0.05, 0.05)
        z = ((k // 12) % 12) * 1.1 - 6.5 + rng.uniform(-0.05, 0.05)
        y = 1.0 + (k // 144) * 1.5
        body = b.add_body(pos=(x, y, z))
        kind = k % 5
        if kind == 0:
            b.sphere(body, 0.4)
        elif kind == 1:
            b.box(body, 0.35, 0.35, 0.35)
        elif kind == 2:
            b.capsule(body, 0.25, 0.5)
        elif kind == 3:
            b.cylinder(body, 0.3, 0.7)
        else:
            b.cone(body, 0.35, 0.7)
    return b.finalize(max_bodies=n + 1, max_colliders=n + 1, max_contacts=8 * (n + 1))


def as_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def quats(rng, k, scale=1.0):
    """``k`` unit quaternions, rotations of up to about ``2 * scale`` rad."""
    q = rng.normal(size=(k, 4)).astype(np.float32) * np.float32(scale)
    q[:, 3] += 1.0
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def rotate_np(q, v):
    """``v`` [K, 3] rotated by ``q`` [K, 4] (x, y, z, w), in float32."""
    u, w = q[:, :3], q[:, 3:4]
    t = 2.0 * np.cross(u, v)
    return (v + w * t + np.cross(u, t)).astype(np.float32)


def pad8(prm):
    """Shape parameters [K, n] padded to the reference's [K, 8]."""
    out = np.zeros((prm.shape[0], 8), np.float32)
    out[:, :prm.shape[1]] = prm
    return out


def assert_manifolds_equal(ref, port, tol, skip=()):
    """Manifolds of K pairs, reference (a ``Manifold`` of the JAX package)
    against the port's ``(normal, point_a, point_b, separation, feature_id,
    count)``: counts and each pair's set of feature ids exactly, the normal
    and every valid point's (finite separation) two witnesses and separation
    within ``tol``, matched through the feature id. Pairs in ``skip`` are
    left out (each named with its cause where the caller lists it)."""
    r = [np.asarray(x) for x in (ref.normal, ref.point_a, ref.point_b, ref.separation,
                                 ref.feature_id, ref.count)]
    p = [as_numpy(x) for x in port]
    keep = np.setdiff1d(np.arange(r[5].shape[0]), np.asarray(skip, np.int64))
    np.testing.assert_array_equal(p[5][keep], r[5][keep], err_msg="count")
    np.testing.assert_allclose(p[0][keep], r[0][keep], atol=tol, rtol=0, err_msg="normal")
    for i in keep:
        rk = {int(r[4][i, k]): k for k in range(4) if r[3][i, k] < 1e8}
        pk = {int(p[4][i, k]): k for k in range(4) if p[3][i, k] < 1e8}
        assert sorted(rk) == sorted(pk), (i, rk, pk)
        assert len(rk) == int(r[5][i]), (i, rk)
        for f, k in rk.items():
            for j, what in ((1, "point_a"), (2, "point_b"), (3, "separation")):
                np.testing.assert_allclose(p[j][i, pk[f]], r[j][i, k], atol=tol, rtol=0,
                                           err_msg=f"pair {i} feature {f} {what}")


def assert_columns(ref, port, atol=0.0, skip=(), only=None):
    """Every field of a reference dataclass against the port's: discrete
    fields exactly, float fields within ``atol``."""
    names = only or [f.name for f in dataclasses.fields(ref)]
    for name in names:
        if name in skip:
            continue
        r = np.asarray(getattr(ref, name))
        p = as_numpy(getattr(port, name))
        if r.dtype == np.uint32:
            r = r.view(np.int32)
        assert r.shape == p.shape, (name, r.shape, p.shape)
        if np.issubdtype(r.dtype, np.floating):
            np.testing.assert_allclose(p, r, rtol=0, atol=atol, err_msg=name)
        else:
            np.testing.assert_array_equal(p, r.astype(p.dtype), err_msg=name)


def assert_worlds_equal(ref, port):
    """A JAX world against the port's, leaf for leaf: names, dtypes, shapes
    and values of every column, the world's own leaves and ``shape_pairs``."""
    ref_np = jax.tree.map(np.asarray, ref)
    port_np = port.to_numpy()
    for group in ("bodies", "colliders", "contacts", "joints"):
        ref_group = getattr(ref_np, group)
        fields = [f.name for f in dataclasses.fields(ref_group)]
        assert sorted(port_np[group]) == sorted(fields), group
        for field in fields:
            r = getattr(ref_group, field)
            p = port_np[group][field]
            assert p.dtype == r.dtype and p.shape == r.shape, (group, field)
            np.testing.assert_array_equal(p, r, err_msg=f"{group}.{field}")
    for leaf in ("gravity", "time", "diverged", "convex_verts"):
        r = getattr(ref_np, leaf)
        assert port_np[leaf].dtype == r.dtype and port_np[leaf].shape == r.shape
        np.testing.assert_array_equal(port_np[leaf], r)
    assert port.shape_pairs == tuple(tuple(int(x) for x in p) for p in ref.shape_pairs)


def assert_packed_rows_close(port, ref, valid, tol):
    """Packed constraint rows ``data[colors, cap, 88]``: per-row columns on
    valid rows, per-point columns on the points that are solved (point mask
    > 0). Anchors of points past ``num_points`` are leftovers of the manifold
    and carry no meaning; their products may differ in rounding."""
    from avian_tpu_torch.kernels import solve_color as kd

    port, ref, valid = as_numpy(port), as_numpy(ref), as_numpy(valid)

    def close(x, y, name):
        np.testing.assert_allclose(x, y, atol=tol, rtol=0, err_msg=name)

    on = ref[..., kd.PM:kd.PM + 4] > 0
    for lo, hi in ((0, kd.AA), (kd.SV, kd.D)):
        close(port[valid][:, lo:hi], ref[valid][:, lo:hi], f"data {lo}:{hi}")
    for base, width in ((kd.AA, 3), (kd.AB, 3), (kd.SEP, 1), (kd.NM, 1),
                        (kd.TK, 3), (kd.NS, 1), (kd.PM, 1)):
        for i in range(4):
            cols = slice(base + width * i, base + width * (i + 1))
            close(port[..., cols][on[..., i]], ref[..., cols][on[..., i]],
                  f"data {base} point {i}")


# ---- recorded reference outputs ------------------------------------------------------

RECORD_ENV = "AVIAN_RECORD"  # "record": run the reference and write; "check": run and compare


def digest(inputs) -> str:
    """A digest of the reference's inputs: every leaf's dtype, shape and
    bytes and the tree's structure (static metadata included)."""
    import hashlib

    leaves, tree = jax.tree_util.tree_flatten(inputs)
    h = hashlib.sha256(str(tree).encode())
    for x in leaves:
        a = np.asarray(x)
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:20]


class Tree(dict):
    """A recorded output: nested names as attributes and items."""

    __getattr__ = dict.__getitem__


def _flatten(outputs):
    """{path: numpy array} of a pytree of arrays."""
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(outputs)[0]:
        names = []
        for k in path:
            if isinstance(k, jax.tree_util.SequenceKey):
                names.append(f"#{k.idx}")
            else:
                names.append(str(getattr(k, "name", getattr(k, "key", k))))
        flat["/".join(names)] = np.asarray(leaf)
    return flat


def _unflatten(flat):
    """The nested ``Tree``/list of ``_flatten``'s paths."""
    root = {}
    for path, a in flat.items():
        node = root
        *head, last = path.split("/") if path else ("",)
        for name in head:
            node = node.setdefault(name, {})
        node[last] = a

    def build(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("#") for k in node):
            return [build(node[f"#{i}"]) for i in range(len(node))]
        if list(node) == [""]:
            return node[""]
        return Tree({k: build(v) for k, v in node.items()})

    return build(root)


class Recording:
    """The JAX reference's outputs of one case file, recorded beside it in
    ``<name>_reference.npz`` and keyed by a digest of the reference's inputs,
    so that a case reads what compiling the reference would give. A case
    whose inputs changed finds no recording and fails until the recording is
    made again. With ``AVIAN_RECORD=record`` in the environment the
    reference runs and the file is written as the process ends; with
    ``AVIAN_RECORD=check`` it runs and must equal the recording
    (``tests/torch_cases/record_references.py`` runs a case file either
    way). A ``live`` call always runs the reference and holds it to the
    recording: each file keeps one on its cheapest input, so that a
    recording that has gone stale fails."""

    def __init__(self, name):
        import os

        self.path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 f"{name}_reference.npz")
        self.mode = os.environ.get(RECORD_ENV, "")
        self._stored = None
        self._new = {}

    def stored(self):
        import os

        if self._stored is None:
            self._stored = {}
            if os.path.exists(self.path):
                with np.load(self.path) as z:
                    self._stored = {k: z[k] for k in z.files}
        return self._stored

    def _entry(self, key):
        prefix = key + ":"
        return {k[len(prefix):]: v for k, v in self.stored().items() if k.startswith(prefix)}

    def __call__(self, inputs, compute, live=False):
        """``compute()``'s outputs (a pytree of arrays, as a ``Tree``), from
        the recording of ``inputs`` or, recording, checking or ``live``,
        from the reference itself."""
        key = digest(inputs)
        if not (self.mode or live):
            entry = self._entry(key)
            assert entry, (f"no recording of these inputs ({key}) in {self.path}: run "
                           "tests/torch_cases/record_references.py on this case file")
            return _unflatten(entry)
        flat = _flatten(compute())
        if self.mode == "run":  # the reference alone, for a script
            return _unflatten(flat)
        if self.mode == "record":
            if not self._new:
                import atexit

                atexit.register(self._write)
            self._new.update({f"{key}:{k}": v for k, v in flat.items()})
        else:
            entry = self._entry(key)
            assert set(entry) == set(flat), f"the recording of {key} is stale"
            for k, v in flat.items():
                if v.dtype.kind == "f":
                    np.testing.assert_allclose(v, entry[k], rtol=1e-6, atol=1e-6,
                                               err_msg=f"the recording of {key} is stale: {k}")
                else:
                    np.testing.assert_array_equal(v, entry[k], err_msg=f"stale: {key} {k}")
        return _unflatten(flat)

    def _write(self):
        np.savez_compressed(self.path, **self._new)
