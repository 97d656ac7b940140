"""2D scenes (port of ``avian_tpu/dim2/scenes.py``): the reference's Large
Pyramid 2D and Many Pyramids 2D. Both take ``max_contacts`` (default the
reference's ``max(8 * n, 64)``) and ``device`` (``None`` builds on the card;
pass ``device="cpu"`` for the CPU), as the 3D ``scenes.box_pyramid`` does.
Returns ``(world, ids)``."""

from avian_tpu_torch.core.types import BodyType
from avian_tpu_torch.dim2.builder import SceneBuilder2D


def _ground():
    b = SceneBuilder2D()
    g = b.add_body(body_type=BodyType.STATIC)
    b.half_space(g, normal=(0, 1), friction=0.6)
    return b


def _rows(b, base, half, ox, ids):
    for row in range(base):
        cols = base - row
        for c in range(cols):
            x = ox + (c - cols / 2.0) * 1.001 * 2 * half
            y = half * 1.001 + row * 2 * half * 1.001
            body = b.add_body(pos=(x, y))
            b.box(body, half, half, friction=0.6)
            ids.append(body)


def _finalize(b, ids, max_contacts, device):
    n = len(ids) + 1
    world = b.finalize(max_bodies=n, max_colliders=n,
                       max_contacts=max_contacts or max(8 * n, 64), device=device)
    return world, ids


def box_pyramid_2d(base: int = 100, half: float = 0.5, max_contacts: int | None = None,
                   device=None):
    """Large Pyramid 2D: rows of ``base`` .. 1 boxes, ``base * (base + 1) / 2``
    in all (``benches/src/dim2/large_pyramid.rs:6-39``)."""
    b = _ground()
    ids = []
    _rows(b, base, half, 0.0, ids)
    return _finalize(b, ids, max_contacts, device)


def many_pyramids_2d(grid: int = 10, base: int = 10, half: float = 0.5,
                     max_contacts: int | None = None, device=None):
    """Many Pyramids 2D: ``grid * grid`` base-``base`` pyramids in one row
    (``benches/src/dim2/mod.rs:17-24``)."""
    b = _ground()
    ids = []
    spacing = (base + 4) * 2 * half
    for gx in range(grid * grid):
        _rows(b, base, half, (gx - grid * grid / 2.0) * spacing, ids)
    return _finalize(b, ids, max_contacts, device)
