"""The port's hand-written kernels against their plain PyTorch twins on a
CUDA card. Every test here skips on a machine without one. The file imports
no JAX, so on the card it runs without the suite's conftest:

    python -m pytest tests/torch_cases/cases_cuda.py --noconftest -o addopts="" -q
"""

import numpy as np
import pytest
import torch

from avian_tpu_torch import PhysicsConfig, kernels, physics_step, scenes
from avian_tpu_torch.core.types import BodyType
from avian_tpu_torch.kernels import box_manifold as ka
from avian_tpu_torch.kernels import grid_sweep as kb
from avian_tpu_torch.kernels import integrate_bodies as kc
from avian_tpu_torch.kernels import solve_color as kd
from avian_tpu_torch.pipeline import broadphase as bp_m
from avian_tpu_torch.pipeline import solver as sol_m
from avian_tpu_torch.pipeline.step import prepare_step

pytestmark = pytest.mark.cuda
CONFIG = PhysicsConfig(substeps=4, shape_pairs=((2, 2), (2, 3)))


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def pile(cuda):
    world, _ = scenes.cube_pile(512, max_contacts=16 * 512, device=cuda)
    for _ in range(30):
        world = physics_step(world, CONFIG)
    return world


def _quats(rng, k):
    q = rng.normal(size=(k, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


@pytest.mark.parametrize("kind", [ka.BOX_BOX, ka.BOX_PLANE])
def test_box_manifold_matches_twin(cuda, kind):
    rng = np.random.default_rng(kind)
    k = 4096
    pa = rng.uniform(-1, 1, (k, 3)).astype(np.float32)
    pb = (pa + rng.uniform(-0.9, 0.9, (k, 3))).astype(np.float32)
    ha = rng.uniform(0.2, 0.7, (k, 3)).astype(np.float32)
    hb = rng.uniform(0.2, 0.7, (k, 3)).astype(np.float32)
    if kind == ka.BOX_PLANE:
        hb[:] = (0.0, 1.0, 0.0)
    args = [torch.from_numpy(x).to(cuda)
            for x in (pa, _quats(rng, k), ha, pb, _quats(rng, k), hb)]
    got = ka.box_manifold(kind, *args)
    want = ka.box_manifold_twin(kind, *args)
    assert torch.equal(got[4], want[4]) and torch.equal(got[5], want[5])
    for x, y in zip(got[:4], want[:4]):
        assert float((x - y).abs().max()) <= 1e-5


def test_grid_sweep_matches_twin(cuda, pile):
    g = bp_m.grid_entries(bp_m.update_aabbs(pile, CONFIG), CONFIG)
    got = kb.grid_sweep(g.skey, g.sf, g.si, g.window)
    want = kb.grid_sweep_twin(g.skey, g.sf, g.si, g.window)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int((got[0] != 0).sum()) > 0


def test_integrate_bodies_matches_twin(cuda, pile):
    p = prepare_step(pile, CONFIG)
    for mode in (kc.VELOCITIES, kc.POSITIONS):
        got = kc.integrate_bodies(p.s.state, p.table, CONFIG.substep_dt, mode)
        want = kc.integrate_bodies_twin(p.s.state, p.table, CONFIG.substep_dt, mode)
        assert float((got - want).abs().max()) <= 1e-6 * max(1.0, float(want.abs().max()))


def _bouncing(world):
    """The pile with restitution 0.7 on every collider and every dynamic
    body awake and moving down at 3 m/s, so that restitution acts."""
    b = world.bodies
    down = torch.tensor([0.0, -3.0, 0.0], device=b.lin_vel.device)
    dyn = (b.body_type == BodyType.DYNAMIC)[:, None]
    return world.replace(
        bodies=b.replace(lin_vel=b.lin_vel + down * dyn, sleeping=torch.zeros_like(b.sleeping)),
        colliders=world.colliders.replace(
            restitution=torch.full_like(world.colliders.restitution, 0.7)
        ),
    )


@pytest.mark.parametrize("max_colors,bounce", [(12, False), (3, False), (12, True)])
def test_solve_color_matches_twin_and_is_reproducible(cuda, pile, max_colors, bounce):
    config = PhysicsConfig(substeps=4, shape_pairs=((2, 2), (2, 3)), max_colors=max_colors)
    p = prepare_step(_bouncing(pile) if bounce else pile, config)
    con, params = p.con, sol_m.solve_params(config)
    modes = (kd.WARM, kd.BIAS, kd.RELAX, kd.RESTITUTION)

    def run(fn, twin):
        state, imp = p.s.state.clone(), con.imp.clone()
        for mode in modes:
            if mode == kd.RESTITUTION:
                before = imp.clone()
            for c in range(max_colors):
                tail = () if twin else (con.ovf_order, con.ovf_key)
                fn(mode, c, state, con.data, imp, con.bucket_a, con.bucket_b,
                   con.bucket_valid, con.relax, *tail, params)
        return state, imp, before

    runs = [run(kd.solve_color, False) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    state, imp, before = run(kd.solve_color_twin, True)
    assert float((runs[0][0][:, :6] - state[:, :6]).abs().max()) <= 1e-5
    assert float((runs[0][1] - imp).abs().max()) <= 1e-5
    if bounce:
        # The restitution pass changed impulses, so its check is not vacuous.
        assert not torch.equal(runs[0][1][..., :4], runs[0][2][..., :4])


def test_pile_step_launches_every_kernel(cuda):
    world, _ = scenes.cube_pile(216, max_contacts=16 * 216, device=cuda)
    kernels.reset_launches()
    for _ in range(3):
        world = physics_step(world, CONFIG)
    counts = kernels.launches()
    assert counts["grid_sweep"] == 3 and counts["integrate_bodies"] == 3 * 2 * 4
    assert counts["solve_color"] == 3 * (4 * 3 * 12 + 12)
    assert counts["box_manifold"] >= 3
    assert bool(torch.isfinite(world.bodies.pos).all())
