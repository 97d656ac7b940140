"""Scene batches on one card (port of ``avian_tpu/parallel``): B copies of a
scene stepped in lockstep as one flat world, what ``jax.vmap`` of the step
gives the reference. The multi-card functions (``make_scene_mesh``,
``shard_world``, ``make_sharded_step``) and the 2D batched step are not
ported yet (ROADMAP queue 1)."""

from avian_tpu_torch.parallel.sharding import (
    gather_metrics,
    make_batched_step,
    replicate_world,
)

__all__ = ["replicate_world", "make_batched_step", "gather_metrics"]
