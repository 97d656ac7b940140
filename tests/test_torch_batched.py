"""The batched scene step (``avian_tpu_torch.parallel``) against the JAX
reference's ``replicate_world`` and ``jax.vmap`` of its step, and against each
scene stepped alone: the cases of ``torch_cases/cases_batched.py``, run in a
child process by ``torch_child.run_cases``."""

from torch_child import run_cases


def test_batched_cases():
    run_cases("cases_batched.py")
