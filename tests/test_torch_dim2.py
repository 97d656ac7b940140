"""The port's native 2D engine against the JAX reference, piece by piece:
`SceneBuilder2D` leaf for leaf, Kernel V on random pairs of every kind, Kernels U, W,
X, Y and Z on one step of a base-20 pyramid: the cases of
``torch_cases/cases_dim2.py``, run in a child process by
``torch_child.run_cases``."""

from torch_child import run_cases


def test_dim2_cases():
    run_cases("cases_dim2.py")
