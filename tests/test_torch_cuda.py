"""The port's hand-written kernels against their plain PyTorch twins on a CUDA
card; every case skips without one: the cases of
``torch_cases/cases_cuda.py``, run in a child process by
``torch_child.run_cases``."""

import pytest

from torch_child import run_cases

pytestmark = pytest.mark.cuda


def test_cuda_cases():
    run_cases("cases_cuda.py")
