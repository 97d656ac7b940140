"""Rank of each element within its run of equal sorted keys: piece (a) of
Kernel G (``csrc/color_edges.cu::run_rank_kernel``).

Replaces the run-rank scan that ``avian_tpu/pipeline/coloring.py`` (:18-24),
``avian_tpu/pipeline/solver.py::_bucketize`` (:127) and
``avian_tpu/pipeline/sleeping.py::compute_islands`` (:33) share: ``index -
cummax(index where a run starts)``. On the card every thread finds the start
of its key's run by binary search in the sorted array, ``O(log n)`` reads of
an array that sits in L2, instead of an int64 scan. Bound by bytes (4 read,
4 written per element).

The plain PyTorch version, ``run_rank_twin``, runs on CPU tensors; on a CUDA
tensor the wrapper launches the kernel or raises. Its launches count as
Kernel G's (``kernels.launches()['color_edges']``).
"""

import torch


def run_rank_twin(sorted_key):
    """Plain PyTorch version; see ``run_rank``."""
    n = sorted_key.shape[0]
    idx = torch.arange(n, device=sorted_key.device)
    first = torch.searchsorted(sorted_key, sorted_key, right=False)
    return (idx - first).to(torch.int32)


def run_rank(sorted_key):
    """``rank`` i32[n]: position of each element of the ascending i32[n]
    ``sorted_key`` within its run of equal keys."""
    if sorted_key.dtype != torch.int32 or sorted_key.dim() != 1:
        raise TypeError("run_rank: want a 1-d int32 tensor of sorted keys")
    if sorted_key.device.type == "cpu":
        return run_rank_twin(sorted_key)
    if sorted_key.device.type != "cuda":
        raise RuntimeError(f"run_rank: unsupported device {sorted_key.device}")
    if not sorted_key.is_contiguous():
        raise ValueError("run_rank: keys must be contiguous")
    from avian_tpu_torch.kernels import build

    n = sorted_key.shape[0]
    rank = torch.empty((n,), dtype=torch.int32, device=sorted_key.device)
    if n == 0:
        return rank
    build.launch("avian_run_rank", sorted_key.device, n, sorted_key, rank)
    run_rank.launches += 1
    return rank


run_rank.launches = 0
