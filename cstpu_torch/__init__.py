"""cstpu_torch — the PyTorch and CUDA port of cstpu, for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference. This slice
covers batched OMP over one shared dictionary, `omp_batch`, on two CUDA
kernels written by hand (cstpu_torch/csrc), with the per-instance matching
pursuits, the active-set engine and the solution container it rests on.
It imports torch, numpy and ctypes, never jax.
"""

from cstpu_torch.utils.data import sparse_vector, sparse_data, perturb
from cstpu_torch.utils.sparse import (
    SparseSolution,
    support,
    samesupport,
    droptol,
    polish,
)
from cstpu_torch.models.matching_pursuit import mp, omp, gomp, oblivious
from cstpu_torch.models.batched import batch, omp_batch

__version__ = "0.1.0"

__all__ = [
    "sparse_vector", "sparse_data", "perturb",
    "SparseSolution", "support", "samesupport", "droptol", "polish",
    "mp", "omp", "gomp", "oblivious",
    "batch", "omp_batch",
]
