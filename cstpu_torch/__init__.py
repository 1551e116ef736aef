"""cstpu_torch — the PyTorch and CUDA port of cstpu, for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference. It covers
the batched greedy solvers over one shared dictionary, `omp_batch`,
`mp_batch`, `gomp_batch` and `fr_batch`, and the batched two-stage ones,
`sp_batch`, `ompr_batch` and `srr_batch`, on CUDA kernels written by hand
(cstpu_torch/csrc), with the per-instance matching pursuits, forward
regression, two-stage solvers, the active-set engine and the solution
container they rest on. It imports torch, numpy and ctypes, never jax.
"""

from cstpu_torch.utils.data import (
    sparse_vector,
    sparse_data,
    correlated_data,
    coherent_data,
    perturb,
)
from cstpu_torch.utils.sparse import (
    SparseSolution,
    support,
    samesupport,
    droptol,
    polish,
)
from cstpu_torch.models.matching_pursuit import mp, omp, gomp, oblivious
from cstpu_torch.models.forward import fr, ols, oomp, ormp, stepwise_regression
from cstpu_torch.models.twostage import sp, ompr, srr
from cstpu_torch.models.batched import (
    batch,
    omp_batch,
    mp_batch,
    gomp_batch,
    fr_batch,
    sp_batch,
    srr_batch,
    ompr_batch,
)

__version__ = "0.1.0"

__all__ = [
    "sparse_vector", "sparse_data", "correlated_data", "coherent_data",
    "perturb",
    "SparseSolution", "support", "samesupport", "droptol", "polish",
    "mp", "omp", "gomp", "oblivious",
    "fr", "ols", "oomp", "ormp", "stepwise_regression",
    "sp", "ompr", "srr",
    "batch", "omp_batch", "mp_batch", "gomp_batch", "fr_batch",
    "sp_batch", "srr_batch", "ompr_batch",
]
