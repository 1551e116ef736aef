"""cstpu_torch — the PyTorch and CUDA port of cstpu, for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference. It covers
the batched greedy solvers over one shared dictionary, `omp_batch`,
`mp_batch`, `gomp_batch` and `fr_batch`, the batched two-stage ones,
`sp_batch`, `ompr_batch` and `srr_batch`, the stepwise ones, `rmp_batch`
and `foba_batch`, and the backward family, `fbr_batch` and `lace_batch`
(with `br_batch` over the per-instance solver), on CUDA kernels written by
hand (cstpu_torch/csrc), with the per-instance matching pursuits, forward
and backward regression, two-stage and stepwise solvers, the active-set
engine and the solution container they rest on; the Sparse Bayesian
Learning family, `sbl`, `fsbl`, `rmps` and `rmps_estimate_noise` with
their batched entry points `sbl_batch`, `fsbl_batch`, `rmps_batch` and
`rmps_estimate_noise_batch` (tensor operations: cstpu has no TPU kernel
for them); the traced solvers and their traces (`omp_traced`, `fr_traced`,
`fsbl_traced`, `rmps_traced`; `SolveTrace`, `SBLTrace`, `RMPSTrace`); the
dictionary utilities (`colnorms`, `coherence`, the Babel function, the
preconditioners); and the column-sharded solvers for dictionaries beyond
one kernel's reach, `omp_sharded_fused`, `mp_sharded_fused`,
`gomp_sharded_fused`, `ompr_sharded_fused`, `sp_sharded_fused`,
`fr_sharded_fused`, `srr_sharded_fused`, `rmp_sharded_fused` and
`foba_sharded_fused` over a mesh of shards (`make_mesh`,
`shard_dictionary`, `shard_batch`), with the plain `omp_sharded` and the
row-sharded `omp_sharded_rows` beside them, on the streaming select
kernels (cstpu_torch.ops.stream_select, cstpu_torch.ops.corr_argmax), and
the atom-sharded SBL solvers (cstpu_torch.parallel: `fsbl_sharded`,
`rmps_sharded`); the convex family, `bp`, `bpd` (secant, ADMM, and the
native homotopy), their Candes and ARD reweightings and `ista`/`fista`,
with the column-sharded convex solvers (`bp_sharded`, `bp_ard_sharded`,
`bpd_sharded`, `bpd_candes_sharded`, `bpd_ard_sharded`,
`bpd_secant_sharded`, `ista_sharded`, `fista_sharded`) and the native
simplex and LASSO-path solvers (cstpu_torch.native, C++ built with g++);
the brute-force oracle `exhaustive`; and the solver configs, checkpoints
and profiling (`SolverConfig`, `solver_config`, `save_state`,
`load_state`, `solve_cost`, `roofline_report`). It imports torch, numpy
and ctypes, never jax.
"""

from cstpu_torch.utils.data import (
    sparse_vector,
    sparse_data,
    gaussian_data,
    correlated_data,
    coherent_data,
    perturb,
)
from cstpu_torch.utils.dictionary import (
    colnorms,
    normalize_columns,
    coherence,
    babel,
    cumbabel,
    mean_preconditioner,
    svd_preconditioner,
    precondition,
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
from cstpu_torch.models.stepwise import rmp, foba
from cstpu_torch.models.backward import br, fbr, lace
from cstpu_torch.models.sbl import (
    sbl, fsbl, fsbl_traced, rmps, rmps_traced, rmps_estimate_noise)
from cstpu_torch.models.basis_pursuit import (
    bp,
    basispursuit,
    bp_candes,
    bp_ard,
    bpd,
    basis_pursuit_denoising,
    bpd_candes,
    bpd_ard,
    ista,
    fista,
)
from cstpu_torch.models.exhaustive import exhaustive
from cstpu_torch.models.batched import (
    batch,
    omp_batch,
    mp_batch,
    gomp_batch,
    fr_batch,
    sp_batch,
    srr_batch,
    ompr_batch,
    rmp_batch,
    foba_batch,
    br_batch,
    fbr_batch,
    lace_batch,
    rmps_batch,
    fsbl_batch,
    sbl_batch,
    rmps_estimate_noise_batch,
)
from cstpu_torch.utils.config import SolverConfig, solver_config
from cstpu_torch.utils.diagnostics import (
    omp_traced, fr_traced, SolveTrace, SBLTrace, RMPSTrace)
from cstpu_torch.utils.checkpoint import save_state, load_state
from cstpu_torch.utils.profiling import solve_cost, roofline_report
from cstpu_torch.parallel import (
    make_mesh,
    shard_dictionary,
    shard_batch,
    omp_sharded,
    omp_sharded_rows,
    omp_sharded_fused,
    mp_sharded_fused,
    gomp_sharded_fused,
    ompr_sharded_fused,
    sp_sharded_fused,
    fr_sharded_fused,
    srr_sharded_fused,
    rmp_sharded_fused,
    foba_sharded_fused,
)
from cstpu_torch.ops.corr_argmax import correlate_argmax

__version__ = "0.1.0"

__all__ = [
    "sparse_vector", "sparse_data", "gaussian_data", "correlated_data",
    "coherent_data", "perturb",
    "colnorms", "normalize_columns", "coherence", "babel", "cumbabel",
    "mean_preconditioner", "svd_preconditioner", "precondition",
    "SparseSolution", "support", "samesupport", "droptol", "polish",
    "mp", "omp", "gomp", "oblivious",
    "fr", "ols", "oomp", "ormp", "stepwise_regression",
    "sp", "ompr", "srr", "rmp", "foba", "br", "fbr", "lace",
    "sbl", "fsbl", "fsbl_traced", "rmps", "rmps_traced",
    "rmps_estimate_noise",
    "bp", "basispursuit", "bp_candes", "bp_ard",
    "bpd", "basis_pursuit_denoising", "bpd_candes", "bpd_ard",
    "ista", "fista",
    "exhaustive",
    "batch", "omp_batch", "mp_batch", "gomp_batch", "fr_batch",
    "sp_batch", "srr_batch", "ompr_batch", "rmp_batch", "foba_batch",
    "br_batch", "fbr_batch", "lace_batch",
    "rmps_batch", "fsbl_batch", "sbl_batch", "rmps_estimate_noise_batch",
    "SolverConfig", "solver_config",
    "omp_traced", "fr_traced", "SolveTrace", "SBLTrace", "RMPSTrace",
    "save_state", "load_state",
    "solve_cost", "roofline_report",
    "make_mesh", "shard_dictionary", "shard_batch",
    "omp_sharded", "omp_sharded_rows", "omp_sharded_fused",
    "mp_sharded_fused", "gomp_sharded_fused", "ompr_sharded_fused",
    "sp_sharded_fused", "fr_sharded_fused", "srr_sharded_fused",
    "rmp_sharded_fused", "foba_sharded_fused",
    "correlate_argmax",
]
