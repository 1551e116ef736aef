"""Sharded entry points: mesh construction and the sharded solvers
(PyTorch counterpart of cstpu.parallel).

The paths for dictionaries beyond one kernel's reach are the fused hybrids
(per-shard streaming select kernels and a merge of the shards' selections):
mp/omp/gomp/sp/fr/ompr/srr/rmp/foba_sharded_fused. The plain `omp_sharded`
is the reference they are verified against, and the row-sharded
`omp_sharded_rows` is the strategy for a long measurement axis (n >> m).
`fsbl_sharded` and `rmps_sharded` are the atom-sharded SBL solvers
(cstpu_torch.parallel.sharded_sbl), and the column-sharded convex solvers
(bp/bp_ard/bpd/bpd_candes/bpd_ard/bpd_secant/ista/fista_sharded) are in
cstpu_torch.parallel.convex. Every one of them runs over a mesh that spans
processes as well (cstpu_torch.parallel.distributed: `initialize`,
`global_mesh`, `shard_global`).
"""

from cstpu_torch.parallel.mesh import (
    Mesh, ShardedDictionary, make_mesh, shard_batch, shard_dictionary)
from cstpu_torch.parallel.sharded import (
    omp_sharded,
    omp_sharded_rows,
    omp_sharded_fused,
    gomp_sharded_fused,
    sp_sharded_fused,
    fr_sharded_fused,
    mp_sharded_fused,
    ompr_sharded_fused,
    srr_sharded_fused,
    rmp_sharded_fused,
    foba_sharded_fused,
)
from cstpu_torch.parallel.sharded_sbl import fsbl_sharded, rmps_sharded
from cstpu_torch.parallel import distributed
from cstpu_torch.parallel.convex import (bp_sharded, bp_ard_sharded,
                                         bpd_sharded, bpd_candes_sharded,
                                         bpd_ard_sharded, bpd_secant_sharded,
                                         ista_sharded, fista_sharded)

__all__ = [
    "Mesh", "ShardedDictionary", "make_mesh", "shard_dictionary",
    "shard_batch",
    "omp_sharded", "omp_sharded_rows", "omp_sharded_fused",
    "gomp_sharded_fused", "sp_sharded_fused", "fr_sharded_fused",
    "mp_sharded_fused", "ompr_sharded_fused", "srr_sharded_fused",
    "rmp_sharded_fused", "foba_sharded_fused",
    "fsbl_sharded", "rmps_sharded",
    "bp_sharded", "bp_ard_sharded", "bpd_sharded", "bpd_candes_sharded",
    "bpd_ard_sharded", "bpd_secant_sharded", "ista_sharded",
    "fista_sharded",
]
