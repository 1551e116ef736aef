"""Sharded entry points: mesh construction and the column-sharded greedy
solvers (PyTorch counterpart of cstpu.parallel).

The paths for dictionaries beyond one kernel's reach are the fused hybrids
(per-shard streaming select kernels and a merge of the shards' selections):
mp/omp/gomp/sp/ompr_sharded_fused. The plain `omp_sharded` is the reference
they are verified against. cstpu's fr/srr/rmp/foba_sharded_fused,
`omp_sharded_rows`, the sharded SBL and convex solvers and the
multi-process layer are not ported yet.
"""

from cstpu_torch.parallel.mesh import (
    Mesh, ShardedDictionary, make_mesh, shard_batch, shard_dictionary)
from cstpu_torch.parallel.sharded import (
    omp_sharded,
    omp_sharded_fused,
    gomp_sharded_fused,
    sp_sharded_fused,
    mp_sharded_fused,
    ompr_sharded_fused,
)

__all__ = [
    "Mesh", "ShardedDictionary", "make_mesh", "shard_dictionary",
    "shard_batch",
    "omp_sharded", "omp_sharded_fused", "gomp_sharded_fused",
    "sp_sharded_fused", "mp_sharded_fused", "ompr_sharded_fused",
]
