"""Sharded solves over a ('batch', 'atoms') mesh of shards (the PyTorch
port's counterpart of examples/04_sharding_multichip.py).

The dictionary's atom axis is column-sharded; each shard correlates the
residual with its own atoms (one streaming select kernel per shard and
step on the card) and a collective argmax (pmax of the values, pmin of the
candidate global indices for deterministic lowest-index ties) selects
atoms exactly as the one-shard solver would. This is both the multi-card
scaling path AND the one-card path for dictionaries beyond one kernel's
reach: no shard ever needs the whole dictionary.

The mesh here is (1, 8) shards on the one card (or on the CPU with
--device cpu), where cstpu's example forces 8 virtual CPU devices: the
sharding semantics, collectives and recovery are the same; the timings
are not a multi-card run's.

Run:  python examples/torch/04_sharding_multichip.py [--device cpu]
(on the CUDA card unless --device cpu; no fallback to the CPU)
"""

import argparse
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__)))))

import numpy as np
import torch

import cstpu_torch
from cstpu_torch.parallel import (gomp_sharded_fused, make_mesh,
                                  omp_sharded_fused)

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = torch.device(ap.parse_args().device)
torch.backends.cuda.matmul.allow_tf32 = False
print(f"devices: 8 shards on {dev}"
      + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda"
         else ""))

# (1, 8) mesh: every shard on the 'atoms' axis; add batch shards by making
# the first axis > 1 (B must stay divisible by the batch shards).
mesh = make_mesh((1, 8), devices=[dev])

n, m, k, B = 64, 1024, 4, 8
gen = torch.Generator().manual_seed(9)      # drawn on the CPU, solved on dev
A = cstpu_torch.sparse_data(gen, n=n, m=m, k=k)[0]
sup = torch.stack([torch.randperm(m, generator=gen)[:k] for _ in range(B)])
X = torch.zeros((B, m)).scatter_(1, sup, 1.0)
Bs = X @ A.T                                            # (B, n)
A, Bs = A.to(dev), Bs.to(dev)

# The sharded path: per-shard streaming select + collective argmax.
sol = omp_sharded_fused(A, Bs, k, mesh)
got = np.sort(torch.where(sol.mask, sol.idx, m).cpu().numpy(), 1)
assert np.array_equal(got, np.sort(sup.numpy(), 1))
print(f"omp_sharded_fused: {B} problems over 8 atom shards, exact recovery")

# Sharding invariance: the sharded solve selects the SAME atoms as the
# one-shard batched solver (deterministic lowest-index tie-breaking).
ref = cstpu_torch.omp_batch(A, Bs, k)
assert torch.equal(sol.idx.cpu(), ref.idx.cpu())
print("sharding-invariant: sharded idx == one-shard idx")

# GOMP rides the same machinery with a per-shard top-l select. (GOMP's
# l-at-a-time greed has a weaker recovery guarantee than OMP: the invariant
# to check is that sharding never changes the answer.)
sol_g = gomp_sharded_fused(A, Bs, 2, k, mesh)
ref_g = cstpu_torch.gomp_batch(A, Bs, 2, k)
assert torch.equal(sol_g.idx.cpu(), ref_g.idx.cpu())
print("gomp_sharded_fused: sharding-invariant selection")

# SBL and convex solvers shard too (atom-sharded S/Q engines, sharded
# ADMM): see cstpu_torch.parallel.sharded_sbl / cstpu_torch.parallel.convex.
# Across processes (one per card, or several on one card), the same entry
# points run over cstpu_torch.parallel.distributed's global mesh:
#     torchrun --nproc-per-node 4 solve.py
# with, in solve.py,
#     mesh = distributed.initialize_and_mesh()
#     A = distributed.shard_global(make_columns, mesh, (None, "atoms"),
#                                  global_shape=(n, m))
print("OK")
