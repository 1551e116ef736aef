"""Tour of the greedy-pursuit solvers on a planted sparse problem (the
PyTorch port's counterpart of examples/01_greedy_pursuits.py).

Covers the reference's test/matchingpursuit.jl + test/forward.jl +
test/twostage.jl workflows (exact support recovery on Gaussian data,
noiseless and noisy) and the batched entry points, which run on the
hand-written CUDA kernels on the card.

Run:  python examples/torch/01_greedy_pursuits.py [--device cpu]
(on the CUDA card unless --device cpu; no fallback to the CPU)
"""

import argparse
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__)))))

import torch

import cstpu_torch

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = torch.device(ap.parse_args().device)
torch.backends.cuda.matmul.allow_tf32 = False

# the problems are drawn on the CPU, so that the card and the CPU solve the
# same ones
gen = torch.Generator().manual_seed(0)

# Planted problem: A (n, m) unit-norm Gaussian dictionary, x k-sparse
# with +-1 entries, b = A @ x.  (Reference: sparse_data in src/util.jl.)
A, x, b = (t.to(dev) for t in cstpu_torch.sparse_data(gen, n=64, m=256,
                                                      k=4))
true_support = cstpu_torch.support(x)

# --- single-problem solves: every greedy family --------------------------
solvers = {
    "omp": lambda: cstpu_torch.omp(A, b, 4),
    "gomp(l=2)": lambda: cstpu_torch.gomp(A, b, 2, 4),
    "fr": lambda: cstpu_torch.fr(A, b, sparsity=4),
    "sp": lambda: cstpu_torch.sp(A, b, 4),
    "ompr": lambda: cstpu_torch.ompr(A, b, 4, delta=1e-6),
    "srr": lambda: cstpu_torch.srr(A, b, 4),
    "rmp(k)": lambda: cstpu_torch.rmp(A, b, k=4),
    "foba": lambda: cstpu_torch.foba(A, b, delta=1e-6),
}
for name, run in solvers.items():
    sol = run()
    ok = list(sol.nzind) == list(true_support)
    print(f"{name:10s} support {list(map(int, sol.nzind))} exact={ok}")
    assert ok, f"{name} missed the planted support"

# --- noisy recovery (the reference's 2-delta tolerance pattern) ----------
delta = 1e-2
y = cstpu_torch.perturb(gen, b.cpu(), delta / 2).to(dev)
sol = cstpu_torch.omp(A, y, 4)
assert list(sol.nzind) == list(true_support)
err = float(torch.max(torch.abs(sol.todense() - x)))
print(f"noisy omp  max coefficient error {err:.2e} (tolerance "
      f"{2 * delta:.0e})")
assert err < 2 * delta

# --- batched: one shared dictionary, a batch of measurement vectors ------
# On the card this runs the whole solve on the hand-written kernels
# (cstpu_torch/csrc): the streaming select and the fused append.
Bs = cstpu_torch.perturb(gen, b.cpu().repeat(16, 1), delta / 2).to(dev)
sols = cstpu_torch.omp_batch(A, Bs, 4)        # SparseSolution (16, 4)
dense = sols.todense()                        # (16, 256)
want = torch.as_tensor(true_support, device=dev)
all_exact = bool(torch.all(torch.sort(sols.idx, 1).values
                           == want.to(sols.idx.dtype)[None, :]))
print(f"batched omp: {dense.shape[0]} problems on {dense.device}, all "
      f"supports exact = {all_exact}")
assert all_exact

# --- declarative configs --------------------------------------------------
cfg = cstpu_torch.solver_config("fr", sparsity=4)
sol = cfg.run(A, y)
assert list(sol.nzind) == list(true_support)
print(f"solver_config: {cfg} -> exact recovery")

# --- observability: per-step traces ---------------------------------------
sol, trace = cstpu_torch.omp_traced(A, y, 4)
steps = int(torch.sum(trace.accepted))
print("omp trace: selected", [int(i) for i in trace.selected[:steps]],
      "residuals", [f"{float(r):.1e}" for r in trace.residual_norm[:steps]])
print("OK")
