"""Dictionary analysis, preconditioning, warm starts, checkpointing (the
PyTorch port's counterpart of examples/05_dictionary_analysis.py).

Covers the reference's test/util.jl workflow (coherence / Babel function /
preconditioners) plus the subsystems the reference lacks: solver-state
checkpointing and warm starts as explicit features.

Run:  python examples/torch/05_dictionary_analysis.py [--device cpu]
(on the CUDA card unless --device cpu; no fallback to the CPU)
"""

import argparse
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__)))))

import tempfile

import numpy as np
import torch

import cstpu_torch
from cstpu_torch.models.forward import fr_warm

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = torch.device(ap.parse_args().device)
torch.backends.cuda.matmul.allow_tf32 = False

gen = torch.Generator().manual_seed(11)     # drawn on the CPU, solved on dev

# --- coherence and the Babel function --------------------------------------
A, x, b = (t.to(dev) for t in cstpu_torch.sparse_data(gen, n=32, m=64, k=3))
mu = float(cstpu_torch.coherence(A))
mus = cstpu_torch.cumbabel(A, 5).double().cpu().numpy()   # mu_1(1..5)
print(f"coherence {mu:.3f}  cumbabel {np.round(mus, 3).tolist()}")
assert abs(mus[0] - mu) < 1e-6                       # mu_1(1) == coherence
assert np.all(mus[1:] >= mus[:-1])                   # monotone
assert np.all(mus <= np.arange(1, 6) * mu + 1e-12)   # mu_1(i) <= i*mu

# --- preconditioning improves the dictionary -------------------------------
Aabs = torch.abs(A)                                  # |Gaussian| dictionary
P = cstpu_torch.mean_preconditioner(1e-6)
A1 = cstpu_torch.normalize_columns(P(Aabs))
before = cstpu_torch.cumbabel(Aabs, 3).double().cpu().numpy()
after = cstpu_torch.cumbabel(A1, 3).double().cpu().numpy()
print(f"mean-preconditioner Babel: {np.round(before, 3).tolist()} -> "
      f"{np.round(after, 3).tolist()}")
assert np.all(after < before)

A2 = cstpu_torch.precondition(Aabs)                  # SVD whitener
assert np.all(cstpu_torch.cumbabel(
    cstpu_torch.normalize_columns(A2), 3).cpu().numpy() < before)
print("svd-preconditioner decreases the Babel function too")

# --- warm starts ------------------------------------------------------------
true_support = cstpu_torch.support(x)
# restricted LS on a given support: the reference's FR(A, b, nzind)
# warm-start constructor (test/forward.jl:24-28)
sol = fr_warm(A, b, list(true_support))
assert list(sol.nzind) == list(true_support)
assert float(torch.linalg.norm(sol.todense() - x)) < 1e-5
print("fr_warm on the true support: exact restricted LS fit")

# warm starts that continue a solve: rmp resumes from a prior iterate (a
# dense coefficient vector, a SparseSolution or an index array: the
# reference's initial-x argument, src/stepwise.jl:5-6)
x0 = fr_warm(A, b, [int(true_support[0])]).todense()
sol = cstpu_torch.rmp(A, b, delta=1e-5, x0=x0)
assert list(sol.nzind) == list(true_support)
print(f"rmp warm-started from atom {int(true_support[0])}: exact recovery")

x_rmps, alpha = cstpu_torch.rmps(A, b, 1e-4, return_alpha=True)
x_again = cstpu_torch.rmps(A, b, 1e-4, alpha0=alpha)   # resume from alpha
assert cstpu_torch.samesupport(cstpu_torch.droptol(x_again, 1e-4),
                               cstpu_torch.droptol(x_rmps, 1e-4))
print("rmps resumed from its own alpha: same support")

# --- checkpoint / resume: solver state is a plain tree of tensors ----------
with tempfile.TemporaryDirectory() as d:
    path = f"{d}/alpha_state"
    like = {"alpha": alpha, "sigma": torch.tensor(1e-4, device=dev)}
    cstpu_torch.save_state(path, like)
    restored = cstpu_torch.load_state(path, like)
    assert torch.equal(restored["alpha"], alpha)
    assert restored["alpha"].device == alpha.device
print("checkpoint round-trip OK")

# --- cost model / roofline counters -----------------------------------------
cost = cstpu_torch.solve_cost(B=64, n=1024, m=8192, k=32)
rep = cstpu_torch.roofline_report(seconds=0.2, cost=cost)
print(f"cost model: {cost.flops / 1e9:.2f} GFLOP, "
      f"{cost.hbm_bytes_loop / 1e9:.2f} GB streamed (loop) vs "
      f"{cost.hbm_bytes_fused / 1e9:.3f} GB (fused); "
      f"roofline keys {sorted(rep)}")
print("OK")
