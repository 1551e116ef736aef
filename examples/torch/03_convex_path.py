"""Convex sparse recovery: BP / BPD / reweighting / LASSO solvers (the
PyTorch port's counterpart of examples/03_convex_path.py).

Covers the reference's test/basispursuit.jl workflow. The reference
reaches C solvers through JuMP (Clp simplex for the equality LP, ECOS
interior-point for the SOCP); the port has an ADMM path on the card (its
loops replay CUDA graphs there) AND exact native C++ paths built with g++
at first use: a simplex LP (`bp(method="simplex")`) and a LASSO-homotopy /
BPD-crossing solver (`bpd(method="homotopy")`,
`cstpu_torch.native.lasso_homotopy`), so the reference's exact-arithmetic
answers remain available.

Run:  python examples/torch/03_convex_path.py [--device cpu]
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

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = torch.device(ap.parse_args().device)
torch.backends.cuda.matmul.allow_tf32 = False

gen = torch.Generator().manual_seed(6)      # drawn on the CPU, solved on dev
A, x, b = (t.to(dev) for t in cstpu_torch.sparse_data(gen, n=32, m=64, k=3))
true_support = cstpu_torch.support(x)

# --- equality basis pursuit: ADMM (the card's path) vs exact simplex ------
for method in ("admm", "simplex"):
    xb = cstpu_torch.bp(A, b, method=method)
    got = cstpu_torch.support(cstpu_torch.droptol(xb, 1e-4))
    print(f"bp[{method:7s}] support {got.tolist()} "
          f"feasibility {float(torch.linalg.norm(A @ xb - b)):.1e}")
    assert got.tolist() == list(true_support), method

# --- reweighted BP sharpens hard problems ---------------------------------
xc = cstpu_torch.bp_candes(A, b)
xa = cstpu_torch.bp_ard(A, b)
assert cstpu_torch.samesupport(cstpu_torch.droptol(xc, 1e-4), x)
assert cstpu_torch.samesupport(cstpu_torch.droptol(xa, 1e-4), x)
print("bp_candes / bp_ard: exact support")

# --- basis pursuit denoising on noisy data --------------------------------
delta = 1e-2
y = cstpu_torch.perturb(gen, b.cpu(), delta / 2).to(dev)
for method in ("admm", "homotopy"):
    xd = cstpu_torch.bpd(A, y, delta, method=method)
    got = cstpu_torch.support(cstpu_torch.droptol(xd, 1e-3))
    print(f"bpd[{method:8s}] support {got.tolist()}")
    assert got.tolist() == list(true_support), method

# --- LASSO solvers ---------------------------------------------------------
lam = 1e-3
xi = cstpu_torch.ista(A, y, lam, stepsize=None)    # spectral auto-stepsize
xf = cstpu_torch.fista(A, y, lam, stepsize=None)
A_np, y_np = A.cpu().double().numpy(), y.cpu().double().numpy()
x_exact = cstpu_torch.native.lasso_homotopy(A_np, y_np, lam)
print(f"ista residual  {float(torch.linalg.norm(A @ xi - y)):.2e}   "
      f"fista residual {float(torch.linalg.norm(A @ xf - y)):.2e}")
assert float(torch.linalg.norm(A @ xi - y)) < delta


def lasso_obj(z):
    z = np.asarray(z, np.float64)
    return 0.5 * np.sum((A_np @ z - y_np) ** 2) + lam * np.sum(np.abs(z))


# the exact path solution is the optimum; FISTA lands within its
# first-order tolerance of it
xf_np = xf.cpu().double().numpy()
assert lasso_obj(x_exact) <= lasso_obj(xf_np) + 1e-8
assert abs(lasso_obj(x_exact) - lasso_obj(xf_np)) < 5e-3
print(f"exact homotopy objective {lasso_obj(x_exact):.6f} <= "
      f"fista {lasso_obj(xf_np):.6f}")

# --- batched exact homotopy (threaded C++ executor) ------------------------
Ys = cstpu_torch.perturb(gen, b.cpu().double().repeat(8, 1),
                         delta / 2).numpy()
# lam must dominate the noise scale for exact support at this threshold
Xs, statuses = cstpu_torch.native.lasso_homotopy_batch(A_np, Ys, 3e-3)
assert not statuses.any()                 # per-instance status, no aborts
rec = np.mean([np.array_equal(np.flatnonzero(np.abs(r) > 1e-3),
                              true_support) for r in Xs])
print(f"batched exact homotopy recovery {rec:.2f}")
assert rec == 1.0
print("OK")
