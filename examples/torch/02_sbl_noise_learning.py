"""Sparse Bayesian Learning family: sbl / fsbl / rmps + noise learning (the
PyTorch port's counterpart of examples/02_sbl_noise_learning.py).

Covers the reference's test/sbl.jl workflow: the three SBL solvers agree
on the planted support at threshold sigma, the sigma^2 outer EM loop
recovers the injected noise level, and the zero-noise limit of RMPS
matches RMP. Adds the observability layer the reference lacks: per-action
marginal-likelihood traces.

Run:  python examples/torch/02_sbl_noise_learning.py [--device cpu]
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

gen = torch.Generator().manual_seed(3)      # drawn on the CPU, solved on dev
A, x, b = (t.to(dev) for t in cstpu_torch.sparse_data(gen, n=64, m=128,
                                                      k=3))
true_support = cstpu_torch.support(x)

sigma = 1e-2
y = cstpu_torch.perturb(gen, b.cpu(), sigma / 2).to(dev)

# --- the three SBL solvers agree at threshold sigma -----------------------
for name, run in {
    "sbl": lambda: cstpu_torch.sbl(A, y, sigma),
    "fsbl": lambda: cstpu_torch.fsbl(A, y, sigma),
    "rmps": lambda: cstpu_torch.rmps(A, y, sigma),
}.items():
    xs = run()                                     # dense posterior mean
    got = np.flatnonzero(np.abs(xs.cpu().numpy()) > sigma)
    print(f"{name:5s} support@sigma {got.tolist()}")
    assert got.tolist() == list(true_support), name

# --- noise-variance learning (Inverse-Gamma prior EM) ---------------------
# under the reference's Inverse-Gamma(1, sigma^2) prior: under the flat
# default the float32 EM of this problem runs off to sigma^2 ~ 5e-2 (all
# signal taken for noise), in float64 to ~1e-15
x_hat, sigma2 = cstpu_torch.rmps_estimate_noise(
    A, y, sigma2_init=1e-2, a_sigma2=1.0, b_sigma2=sigma ** 2)
sigma2 = float(sigma2)
resid = float(torch.linalg.norm(A @ x_hat - y))
print(f"learned sigma^2 = {sigma2:.2e} "
      f"(injected {(sigma / 2) ** 2 / len(y):.2e} per-sample), "
      f"residual {resid:.2e}")
assert resid < 5 * np.sqrt(sigma2 * len(y))        # reference's sanity bound

# --- zero-noise limit: RMPS -> RMP ----------------------------------------
x_rmps = cstpu_torch.rmps(A, b, 1e-6)
sol_rmp = cstpu_torch.rmp(A, b, delta=1e-6)
assert cstpu_torch.samesupport(cstpu_torch.droptol(x_rmps, 1e-6), sol_rmp)
print("zero-noise rmps support == rmp support")

# --- observability: which action moved the likelihood? --------------------
xs, tr = cstpu_torch.fsbl_traced(A, y, sigma)
acts = {0: "add", 1: "del", 2: "upd"}
done = int(torch.sum(tr.action >= 0))
for t in range(min(done, 6)):
    print(f"  step {t}: {acts[int(tr.action[t])]:3s} atom "
          f"{int(tr.selected[t]):3d}  dL={float(tr.likelihood_delta[t]):.3e}"
          f"  |active|={int(tr.n_active[t])}")

xs, rtr = cstpu_torch.rmps_traced(A, y, sigma)
it = int(torch.sum(rtr.n_active > 0))
print(f"rmps: {it} outer iterations, per-stage counts "
      f"added={rtr.n_added[:it].tolist()} "
      f"deleted={rtr.n_deleted[:it].tolist()}")

# --- batched: one dictionary, many noisy draws ----------------------------
Ys = cstpu_torch.perturb(gen, b.cpu().repeat(8, 1), sigma / 2).to(dev)
Xs = cstpu_torch.rmps_batch(A, Ys, sigma)          # (8, m) posterior means
rec = np.mean([
    np.array_equal(np.flatnonzero(np.abs(r) > sigma), true_support)
    for r in Xs.cpu().numpy()])
print(f"batched rmps support recovery {rec:.2f}")
assert rec == 1.0
print("OK")
