"""Seeded synthetic problem generators (PyTorch counterpart of
cstpu.utils.data).

Every generator takes an explicit `torch.Generator` and builds its tensors
on that generator's device. The numbers are not cstpu's for the same
seed (another random stream), so parity tests never use these: they draw
their problems with numpy or cstpu and hand the same arrays to both
packages.
"""

from __future__ import annotations

import torch


def sparse_vector(gen: torch.Generator, m: int, k: int,
                  gaussian: bool = False, dtype=torch.float32):
    """Random k-sparse vector of length m with +-1 (default) or Gaussian
    nonzero entries on a uniformly random support. Returns a dense (m,)
    tensor on `gen.device`."""
    if m < k:
        raise ValueError(f"m = {m} < {k} = k")
    dev = gen.device
    ind = torch.randperm(m, generator=gen, device=dev)[:k]
    if gaussian:
        vals = torch.randn((k,), generator=gen, device=dev, dtype=dtype)
    else:
        vals = (torch.randint(0, 2, (k,), generator=gen, device=dev)
                .to(dtype) * 2 - 1)
    x = torch.zeros((m,), dtype=dtype, device=dev)
    x[ind] = vals
    return x


def sparse_data(gen: torch.Generator, n: int = 32, m: int = 64, k: int = 3,
                rescaled: bool = True, dtype=torch.float32):
    """Gaussian dictionary + k-sparse ground truth: returns (A, x, b = A x).

    If `rescaled`, columns are mean-nudged by 1e-6 and normalized to unit
    l2 norm. b sums the k active columns directly.
    """
    A = torch.randn((n, m), generator=gen, device=gen.device, dtype=dtype)
    if rescaled:
        A = A - 1e-6 * A.mean(dim=0, keepdim=True)
        A = A / torch.sqrt(torch.sum(A * A, dim=0, keepdim=True))
    x = sparse_vector(gen, m, k, dtype=dtype)
    nz = torch.nonzero(x).flatten()
    b = torch.sum(A[:, nz] * x[nz], dim=1)
    return A, x, b


gaussian_data = sparse_data


def correlated_data(gen: torch.Generator, n: int, m: int, k: int,
                    normalized: bool = True, dtype=torch.float32,
                    decay: float = 2.0):
    """Ill-conditioned dictionary A = (U diag(1/i^decay)) V with correlated
    columns, U (n, n) and V (n, m) standard normal; columns normalized to
    unit l2 norm if `normalized`. Returns (A, x, b = A x) with x k-sparse
    +-1. decay=2 is the reference's spectrum; at large n it collapses the
    numerical rank, so large problems take a gentler decay (0.25 in suite
    config 3a)."""
    dev = gen.device
    U = torch.randn((n, n), generator=gen, device=dev, dtype=dtype)
    V = torch.randn((n, m), generator=gen, device=dev, dtype=dtype)
    s = 1.0 / torch.arange(1, n + 1, device=dev, dtype=dtype) ** decay
    A = (U * s[None, :]) @ V
    if normalized:
        A = A / torch.sqrt(torch.sum(A * A, dim=0, keepdim=True))
    x = sparse_vector(gen, m, k, dtype=dtype)
    nz = torch.nonzero(x).flatten()
    b = torch.sum(A[:, nz] * x[nz], dim=1)
    return A, x, b


coherent_data = correlated_data


def perturb(gen: torch.Generator, b, delta: float):
    """Add Gaussian noise rescaled to exact l2 norm `delta` (per row for a
    batched (B, n) measurement matrix). A b that is not a tensor goes
    where the generator lies."""
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(b, device=gen.device)
    e = torch.randn(b.shape, generator=gen, device=b.device, dtype=b.dtype)
    if b.ndim == 2:
        e = e * (delta / torch.linalg.norm(e, dim=1, keepdim=True))
    else:
        e = e * (delta / torch.linalg.norm(e))
    return b + e
