"""Sparse-solution container and support-set helpers (PyTorch).

Counterpart of cstpu.utils.sparse. Solvers carry fixed-size masked active
sets and return a `SparseSolution`: padded (idx, val, mask) tensors sorted
by atom index among active entries, pad index m. A batched solution is the
same class with a leading batch dimension on all three tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cstpu_torch.ops.util import as_inputs


@dataclass(frozen=True)
class SparseSolution:
    """Static-shape sparse vector: `val[..., i]` at position `idx[..., i]`
    where `mask[..., i]`; `m` is the ambient dimension."""
    idx: torch.Tensor   # int32[..., kmax], sorted among active, padded with m
    val: torch.Tensor   # float[..., kmax]
    mask: torch.Tensor  # bool[..., kmax]
    m: int

    @property
    def nzind(self) -> np.ndarray:
        """Active support indices, sorted ascending (host numpy)."""
        mask = self.mask.cpu().numpy()
        return np.sort(self.idx.cpu().numpy()[mask])

    @property
    def nzval(self) -> np.ndarray:
        """Values aligned with `nzind` (host numpy)."""
        mask = self.mask.cpu().numpy()
        idx = self.idx.cpu().numpy()[mask]
        val = self.val.cpu().numpy()[mask]
        return val[np.argsort(idx, kind="stable")]

    @property
    def nnz(self) -> int:
        return int(self.mask.sum())

    def todense(self) -> torch.Tensor:
        """Dense (..., m) tensor."""
        from cstpu_torch.ops.util import padded_to_dense

        return padded_to_dense(self.idx, self.val, self.mask, self.m)


def from_dense(x, kmax: int | None = None, tol: float = 0.0) -> SparseSolution:
    """Build a SparseSolution from a dense (m,) vector (a host-side helper,
    as cstpu's: a tensor keeps its device, anything else stays on the
    host)."""
    x = torch.as_tensor(x)
    m = x.shape[0]
    nz = torch.nonzero(x.abs() > tol).flatten()
    kmax = kmax or max(len(nz), 1)
    if len(nz) > kmax:
        raise ValueError(f"{len(nz)} nonzeros exceed kmax={kmax}")
    idx = torch.full((kmax,), m, dtype=torch.int32, device=x.device)
    val = torch.zeros((kmax,), dtype=x.dtype, device=x.device)
    mask = torch.zeros((kmax,), dtype=torch.bool, device=x.device)
    idx[: len(nz)] = nz.to(torch.int32)
    val[: len(nz)] = x[nz]
    mask[: len(nz)] = True
    return SparseSolution(idx, val, mask, m)


def droptol(x, tol: float):
    """Drop entries with |value| <= tol: masks a SparseSolution's entries,
    zeroes a dense tensor's (a non-tensor's on the host)."""
    if isinstance(x, SparseSolution):
        keep = x.mask & (x.val.abs() > tol)
        return SparseSolution(
            idx=torch.where(keep, x.idx, x.m),
            val=torch.where(keep, x.val, 0),
            mask=keep,
            m=x.m,
        )
    x = torch.as_tensor(x)
    return torch.where(x.abs() > tol, x, 0)


def polish(A, b, x, tol: float = 1e-3):
    """Least-squares refit of `x` on its |value| > tol support.

    Returns a dense vector for dense input, a SparseSolution for
    SparseSolution input (same slot width)."""
    sparse = isinstance(x, SparseSolution)
    A, b, dense = as_inputs(A, b, x.val if sparse else x)
    b = b.to(A.dtype)
    m = A.shape[1]
    if sparse:
        nz = torch.as_tensor(droptol(x, tol).nzind, dtype=torch.long)
    else:
        nz = torch.nonzero(dense.abs() > tol).flatten().cpu()
    if len(nz) == 0:
        return (x if isinstance(x, SparseSolution)
                else torch.zeros((m,), dtype=A.dtype, device=A.device))
    nz = nz.to(A.device)
    coef = torch.linalg.lstsq(A[:, nz], b[:, None]).solution[:, 0]
    if isinstance(x, SparseSolution):
        kmax = x.idx.shape[0]
        idx = torch.full((kmax,), m, dtype=torch.int32, device=A.device)
        val = torch.zeros((kmax,), dtype=coef.dtype, device=A.device)
        mask = torch.zeros((kmax,), dtype=torch.bool, device=A.device)
        idx[: len(nz)] = nz.to(torch.int32)
        val[: len(nz)] = coef
        mask[: len(nz)] = True
        return SparseSolution(idx, val, mask, int(m))
    out = torch.zeros((m,), dtype=A.dtype, device=A.device)
    out[nz] = coef
    return out


def support(x, tol: float = 0.0) -> np.ndarray:
    """Sorted support of a dense vector or SparseSolution (host numpy; a
    non-tensor is read on the host, as cstpu reads it)."""
    if isinstance(x, SparseSolution):
        return x.nzind
    x = torch.as_tensor(x)
    return np.flatnonzero(x.abs().cpu().numpy() > tol)


def samesupport(x, y, tol: float = 0.0) -> bool:
    """Support-set equality predicate."""
    return np.array_equal(support(x, tol), support(y, tol))
