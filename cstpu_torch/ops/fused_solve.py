"""Batched OMP on two hand-written CUDA kernels (PyTorch counterpart of the
OMP part of cstpu.ops.fused_solve).

cstpu runs the whole k-step solve in one Pallas launch with the dictionary
pinned in TPU VMEM (`_solve_kernel`), or streamed tile by tile when it is
too large for VMEM (`_stream_kernel`). On Hopper a block has at most
227 KB of shared memory, while the bench dictionary (16 MB in bf16) fits
the 50 MB L2. So the port runs a Python loop over the k steps, and each
step launches two kernels from cstpu_torch/csrc:

  select_argmax  scores = |round_cdt(r) . A_cdt| per (row, 128-atom tile),
                 reduced to per-tile (max, lowest argmax) partials (B, T)
  omp_append     per row: reduce the partials, gather the cdt-rounded
                 column, dup/degeneracy gate, bordered Ginv update,
                 coefficient and residual update; at the last step the
                 rank sort by atom index

The select kernel streams the dictionary tile by tile at every m, which is
the design `_stream_kernel` exists for, so `omp_stream_solve` runs on the
same two kernels; `supported` and `supported_stream` differ only in
whether the cdt dictionary fits the L2 cache.

Precision is cstpu's: the dictionary and the residual enter the product
in `corr_dtype` (bf16 by default, f32 on request, never TF32); the
products and every sum, Ginv, the coefficients and the residual are f32.
The solve is exact for the cdt-rounded dictionary.

Every kernel has its plain PyTorch version beside it (`_select_ref`,
`_append_ref`); `omp_fused_solve_ref` is the whole solve on them. A wrapper
runs the plain version only for tensors on the CPU; on CUDA tensors it
launches its kernel or raises. Solver state is updated in place, one set
of buffers for all k steps.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch

from cstpu_torch.ops import _build
from cstpu_torch.utils.sparse import SparseSolution

INT_MAX = torch.iinfo(torch.int32).max
TILE = 128             # atoms per select block and per partial (kTile)
KMAX = 128             # most steps the append kernel's shared Ginv holds
SMEM_MAX = 232448      # bytes of shared memory one sm_90 block may use
L2_BYTES = 40 << 20    # cdt dictionary size kept resident in the 50 MB L2

# Kernel launches made by the wrappers below, by kernel.
LAUNCHES = {"select": 0, "append": 0}


def _degeneracy_rtol(n: int) -> float:
    """Relative threshold below which an atom's orthogonal component is
    numerical noise in f32-accumulated Gram arithmetic (~8n f32 ulps).
    Appends with d <= rtol * ||a||^2 are rejected. It uses f32's eps
    whatever the correlation dtype (the active-set engine's gated append
    uses the eps of its own dtype instead)."""
    return 8.0 * n * 1.1920929e-07


class _OmpState(NamedTuple):
    cols: torch.Tensor   # (B, k, n) f32, slot t = column appended at step t
    Ginv: torch.Tensor   # (B, k, k) f32, identity on unused slots
    coef: torch.Tensor   # (B, k) f32
    idx: torch.Tensor    # (B, k) i32, m on unused slots
    r: torch.Tensor      # (B, n) f32 residual


def _check_cdt(corr_dtype):
    if corr_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"corr_dtype must be torch.bfloat16 or "
                         f"torch.float32, got {corr_dtype}")
    return corr_dtype


def _append_smem(n: int, k: int) -> int:
    """Dynamic shared memory of the append kernel, bytes."""
    return (n + k * k + 3 * k) * 4 + k * 4


# --------------------------------------------------------------------------
# Stage 1: select
# --------------------------------------------------------------------------

def _select_ref(r, Ac, cdt):
    """Plain select: per-tile (max |score|, lowest argmax), (B, T) each.

    `Ac` holds cdt-rounded values in any float dtype. A NaN anywhere in a
    tile makes its partial (NaN, INT_MAX)."""
    B = r.shape[0]
    m = Ac.shape[1]
    T = -(-m // TILE)
    scores = torch.abs(torch.matmul(r.to(cdt).float(), Ac.float()))
    s = torch.nn.functional.pad(scores, (0, T * TILE - m),
                                value=-torch.inf).view(B, T, TILE)
    tmax = torch.amax(s, dim=2)
    col = torch.arange(T * TILE, device=r.device).view(1, T, TILE)
    tidx = torch.amin(torch.where(s == tmax[..., None], col, INT_MAX), dim=2)
    return tmax, tidx.to(torch.int32)


def select_argmax(r, Ac):
    """Per-tile select partials for residuals r (B, n) f32 against the
    dictionary Ac (n, m) in its correlation dtype: (pval (B, T) f32,
    pidx (B, T) i32), T = ceil(m / TILE). On CUDA tensors this launches
    csrc/select_argmax.cu."""
    if not (r.is_cuda or Ac.is_cuda):
        return _select_ref(r, Ac, Ac.dtype)
    B, n = r.shape
    if (r.dtype != torch.float32 or Ac.dtype not in (torch.bfloat16,
                                                     torch.float32)
            or Ac.ndim != 2 or Ac.shape[0] != n or Ac.device != r.device
            or not (r.is_contiguous() and Ac.is_contiguous())):
        raise ValueError(
            f"select_argmax: need contiguous r (B, n) f32 and Ac (n, m) "
            f"bf16/f32 on one device, got r {tuple(r.shape)} {r.dtype} "
            f"{r.device}, Ac {tuple(Ac.shape)} {Ac.dtype} {Ac.device}")
    m = Ac.shape[1]
    T = -(-m // TILE)
    pval = torch.empty((B, T), dtype=torch.float32, device=r.device)
    pidx = torch.empty((B, T), dtype=torch.int32, device=r.device)
    lib = _build.load()
    with torch.cuda.device(r.device):
        err = lib.cstpu_select_argmax(
            r.data_ptr(), Ac.data_ptr(), int(Ac.dtype == torch.bfloat16),
            pval.data_ptr(), pidx.data_ptr(), B, n, m,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "cstpu_select_argmax")
    LAUNCHES["select"] += 1
    return pval, pidx


# --------------------------------------------------------------------------
# Stages 2 and 3: append, refit, residual, and the sorted epilogue
# --------------------------------------------------------------------------

def _reduce_partials(pval, pidx):
    """Per-row (max, lowest argmax) over the select partials (B, T);
    (NaN, INT_MAX) for a row whose maximum is NaN."""
    vmax = torch.amax(pval, dim=1, keepdim=True)
    idx = torch.amin(torch.where(pval == vmax, pidx, INT_MAX), dim=1)
    return vmax[:, 0], idx


def _rank_sort(idx, coef):
    """(idx, coef) (B, k) sorted by idx; ties (pads) keep slot order."""
    k = idx.shape[1]
    ki, kj = idx[:, :, None], idx[:, None, :]
    pos = torch.arange(k, device=idx.device)
    less = (kj < ki) | ((kj == ki) & (pos[None, None, :] < pos[None, :, None]))
    rank = less.sum(dim=2)
    return (torch.empty_like(idx).scatter_(1, rank, idx),
            torch.empty_like(coef).scatter_(1, rank, coef))


def _append_ref(pval, pidx, Ac, Bs, st: _OmpState, t: int, out_idx,
                out_coef):
    """Plain append step t: the same math as csrc/omp_append.cu, batched
    over rows, updating `st` in place."""
    n, m = Ac.shape
    k = st.idx.shape[1]
    i = _reduce_partials(pval, pidx)[1][:, None]                   # (B, 1)
    acol = Ac[:, i[:, 0].clamp(max=m - 1).long()].T.float()       # (B, n)

    ata = torch.sum(acol * acol, dim=1, keepdim=True)
    beta = torch.sum(acol * Bs, dim=1, keepdim=True)
    g = torch.sum(st.cols * acol[:, None, :], dim=2)              # (B, k)
    et = (torch.arange(k, device=Bs.device) == t).float()[None, :]
    u = torch.sum(st.Ginv * g[:, None, :], dim=2)
    d = ata - torch.sum(g * u, dim=1, keepdim=True)
    dup = torch.any(st.idx == i, dim=1, keepdim=True)
    ok = ~dup & (d > _degeneracy_rtol(n) * ata)
    okf = ok.float()
    dinv = okf / torch.where(d > 0, d, 1.0)
    s = dinv * (beta - torch.sum(g * st.coef, dim=1, keepdim=True))

    w = u - et
    st.Ginv.copy_(st.Ginv + dinv[:, :, None] * w[:, :, None] * w[:, None, :]
                  - okf[:, :, None] * et[None, :, :] * et[:, :, None])
    st.coef.sub_(s * w)
    st.idx[:, t] = torch.where(ok[:, 0], i[:, 0], st.idx[:, t])
    st.cols[:, t, :] = acol * okf
    st.r.copy_(Bs - torch.sum(st.cols * st.coef[:, :, None], dim=1))
    if t == k - 1:
        sidx, scoef = _rank_sort(st.idx, st.coef)
        out_idx.copy_(sidx)
        out_coef.copy_(scoef)


def omp_append(pval, pidx, Ac, Bs, st: _OmpState, t: int, out_idx,
               out_coef):
    """OMP step t from the select partials: updates `st` in place and, at
    t = k-1, writes the index-sorted support into out_idx/out_coef. On
    CUDA tensors this launches csrc/omp_append.cu."""
    ts = (pval, pidx, Ac, Bs, *st, out_idx, out_coef)
    if not any(x.is_cuda for x in ts):
        return _append_ref(pval, pidx, Ac, Bs, st, t, out_idx, out_coef)
    B, k, n = st.cols.shape
    m = Ac.shape[1]
    if not 0 <= t < k <= KMAX or _append_smem(n, k) > SMEM_MAX:
        raise ValueError(f"omp_append: k={k}, t={t}, n={n} outside the "
                         f"kernel's limits (k <= {KMAX}, shared memory)")
    if (any(x.device != Bs.device or not x.is_contiguous() for x in ts)
            or Ac.dtype not in (torch.bfloat16, torch.float32)
            or pidx.dtype != torch.int32 or st.idx.dtype != torch.int32
            or out_idx.dtype != torch.int32
            or any(x.dtype != torch.float32
                   for x in (pval, Bs, st.cols, st.Ginv, st.coef, st.r,
                             out_coef))
            or Ac.shape[0] != n or pval.shape != (B, -(-m // TILE))
            or pidx.shape != pval.shape or Bs.shape != (B, n)
            or st.Ginv.shape != (B, k, k) or st.r.shape != (B, n)
            or st.coef.shape != (B, k) or st.idx.shape != (B, k)
            or out_idx.shape != (B, k) or out_coef.shape != (B, k)):
        raise ValueError("omp_append: tensors of the wrong device, dtype, "
                         "shape or layout")
    lib = _build.load()
    with torch.cuda.device(Bs.device):
        err = lib.cstpu_omp_append(
            pval.data_ptr(), pidx.data_ptr(), pval.shape[1], Ac.data_ptr(),
            int(Ac.dtype == torch.bfloat16), Bs.data_ptr(),
            st.cols.data_ptr(), st.Ginv.data_ptr(), st.coef.data_ptr(),
            st.idx.data_ptr(), st.r.data_ptr(), out_idx.data_ptr(),
            out_coef.data_ptr(), B, n, m, k, t, _degeneracy_rtol(n),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "cstpu_omp_append")
    LAUNCHES["append"] += 1


# --------------------------------------------------------------------------
# The solve
# --------------------------------------------------------------------------

def _init_state(Bs, k: int, m: int):
    """Empty solver state for measurements Bs (B, n) f32, and the (B, k)
    outputs the last append step writes."""
    B, n = Bs.shape
    dev = Bs.device
    f32 = torch.float32
    st = _OmpState(
        cols=torch.zeros((B, k, n), dtype=f32, device=dev),
        Ginv=torch.eye(k, dtype=f32, device=dev).repeat(B, 1, 1),
        coef=torch.zeros((B, k), dtype=f32, device=dev),
        idx=torch.full((B, k), m, dtype=torch.int32, device=dev),
        r=Bs.clone(),
    )
    return (st, torch.empty((B, k), dtype=torch.int32, device=dev),
            torch.empty((B, k), dtype=f32, device=dev))


def _omp_steps(Ac, Bs, k: int, select, append):
    """k OMP steps over the batch: one select and one append each."""
    st, out_idx, out_coef = _init_state(Bs, k, Ac.shape[1])
    for t in range(k):
        pval, pidx = select(st.r, Ac)
        append(pval, pidx, Ac, Bs, st, t, out_idx, out_coef)
    return out_idx, out_coef, st.r


def _to_solution(idx, coef, m: int) -> SparseSolution:
    """Batched (B, k) support and coefficients, already sorted by atom index
    (the append kernel sorts at the last step) -> SparseSolution. Slots
    holding no atom (index m, or INT_MAX from a NaN row) are masked."""
    mask = idx < m
    return SparseSolution(idx=torch.where(mask, idx, m),
                          val=torch.where(mask, coef, 0.0),
                          mask=mask, m=int(m))


def _solve(A, Bs, k: int, corr_dtype, select, append, upcast: bool):
    n, m = A.shape
    k = int(min(k, n, m))
    cdt = _check_cdt(corr_dtype)
    Ac = A.to(cdt)
    if upcast:  # the plain version multiplies in f32 on cdt-rounded values
        Ac = Ac.float()
    Bs = Bs.to(torch.float32).contiguous()
    idx, coef, r = _omp_steps(Ac.contiguous(), Bs, k, select, append)
    return _to_solution(idx, coef, m), r


def omp_fused_solve(A, Bs, k: int, corr_dtype=torch.bfloat16):
    """Batched OMP on the select and append kernels.

    A: (n, m) dictionary; Bs: (B, n) measurements; k fixed steps (a
    stalled instance's steps are no-ops). Returns a batched SparseSolution
    sorted by atom index, and the final residuals (B, n) f32.
    """
    return _solve(A, Bs, k, corr_dtype, select_argmax, omp_append, False)


def omp_fused_solve_ref(A, Bs, k: int, corr_dtype=torch.bfloat16):
    """omp_fused_solve on the plain versions of both kernels, on any
    device: the reference the kernels are held against."""
    cdt = _check_cdt(corr_dtype)
    return _solve(A, Bs, k, cdt, partial(_select_ref, cdt=cdt), _append_ref,
                  True)


def omp_stream_solve(A, Bs, k: int, corr_dtype=torch.bfloat16):
    """Batched OMP for dictionaries beyond the L2 cache. The select kernel
    streams the dictionary from device memory tile by tile every step,
    so this is the same solve as omp_fused_solve, with the same result."""
    return omp_fused_solve(A, Bs, k, corr_dtype)


def _kernel_ok(A, Bs, k: int) -> bool:
    n, m = A.shape
    k = int(min(k, n, m))
    return (Bs.ndim == 2 and Bs.shape[1] == n and Bs.shape[0] >= 1
            and 1 <= k <= KMAX and _append_smem(n, k) <= SMEM_MAX)


def supported(A, Bs, k: int, corr_dtype=torch.bfloat16) -> bool:
    """Shape gate of omp_fused_solve: k and n within the append kernel's
    shared memory, and the cdt dictionary small enough to stay in L2."""
    itemsize = torch.empty((), dtype=corr_dtype).element_size()
    return (_kernel_ok(A, Bs, k)
            and A.shape[0] * A.shape[1] * itemsize <= L2_BYTES)


def supported_stream(A, Bs, k: int, corr_dtype=torch.bfloat16) -> bool:
    """Shape gate of omp_stream_solve: the solver state must fit the append
    kernel; the dictionary need not fit L2."""
    return _kernel_ok(A, Bs, k)
